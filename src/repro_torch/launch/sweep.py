"""Dry-run sweep: every (arch × shape × mesh) cell in a subprocess.

    PYTHONPATH=src python -m repro_torch.launch.sweep --run [--multi-pod-only]
    PYTHONPATH=src python -m repro_torch.launch.sweep --summarize

The port of ``repro/launch/sweep.py``. Results land in
``artifacts/dryrun_torch/<arch>__<shape>__<pods>.json`` (under the
working directory); ``--summarize`` renders their table (GiB a rank,
bottleneck, the three roofline times, useful share, roofline fraction).

Each cell still runs in a fresh process (``python -m
repro_torch.launch.dryrun``), though not for the reference's reason: the
reference needs one because jax locks its device count at first
initialisation, and the port's stand-in mesh needs no devices at all. The
port keeps it because a cell that dies (a crash, a process killed for its
memory) or hangs must not take the sweep with it, each cell gets its own
time limit, and the counters a cell reads (``parallel.counts``, B4's meta
launches, the matmul reduce dtype) are process-wide.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ART = Path("artifacts/dryrun_torch")


def _arch_shapes():
    from repro_torch.configs import ARCH_NAMES, SHAPES
    return [(a, s) for a in ARCH_NAMES for s in SHAPES]


def cell_path(arch: str, shape: str, multi_pod: bool) -> Path:
    pods = "pod2" if multi_pod else "pod1"
    return ART / f"{arch}__{shape}__{pods}.json"


def run_cell_subprocess(arch: str, shape: str, multi_pod: bool,
                        timeout: int = 1800, extra=()) -> dict:
    out = cell_path(arch, shape, multi_pod)
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--out", str(out)]
    if multi_pod:
        cmd.append("--multi-pod")
    cmd.extend(extra)
    # The child imports this checkout's package from any directory.
    src = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p)
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout, env=env)
        if out.exists():
            res = json.loads(out.read_text())
        else:
            res = {"arch": arch, "shape": shape, "multi_pod": multi_pod,
                   "status": "error",
                   "error": (proc.stderr or proc.stdout)[-2000:]}
    except subprocess.TimeoutExpired:
        res = {"arch": arch, "shape": shape, "multi_pod": multi_pod,
               "status": "timeout", "timeout_s": timeout}
    res["wall_s"] = round(time.time() - t0, 1)
    out.write_text(json.dumps(res, indent=2))
    return res


def run_sweep(multi_pod_values=(False, True), skip_done=True,
              only_arch=None, only_shape=None):
    results = []
    for multi_pod in multi_pod_values:
        for arch, shape in _arch_shapes():
            if only_arch and arch != only_arch:
                continue
            if only_shape and shape != only_shape:
                continue
            p = cell_path(arch, shape, multi_pod)
            if skip_done and p.exists():
                prev = json.loads(p.read_text())
                if prev.get("status") in ("ok", "skipped"):
                    results.append(prev)
                    continue
            res = run_cell_subprocess(arch, shape, multi_pod)
            tag = "pod2" if multi_pod else "pod1"
            print(f"[{tag}] {arch:22s} {shape:12s} -> {res['status']:8s} "
                  f"({res.get('wall_s', 0)}s)", flush=True)
            results.append(res)
    return results


def load_all():
    out = []
    for p in sorted(ART.glob("*.json")):
        try:
            out.append(json.loads(p.read_text()))
        except json.JSONDecodeError:
            pass
    return out


def summarize(results=None) -> str:
    results = results or load_all()
    lines = []
    lines.append("| arch | shape | mesh | status | GiB/dev | bottleneck | "
                 "t_comp | t_mem | t_coll | useful | frac |")
    lines.append("|---|---|---|---|---|---|---|---|---|---|---|")
    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}
    for r in sorted(results, key=lambda r: (r.get("arch", ""),
                                            order.get(r.get("shape"), 9),
                                            r.get("multi_pod", False))):
        mesh = "2x16x16" if r.get("multi_pod") else "16x16"
        if r.get("status") == "ok":
            m = r["memory"]["per_device_total"] / 2**30
            rf = r["roofline"]
            lines.append(
                f"| {r['arch']} | {r['shape']} | {mesh} | ok | {m:.2f} | "
                f"{rf['bottleneck']} | {rf['t_compute_s']:.4g} | "
                f"{rf['t_memory_s']:.4g} | {rf['t_collective_s']:.4g} | "
                f"{rf['useful_ratio']:.2f} | {rf['roofline_fraction']:.2f} |")
        else:
            why = r.get("reason", r.get("error", ""))[:60]
            lines.append(f"| {r.get('arch')} | {r.get('shape')} | {mesh} | "
                         f"{r.get('status')} | | {why} | | | | | |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--run", action="store_true")
    ap.add_argument("--summarize", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--no-skip", action="store_true")
    args = ap.parse_args(argv)
    if args.run:
        pods = (False, True)
        if args.single_pod_only:
            pods = (False,)
        if args.multi_pod_only:
            pods = (True,)
        run_sweep(multi_pod_values=pods, skip_done=not args.no_skip,
                  only_arch=args.arch, only_shape=args.shape)
    if args.summarize or not args.run:
        print(summarize())


if __name__ == "__main__":
    main()
