"""The benchmark's one command, driven by ``BENCHMARK.json``.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell on the card it is started on. Everything a
cell is made of is found by name:

* the cell, in ``BENCHMARK.json``'s ``workloads``: its ``config``,
  ``traffic`` and ``chips``;
* the configuration, ``portbench/configs/<config>.json``;
* the traffic mix, ``portbench/traffic/<traffic>.json``, whose ``kind``
  names its driver, ``harness/<kind>.py``;
* each metric the cell reports: end to end from its driver by name, and
  per layer (``--trace 1``) from ``portbench/metrics/<name>.py``'s
  ``read``, which returns None where it finds nothing to read;
* the limits of the numbers its check compares,
  ``portbench/limits/<cell>.json``.

The run exits without a result where no card is found or fewer than the
cell asks for, and where the process holds JAX, Flax or the JAX package
once the window has closed. Otherwise its last lines on standard error
are each number compared beside its limit, and its last line on standard
output is the result, one JSON object.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parent.parent          # portbench/
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def process_start() -> float:
    """When this process started, on ``time.perf_counter``'s clock: its
    age from ``/proc`` (ticks of 10 ms), else now."""
    now = time.perf_counter()
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
    except (OSError, ValueError, IndexError):
        return now
    return now - max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def parts(bench: dict, workload: str) -> SimpleNamespace:
    """The files of a cell, found by name, loaded."""
    w = cell(bench, workload)
    mix = load_json(BENCH / "traffic" / f"{w['traffic']}.json")
    return SimpleNamespace(
        cell=w, conf=load_json(BENCH / "configs" / f"{w['config']}.json"),
        mix=mix, limits=load_json(BENCH / "limits" / f"{workload}.json"),
        driver=f"harness.{mix['kind']}")


def reader(name: str):
    """The per-layer metric ``name``'s ``read``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "pb_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def set_environment(kind: str) -> None:
    """Caches at fixed paths in the checkout; cuBLAS's workspace before
    CUDA starts, where the training launcher's deterministic mode needs
    it. The program's CUDA kernels build into its own fixed directory
    in the checkout (``src/repro_torch/kernels/build``)."""
    cache = BENCH / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    if kind == "train":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit():
    """The card's power limit in W as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def judge(outcome, limits: dict) -> bool:
    return outcome.failed == 0 and all(
        outcome.checks[n] <= lim for n, lim in limits.items())


def result(bench, p, outcome, trace: bool, workload: str, device) -> dict:
    """The result line's object."""
    metrics = {}
    if trace:
        ctx = SimpleNamespace(**outcome.layer)
        for m in bench["per_layer"]:
            if applies(m, workload):
                v = reader(m["name"])(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if applies(m, workload):
                metrics[m["name"]] = {"value": outcome.e2e[m["name"]],
                                      "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": device["kind"], "count": device["count"],
           "memory_peak_bytes": outcome.memory_peak,
           "power_limit_w": device["power"]}
    out = {"correct": judge(outcome, p.limits), "attempted": outcome.attempted,
           "failed": outcome.failed, "metrics": metrics, "device": dev}
    if trace and outcome.reading is not None:
        dev["busy_s"] = outcome.reading.busy_s
        dev["window_s"] = outcome.reading.window_s
        out["breakdown"] = outcome.reading.breakdown()
    out["checks"] = {n: {"value": outcome.checks[n], "limit": lim}
                     for n, lim in p.limits.items()}
    return out


def main(argv) -> int:
    t_process = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = manifest()
    p = parts(bench, args.workload)
    set_environment(p.mix["kind"])

    import torch

    chips = p.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from harness.trace import Tracer

    driver = importlib.import_module(p.driver)
    tracer = Tracer(bool(args.trace))
    outcome = driver.run(p.conf, p.mix, args.seed, args.seconds, tracer,
                         "cuda", t_process)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process holds {bad} after the window; no "
              "result", file=sys.stderr)
        return 3
    device = {"kind": torch.cuda.get_device_name(0), "count": chips,
              "power": power_limit()}
    out = result(bench, p, outcome, bool(args.trace), args.workload, device)
    for e in outcome.failures:
        print(f"failure: {e}", file=sys.stderr)
    for k, v in outcome.notes.items():
        print(f"note {k}: {v}", file=sys.stderr)
    for n, c in out["checks"].items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


__all__ = ["main", "manifest", "parts", "reader", "applies", "judge",
           "result", "forbidden_modules", "process_start"]
