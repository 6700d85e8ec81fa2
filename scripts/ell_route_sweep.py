#!/usr/bin/env python3
"""Sweep of the launch routes of kernels B1/B2 on the card.

Run from the root of a checkout on a machine with one CUDA card:

    python3 scripts/ell_route_sweep.py [--baseline OLD.cu] [--out sweep.json]

For each (B, R, W) below it times, on the same random inputs (numpy, seed
0), the l2 route (``neighbor_min.l2_plan``) and the staged route
(``neighbor_min.staged_plan``) with one wave of blocks or at most
``block_rows`` rows a block, by calling the C entries of
``csrc/neighbor_min.cu`` with each plan; with ``--baseline``, also an
earlier ``neighbor_min.cu`` (see ``measure.Baseline``). Every variant is
first held to the plain version with ``torch.equal``. Times are device ms
per call from the profiler, each variant timed in the order A, B, …, …,
B, A and averaged over its two passes. The gates of
``neighbor_min.launch_plan`` (MIN_STAGED_BYTES, STAGE_RATIO) were chosen
from this table; it prints ``launch_plan``'s pick beside it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import measure as ms  # noqa: E402

SHAPES = [(768, 4096, 32), (768, 4096, 16), (768, 4096, 8), (768, 4096, 4),
          (96, 8192, 16), (48, 16384, 16), (24, 32768, 16), (8, 32768, 16),
          (16, 4096, 4096), (1536, 256, 16), (48, 1024, 64), (2048, 64, 8),
          (512, 64, 8), (192, 8, 4), (1, 4096, 16), (1, 32312, 20),
          (1, 32312, 18)]
BLOCK_ROWS = (None, 4096, 1024, 256)


def plan_name(plan) -> str:
    return plan.route if plan.route == "l2" else \
        f"staged/{plan.rows_per_block}"


def plans(nm, B, R, W):
    """The l2 plan and every distinct staged plan of BLOCK_ROWS, by name."""
    out = {"l2": nm.l2_plan(B, R, W)}
    for cap in BLOCK_ROWS:
        plan = nm.staged_plan(B, R, W, R + 1, block_rows=cap)
        if plan is not None:
            out.setdefault(plan_name(plan), plan)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--baseline", type=Path, default=None)
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("ell_route_sweep: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import neighbor_min as nm, ref
    from repro_torch.kernels._build import device_and_stream

    baseline = ms.Baseline(args.baseline) if args.baseline else None
    lib = nm._lib()
    if baseline is not None:
        baseline.load()
    card = ms.card_line()
    print(f"card: {card}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def launcher(kind, inputs, plan):
        ell, ranks, active, labels = inputs
        B, R, W = ell.shape

        def run():
            out = torch.empty((B, R), dtype=torch.int32, device=dev)
            state = (ranks.data_ptr(), active.data_ptr()) if kind == "nm" \
                else (labels.data_ptr(),)
            entry = lib.nm_neighbor_min if kind == "nm" else lib.nm_label_agree
            code = entry(ell.data_ptr(), *state, out.data_ptr(), B, R, W,
                         R + 1, *plan.args(), *device_and_stream(ell))
            if code != 0:
                raise RuntimeError(f"{kind} {plan}: launch failed ({code})")
            return out
        return run

    record = {"card": card, "rows": []}
    for B, R, W in SHAPES:
        inputs = ms.kernel_inputs(B, R, W, rng, dev)
        ell, ranks, active, labels = inputs
        variants = plans(nm, B, R, W)
        pick = plan_name(nm.launch_plan(B, R, W, R + 1))
        for kind, plain, old in (
                ("nm", lambda: ref.neighbor_min_ref(ell, ranks, active),
                 baseline and (lambda: baseline.neighbor_min(ell, ranks,
                                                             active))),
                ("la", lambda: ref.label_agree_ref(ell, labels),
                 baseline and (lambda: baseline.label_agree(ell, labels)))):
            want = plain()
            fns = {name: launcher(kind, inputs, plan)
                   for name, plan in variants.items()}
            if old is not None:
                fns["baseline"] = old
            for name, fn in fns.items():
                if not torch.equal(fn(), want):
                    raise AssertionError(f"{kind} {name} differs from the "
                                         f"plain version at {(B, R, W)}")
            names = list(fns)
            passes = {name: [] for name in names}
            for name in names + names[::-1]:
                passes[name].append(ms.device_ms(fns[name]))
            times = {name: (None if None in v else float(np.mean(v)))
                     for name, v in passes.items()}
            nbytes, ops = ms.bytes_and_ops(
                "label_agree_ell_batch" if kind == "la"
                else "neighbor_min_ell_batch", B, R, W)
            bound, _ = ms.bound_ms(nbytes, ops)
            print(f"{(B, R, W)} {kind} bound {bound:.4f} plan {pick}: "
                  + ", ".join(f"{k} {ms.fmt_ms(v)}"
                              for k, v in times.items()), flush=True)
            record["rows"].append({"shape": [B, R, W], "kernel": kind,
                                   "bound_ms": bound, "plan": pick,
                                   "ms": times})
        del inputs, ell, ranks, active, labels
        torch.cuda.empty_cache()
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
