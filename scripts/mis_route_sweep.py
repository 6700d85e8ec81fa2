#!/usr/bin/env python3
"""Sweep of the launch routes of kernel B3, the fused per-graph PIVOT.

Run from the root of a checkout on a machine with one CUDA card:

    python3 scripts/mis_route_sweep.py [--out sweep.json] [--seed 0]

For each (n, λ, k) below it makes a random λ-arboric graph of n vertices
with the degree cap of the per-graph path (eligible where deg <= 12·λ) and
k random rank permutations (numpy, ``--seed``), and times on the same
inputs the block route (``mis_pivot.block_plan``, a block per sample)
and the grid route (``mis_pivot.grid_plan``, one cooperative launch).
Every variant is first
held to the first one with ``torch.equal`` on status, labels and rounds
(and, up to n = 4,096, all to the plain version). Times are device ms per
call from the profiler, each variant timed in the order A, B, …, …, B, A
and averaged over its two passes (``measure.abba_ms``), beside the bound
from the bytes the function must move (``measure.mis_pivot_bytes_and_ops``)
and the rounds the run made. The
crossover of ``mis_pivot.mis_launch_plan`` was chosen from this table; it
prints the plan's pick beside it.
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

# (n, λ): 2-arboric graphs across the per-graph sizes, and around the
# crossover also 1- and 3-arboric ones, whose rows are shorter and longer.
SHAPES = [(n, 2) for n in (64, 256, 1024, 4096, 5120, 6144, 7168, 8192,
                           16384, 32768, 46000, 60000)] + [
    (n, 1) for n in (6144, 8192, 10240, 12288)] + [
    (n, 3) for n in (3072, 4096, 5120)]
KS = (1, 3, 8)
PLAIN_MAX_N = 4096


def plans(mp, k, n):
    """The plan of each route that takes (k, n), by name."""
    out = {}
    plan = mp.block_plan(k, n)
    if plan is not None:
        out[f"block/{plan.threads}"] = plan
    plan = mp.grid_plan(k, n)
    out[f"grid/{plan.blocks}"] = plan
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", type=Path, default=None)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("mis_route_sweep: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, mis_pivot as mp, ref

    card = ms.card_line()
    print(f"card: {card}")
    for r in _build.ptxas_report(_build.build(["mis_pivot"]).get(
            "mis_pivot", "")):
        print(f"  ptxas {r['function']}: {r['registers']} registers, "
              f"spill {r['spill_stores']} / {r['spill_loads']} B")
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    rows = []
    for n, lam in SHAPES:
        for k in KS:
            g, ranks, elig = ms.mis_pivot_inputs(n, k, lam, rng, dev,
                                                 capped=True)
            variants = plans(mp, k, n)
            fns, first = {}, None
            for name, plan in variants.items():
                def fn(plan=plan):
                    return mp.mis_pivot_csr(g.row_offsets, g.dst, ranks, elig,
                                            plan=plan)
                got = fn()
                if first is None:
                    first = got
                    if n <= PLAIN_MAX_N and not all(
                            torch.equal(a, b) for a, b in zip(got, ref.
                            mis_pivot_ref(g.row_offsets, g.dst, ranks,
                                          elig))):
                        raise AssertionError(f"{name} differs from the plain "
                                             f"version at (n, k) = {(n, k)}")
                elif not all(torch.equal(a, b) for a, b in zip(got, first)):
                    raise AssertionError(f"{name} differs from "
                                         f"{next(iter(variants))} at "
                                         f"(n, k) = {(n, k)}")
                fns[name] = fn
            times = dict(zip(fns, ms.abba_ms(list(fns.values()))))
            rounds = first[2].tolist()
            nbytes, ops = ms.mis_pivot_bytes_and_ops(n, g.dst.numel(), k)
            bound, by = ms.bound_ms(nbytes, ops)
            pick = mp.mis_launch_plan(k, n)
            pick = f"{pick.route}/" + str(pick.threads if pick.route ==
                                          "block" else pick.blocks)
            row = {"n": n, "lam": lam, "k": k, "m": g.m, "rounds": rounds,
                   "bound_ms": bound, "bound_by": by, "ms": times,
                   "pick": pick}
            rows.append(row)
            best = min((t, name) for name, t in times.items()
                       if t is not None)
            print(f"(n, λ, k) = ({n}, {lam}, {k}), m {g.m}, n + 2m "
                  f"{n + 2 * g.m}, rounds {rounds}: "
                  + ", ".join(f"{name} {ms.fmt_ms(t)}"
                              for name, t in times.items())
                  + f"; bound {bound:.4f} ({by}); best {best[1]}, plan "
                  f"{row['pick']}  [{card}]")
            del g, ranks, elig, fns, first
            torch.cuda.empty_cache()
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "rows": rows},
                                       indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
