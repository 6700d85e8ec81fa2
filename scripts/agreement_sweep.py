#!/usr/bin/env python3
"""Sweep of the launch routes of the precluster agreement kernel.

Run from the root of a checkout on a machine with one CUDA card:

    python3 scripts/agreement_sweep.py [--out sweep.json] [--seed 0]
                                       [--quick]

For each (R, W, λ) below it makes four random λ-arboric graphs of n in
(R/2, R] vertices (numpy, ``--seed``) under the precluster path's degree cap
(a vertex above 12·λ keeps no edge), their ELL rows cut to W slots, and
relabels them on the card with a random permutation per graph, so that a
launch holds G distinct graphs of 2^20 rows in all (at least 8), as the
smoke's largest bucket does; each row is then laid out as ``pack_bucket``
writes it (the neighbours above u ascending, then those below, then pads),
the layout the smem route stages. At ``replicas`` 1 (G entries) and 3 (each
graph three times, as a bucket packs best-of-k samples) it times on the
same inputs the warp route (``agreement.warp_plan``) and, where it can run,
the smem route (``agreement.smem_plan``). Every route is first held to the
plain version with ``torch.equal`` (to the first route where the plain
version's candidate lists would pass 2^28 entries). Times are device ms per
call between CUDA events, each route timed in the order A, B, B, A and
averaged over its two passes, beside the bound from the bytes the function
must move (``measure.agreement_bytes_and_ops``). A second table varies the
number of graphs at R = 4096, W = 32. It prints the thresholds that
``agreement.agreement_launch_plan`` takes from these tables, and the plan's
pick beside each row. ``--quick`` runs R = 4096 and 32768 only.
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

RS = (256, 1024, 4096, 8192, 32768)
WS = (4, 8, 16, 32, 64)
LAMS = (1, 2, 3)
REPLICAS = (1, 3)
ROWS = 1 << 20            # rows of a launch's distinct graphs
GROUPS = (8, 32, 64, 96, 128, 256)
PLAIN_MAX = 1 << 28       # candidate entries the plain check may build


def base_ells(R: int, W: int, lam: int, rng, count: int = 4) -> np.ndarray:
    """``count`` (R, W) ELLs of random λ-arboric graphs, n in (R/2, R],
    capped as the precluster plan caps them, rows cut to W slots."""
    from repro_torch.core.graph import random_arboric

    out = np.full((count, R, W), R, dtype=np.int32)
    for i in range(count):
        n = int(rng.integers(R // 2 + 1, R + 1))
        edges = random_arboric(n, lam, rng)[0]
        if not len(edges):
            continue
        deg = np.bincount(edges.ravel(), minlength=n)
        keep = (deg[edges[:, 0]] <= 12 * lam) & (deg[edges[:, 1]] <= 12 * lam)
        e = edges[keep]
        src = np.concatenate([e[:, 0], e[:, 1]])
        dst = np.concatenate([e[:, 1], e[:, 0]])
        order = np.lexsort((dst, src))
        src, dst = src[order], dst[order]
        first = np.searchsorted(src, np.arange(n))
        slot = np.arange(len(src)) - first[src]
        ok = slot < W
        out[i, src[ok], slot[ok]] = dst[ok]
    return out


def packed_layout(ell: torch.Tensor) -> torch.Tensor:
    """Each row as ``pack_bucket`` writes it: the ids above u ascending,
    then those below ascending, then the pads."""
    R = ell.shape[1]
    u = torch.arange(R, device=ell.device).view(1, R, 1)
    key = torch.where(ell == R, 3 * R, torch.where(ell < u, ell + R + 1, ell))
    return torch.gather(ell, 2, key.argsort(dim=2))


def bucket(base: np.ndarray, groups: int, replicas: int, gen, dev):
    """``groups`` graphs on the card, graph g the base graph g % count
    relabelled by a random permutation of [0, R) and laid out as
    ``pack_bucket`` lays rows out, each ``replicas`` times."""
    count, R, W = base.shape
    b = torch.from_numpy(base).to(dev)
    idx = torch.arange(groups, device=dev) % count
    perm = torch.argsort(torch.rand((groups, R), generator=gen, device=dev),
                         dim=1).to(torch.int32)
    ext = torch.cat([perm, perm.new_full((groups, 1), R)], dim=1)
    mapped = torch.gather(ext, 1, b[idx].reshape(groups, R * W).long())
    ell = torch.empty((groups, R, W), dtype=torch.int32, device=dev)
    ell.scatter_(1, perm.long().unsqueeze(2).expand(groups, R, W),
                 mapped.view(groups, R, W))
    return packed_layout(ell).repeat_interleave(replicas, dim=0)


def events_ms(fn, calls: int = 10, samples: int = 3) -> float:
    """Device ms per call of ``calls`` back-to-back calls between two CUDA
    events, median over ``samples`` (each launch takes far longer than its
    issue here)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def time_routes(ag, ref, ell, replicas):
    """{route: ms}, every route checked first; A B B A."""
    B, R, W = ell.shape
    plans = {"warp": ag.warp_plan(B, R, W, replicas)}
    smem = ag.smem_plan(B, R, W, replicas)
    if smem is not None:
        plans["smem"] = smem
    first = None
    if B // replicas * R * W * W <= PLAIN_MAX:
        first = ref.agreement_ell_ref(ell, replicas=replicas)
    fns = {}
    for name, plan in plans.items():
        def fn(plan=plan):
            return ag.agreement_ell_batch(ell, replicas=replicas, plan=plan)
        got = fn()
        if first is None:
            first = got
        elif not torch.equal(got, first):
            raise AssertionError(f"{name} route differs at {B, R, W}, "
                                 f"replicas {replicas}")
        fns[name] = fn
    order = list(fns) + list(fns)[::-1]
    passes: dict = {}
    for name in order:
        passes.setdefault(name, []).append(events_ms(fns[name]))
    return {name: sum(t) / 2 for name, t in passes.items()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", type=Path, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--quick", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("agreement_sweep: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, agreement as ag, ref

    card = ms.card_line()
    print(f"card: {card}")
    for r in _build.ptxas_report(_build.build(["agreement"]).get(
            "agreement", "")):
        print(f"  ptxas {r['function']}: {r['registers']} registers, "
              f"spill {r['spill_stores']} / {r['spill_loads']} B")
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rows, group_rows = [], []

    def run(R, W, lam, base, groups, rep, out):
        ell = bucket(base, groups, rep, gen, dev)
        times = time_routes(ag, ref, ell, rep)
        bound, by = ms.bound_ms(*ms.agreement_bytes_and_ops(ell, rep))
        pick = ag.agreement_launch_plan(*ell.shape, rep).route
        best = min(times, key=times.get)
        nonpad = float((ell[::rep] != R).float().mean())
        row = {"R": R, "W": W, "lam": lam, "groups": groups,
               "replicas": rep, "ms": times, "bound_ms": bound,
               "bound_by": by, "best": best, "pick": pick,
               "nonpad_share": nonpad}
        out.append(row)
        print(f"(R, W, λ) = ({R}, {W}, {lam}), {groups} graphs × {rep}, "
              f"non-pad {100 * nonpad:.1f} %: " + ", ".join(
                  f"{name} {t:.4f} ({100 * bound / t:.1f} % of bound)"
                  for name, t in times.items())
              + f"; bound {bound:.4f} ({by}); best {best}, plan {pick}  "
              f"[{card}]")
        del ell
        torch.cuda.empty_cache()

    for R in ((4096, 32768) if args.quick else RS):
        groups = max(8, ROWS // R)
        for lam in LAMS:
            for W in WS:
                base = base_ells(R, W, lam, rng)
                for rep in REPLICAS:
                    run(R, W, lam, base, groups, rep, rows)
    base = base_ells(4096, 32, 2, rng)
    for groups in GROUPS:
        run(4096, 32, 2, base, groups, 3, group_rows)

    # Thresholds: the largest R up to which the smem route wins in most
    # rows where it runs, and the fewest graphs from which it wins at
    # R = 4096.
    max_r = 0
    for R in sorted({r["R"] for r in rows}):
        both = [r for r in rows if r["R"] == R and "smem" in r["ms"]]
        if both and 2 * sum(r["best"] == "smem" for r in both) > len(both):
            max_r = R
        else:
            break
    wins = [r["groups"] for r in group_rows if r["best"] == "smem"]
    min_groups = min(wins) if wins else None
    print(f"thresholds: SMEM_MAX_R = {max_r} (smem wins in most rows up "
          f"to here), SMEM_MIN_GROUPS = {min_groups} (fewest graphs at "
          f"R = 4096 where smem wins); the plan takes SMEM_MAX_R = "
          f"{ag.SMEM_MAX_R}, SMEM_MIN_GROUPS = {ag.SMEM_MIN_GROUPS}  "
          f"[{card}]")
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {"card": card, "rows": rows, "group_rows": group_rows,
             "smem_max_r": max_r, "smem_min_groups": min_groups}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
