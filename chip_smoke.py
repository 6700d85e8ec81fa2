#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py [--seed 0] [--out smoke.json]

Phases, in order; any failure raises and exits non-zero:

1. provenance: card name and power limit, torch / CUDA / nvcc versions;
2. build: every kernel source under ``src/repro_torch/kernels/csrc``, one
   ``nvcc`` each, started together;
3. kernel vs plain: B1 ``neighbor_min_ell_batch``, B2
   ``label_agree_ell_batch`` and B3 ``neighbor_min_ell`` on random inputs
   made with numpy from ``--seed``, held against their plain PyTorch
   versions with ``torch.equal`` (integer outputs: tolerance 0), with
   kernel and plain device times (profiler) and per-call times of
   back-to-back runs (CUDA events) beside the DRAM-byte bound;
4. main path: ``correlation_cluster_batch(method='pivot', num_samples=3)``
   on 2,048 random λ-arboric graphs (n log-uniform in [64, 4096]) plus 8
   graphs in the R = 2¹⁵ bucket, a cold pass and a warm pass. The launch
   counts are zeroed just before the warm pass and read just after; B1 and
   B2 must have launched. Labels are checked against sequential PIVOT on
   the eligible-induced subgraph, every cost against the host count, and
   32 graphs against per-graph ``correlation_cluster`` on the card, which
   must launch B3;
5. summary: the card line, a ``kernels`` JSON line, and last
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package, and exits non-zero with no
result when no CUDA device is available.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
NON_TENSOR_OPS_PER_S = 67e12   # H100 SXM peak outside the tensor cores
INF = 2**31 - 1
SOURCE = "src/repro_torch/kernels/csrc/neighbor_min.cu"
REPLACES = {
    "neighbor_min_ell_batch": "src/repro/kernels/neighbor_min.py:97",
    "label_agree_ell_batch": "src/repro/kernels/neighbor_min.py:156",
    "neighbor_min_ell": "src/repro/kernels/neighbor_min.py:49",
}
KERNEL_SHAPES = [(64, 8, 4), (48, 1024, 64), (16, 4096, 4096), (8, 32768, 16)]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, calls: int = 20, samples: int = 5) -> float:
    """Time per call of ``calls`` back-to-back calls between two CUDA
    events, median over ``samples``. Where the card finishes a call before
    the host has issued the next, this is the host's issue time."""
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


def device_events(fn):
    """Run ``fn`` under the profiler; returns (name, device µs) per kernel
    the card ran, or None when the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    out = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return out or None


def device_ms(fn, calls: int = 20):
    """Mean device time of one call from the profiler (None if unseen)."""
    def many():
        for _ in range(calls):
            fn()
    events = device_events(many)
    if events is None:
        return None
    return sum(us for _, us in events) / calls / 1e3


def bound_ms(nbytes: int, ops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / NON_TENSOR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_inputs(B, R, W, rng, dev):
    """Bucket state with the pad contract; a quarter of the rows hold only
    pads and, when B > 1, the last graph has no active vertex at all."""
    ell = rng.integers(0, R + 1, (B, R, W), dtype=np.int32)
    ell[:, ::4, :] = R
    ranks = rng.integers(0, INF, (B, R + 1), dtype=np.int32)
    ranks[:, R] = INF
    active = rng.random((B, R + 1)) < 0.3
    active[:, R] = False
    if B > 1:
        active[-1] = False
    labels = rng.integers(0, 8, (B, R + 1), dtype=np.int32)
    labels[:, R] = -1
    return [torch.from_numpy(a).to(dev) for a in (ell, ranks, active, labels)]


def bytes_and_ops(name, B, R, W):
    """DRAM bytes (each input read once, output written once) and ops."""
    slots, state = B * R * W, B * (R + 1)
    if name == "label_agree_ell_batch":
        return 4 * slots + 4 * state + 4 * B * R, 3 * slots
    return 4 * slots + 5 * state + 4 * B * R, 3 * slots


class KernelBench:
    """Calls each wrapper against its plain version and times both."""

    def __init__(self, nm, ref, dev):
        self.nm, self.ref, self.dev = nm, ref, dev
        self.max_err = {name: 0 for name in REPLACES}

    def pairs(self, ell, ranks, active, labels):
        nm, ref = self.nm, self.ref
        e0, r0, a0 = ell[0], ranks[0], active[0]
        return {
            "neighbor_min_ell_batch": (
                lambda: nm.neighbor_min_ell_batch(ell, ranks, active),
                lambda: ref.neighbor_min_ref(ell, ranks, active)),
            "label_agree_ell_batch": (
                lambda: nm.label_agree_ell_batch(ell, labels),
                lambda: ref.label_agree_ref(ell, labels)),
            "neighbor_min_ell": (
                lambda: nm.neighbor_min_ell(e0, r0, a0),
                lambda: ref.neighbor_min_ref(e0, r0, a0)),
        }

    def run(self, B, R, W, rng, timed=True):
        """Check (and time) every kernel at one (B, R, W); B3 gets graph 0."""
        inputs = kernel_inputs(B, R, W, rng, self.dev)
        rows = {}
        for name, (kernel, plain) in self.pairs(*inputs).items():
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max()) \
                if got.numel() else 0
            self.max_err[name] = max(self.max_err[name], err)
            if not torch.equal(got, want):
                raise AssertionError(f"{name} differs from its plain version "
                                     f"at (B, R, W) = {(B, R, W)}")
            shape = (1, R, W) if name == "neighbor_min_ell" else (B, R, W)
            nbytes, ops = bytes_and_ops(name, *shape)
            bms, by = bound_ms(nbytes, ops)
            row = {"shape": list(shape), "equal": True, "bound_ms": bms,
                   "bound_by": by}
            if timed:
                # ms: the card's time per call (profiler); call_ms: per call
                # of a back-to-back run, which includes the host's issue time
                # when that is the longer one.
                row["call_ms"] = time_ms(kernel)
                row["plain_call_ms"] = time_ms(plain)
                # Where the profiler sees no device events these stay None
                # (null in the kernels line): call_ms is no card time.
                row["ms"] = device_ms(kernel)
                row["plain_ms"] = device_ms(plain, calls=3)
            rows[name] = row
        del inputs
        torch.cuda.empty_cache()
        return rows


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def print_row(name, row):
    print(f"  {name:24s} {str(tuple(row['shape'])):20s} equal; device ms: "
          f"kernel {fmt_ms(row['ms'])}, plain {fmt_ms(row['plain_ms'])}, "
          f"bound {row['bound_ms']:.4f} ({row['bound_by']}); per call back "
          f"to back: kernel {fmt_ms(row['call_ms'])}, plain "
          f"{fmt_ms(row['plain_call_ms'])}")


def main_path_workload(rng, build_graph, random_arboric, dev):
    ns = np.exp(rng.uniform(np.log(64), np.log(4096), 2048)).astype(np.int64)
    lams = rng.integers(1, 4, 2048)
    ns = np.concatenate([ns, rng.integers(16385, 32769, 8)])
    lams = np.concatenate([lams, np.full(8, 2)])
    graphs = []
    for n, lam in zip(ns, lams):
        edges, _ = random_arboric(int(n), int(lam), rng)
        graphs.append(build_graph(int(n), edges, device=dev))
    return graphs, [int(x) for x in lams]


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def main_path(graphs, lams, rng, dev, card, n_oracle=256, n_per_graph=32):
    """Drive the batch path twice and check it; returns the record."""
    from repro_torch.core import api, batch, mis
    from repro_torch.core import rng as trng
    from repro_torch.core.degree_cap import degree_threshold
    from repro_torch.core.graph import build_graph
    from repro_torch.kernels import neighbor_min as nm

    keys = [trng.PRNGKey(i) for i in range(len(graphs))]

    def drive():
        sync(dev)
        t = time.perf_counter()
        out = batch.correlation_cluster_batch(
            graphs, keys=keys, lams=lams, method="pivot", num_samples=3,
            with_stats=True, device=dev)
        sync(dev)
        return out, time.perf_counter() - t

    (cold, stats), cold_s = drive()
    nm.reset_launch_counts()
    (warm, _), warm_s = drive()
    batch_launches = dict(nm.launches)
    print(f"  cold pass {cold_s:.3f} s; warm pass {warm_s:.3f} s = "
          f"{len(graphs) / warm_s:.1f} graphs/s  [{card}]")
    print(f"  launches in the warm pass: {batch_launches}")
    if dev.type == "cuda":
        for name in ("neighbor_min_ell_batch", "label_agree_ell_batch"):
            if batch_launches[name] <= 0:
                raise AssertionError(f"(a) the main path never launched {name}")
    for a, b in zip(cold, warm):
        if not ((a.labels == b.labels).all() and a.cost == b.cost
                and a.info == b.info):
            raise AssertionError("cold and warm passes differ")
    depth = np.array([r.info["depth"] for r in warm])
    print(f"  MIS rounds p50 {int(np.median(depth))} max {int(depth.max())};"
          f" {len(stats.bucket_shapes)} buckets, padded entries "
          f"{stats.padded_entries}, pad vertex waste {stats.pad_vertex_waste}")

    # (b) labels against sequential PIVOT on the eligible-induced subgraph
    # under the picked sample's ranks (drawn on the CPU); ineligible
    # vertices are edgeless there, hence singletons.
    big = [gi for gi, g in enumerate(graphs) if g.n > 16384]
    small = [gi for gi, g in enumerate(graphs) if g.n <= 16384]
    sample = sorted(set(big) | set(rng.choice(
        small, min(n_oracle, len(small)), replace=False).tolist()))
    for gi in sample:
        g, res = graphs[gi], warm[gi]
        eligible = g.deg.cpu().numpy() <= degree_threshold(lams[gi], 2.0)
        und = g.undirected_edges()
        kept = und[eligible[und[:, 0]] & eligible[und[:, 1]]]
        key = api.sample_keys(keys[gi], 3)[res.info["picked_sample"]]
        ranks = mis.random_permutation_ranks(g.n, key, device="cpu")
        expect = mis.pivot_sequential(
            build_graph(g.n, kept, device="cpu"), ranks.numpy())
        if not (expect == res.labels).all():
            raise AssertionError(f"(b) graph {gi} (n={g.n}) differs from "
                                 "sequential PIVOT")
    print(f"  (b) {len(sample)} graphs equal sequential PIVOT, incl. all "
          f"{len(big)} in R = 2^15")
    # (c) every cost against the host disagreement count.
    for gi, (g, res) in enumerate(zip(graphs, warm)):
        if res.cost != batch._cost_host(g, res.labels):
            raise AssertionError(f"(c) graph {gi}: cost differs from host")
    print(f"  (c) {len(graphs)} costs equal the host count")
    # (d) per-graph engine on the same device, which runs kernel B3.
    per_graph = small[: n_per_graph - 1] + big[-1:]
    nm.reset_launch_counts()
    t0 = time.perf_counter()
    for gi in per_graph:
        single = api.correlation_cluster(graphs[gi], key=keys[gi],
                                         lam=lams[gi], num_samples=3,
                                         device=dev)
        res = warm[gi]
        if not ((single.labels == res.labels).all()
                and single.cost == res.cost
                and single.info["picked_sample"] == res.info["picked_sample"]
                and single.info["depth"] == res.info["depth"]):
            raise AssertionError(f"(d) graph {gi}: per-graph path differs")
    per_graph_s = time.perf_counter() - t0
    graph_launches = dict(nm.launches)
    if dev.type == "cuda" and graph_launches["neighbor_min_ell"] <= 0:
        raise AssertionError("(d) the per-graph path never launched B3")
    print(f"  (d) {len(per_graph)} graphs equal per-graph "
          f"correlation_cluster ({per_graph_s:.2f} s); "
          f"launches {graph_launches}")
    record = {
        "graphs": len(graphs), "cold_s": cold_s, "warm_s": warm_s,
        "graphs_per_s": len(graphs) / warm_s,
        "rounds_p50": float(np.median(depth)), "rounds_max": int(depth.max()),
        "buckets": [list(x) for x in stats.bucket_shapes],
        "launches": batch_launches, "per_graph_s": per_graph_s,
        "per_graph_launches": graph_launches}
    return {"record": record, "stats": stats,
            "per_graph": [graphs[gi] for gi in per_graph]}


# Layers of the batch path, by function, for the host-time breakdown.
LAYERS = ("correlation_cluster_batch", "plan_graph", "pack_bucket",
          "permutation_batch", "_scatter_ell", "run_bucket_program",
          "_pivot_rounds_body", "_disagree_cost_pass", "result_for_plan")


def breakdown(graphs, lams, card, n_trace=256):
    """Where a warm pass spends its time: host seconds per layer (cProfile
    over the whole pass) and the card's busy share (profiler trace of a
    pass over the first ``n_trace`` graphs)."""
    import cProfile
    import pstats

    from repro_torch.core import batch
    from repro_torch.core import rng as trng

    def run(gs, ls):
        out = batch.correlation_cluster_batch(
            gs, keys=[trng.PRNGKey(i) for i in range(len(gs))], lams=ls,
            method="pivot", num_samples=3)
        torch.cuda.synchronize()
        return out

    prof = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.runcall(run, graphs, lams)
    wall = time.perf_counter() - t0
    layers = {name: 0.0 for name in LAYERS}
    for (path, _, func), (_, _, _, cum, _) in pstats.Stats(prof).stats.items():
        if "repro_torch" in path and func in layers:
            layers[func] += cum
    print(f"breakdown: warm pass under cProfile {wall:.2f} s; cumulative "
          f"host s per layer: " + ", ".join(
              f"{k} {v:.2f}" for k, v in layers.items()))

    t0 = time.perf_counter()
    events = device_events(lambda: run(graphs[:n_trace], lams[:n_trace]))
    traced_wall = time.perf_counter() - t0
    result = {"profiled_wall_s": wall, "host_s": layers,
              "traced_graphs": n_trace, "traced_wall_s": traced_wall}
    if events is None:
        print("  device busy share: not measured (no device events)")
        return result
    busy = sum(us for _, us in events) / 1e6
    by_name: dict = {}
    for name, us in events:
        by_name[name] = by_name.get(name, 0.0) + us / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    print(f"  traced pass over {n_trace} graphs: device busy {busy:.3f} s of "
          f"{traced_wall:.3f} s wall ({100 * busy / traced_wall:.1f} %), "
          f"{len(events)} device events  [{card}]")
    for name, sec in top:
        print(f"    {sec:.4f} s  {name[:90]}")
    result.update(device_busy_s=busy, device_events=len(events),
                  top_device=[[n[:120], t] for n, t in top])
    return result


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=Path, default=None,
                        help="also write the full record as JSON here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.graph import build_graph, random_arboric
    from repro_torch.kernels import _build, neighbor_min as nm, ref

    dev = torch.device("cuda")
    record: dict = {}

    # 1. Provenance.
    card = card_line()
    nvcc_version = subprocess.run([_build.nvcc(), "--version"],
                                  capture_output=True, text=True,
                                  check=True).stdout.strip().splitlines()[-1]
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{nvcc_version}, python {sys.version.split()[0]}")
    record["card"] = card

    # 2. Build.
    t0 = time.perf_counter()
    logs = _build.build(_build.sources())
    record["build_s"] = time.perf_counter() - t0
    print(f"build: {record['build_s']:.2f} s for {_build.sources()}")
    for name, text in logs.items():
        regs = sorted({line.split("Used ")[1].split(",")[0]
                       for line in text.splitlines() if "Used " in line})
        print(f"  {name}.cu ptxas: {', '.join(regs)}")

    # 3. Kernel vs plain, on the card.
    rng = np.random.default_rng(args.seed)
    bench = KernelBench(nm, ref, dev)
    record["kernel_shapes"] = []
    for shape in KERNEL_SHAPES:
        rows = bench.run(*shape, rng)
        record["kernel_shapes"].append(rows)
        for name, row in rows.items():
            print_row(name, row)

    # 4. Main path.
    t0 = time.perf_counter()
    graphs, lams = main_path_workload(rng, build_graph, random_arboric, dev)
    print(f"main path: {len(graphs)} graphs built on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    mp = main_path(graphs, lams, rng, dev, card)
    record["main_path"] = mp["record"]
    stats, per_graph = mp["stats"], mp["per_graph"]
    batch_launches = mp["record"]["launches"]
    graph_launches = mp["record"]["per_graph_launches"]

    # Each kernel timed at the largest shape the main path gave it.
    R, W, B = max(stats.bucket_shapes, key=lambda s: s[0] * s[1] * s[2])
    big = max(per_graph, key=lambda g: g.n)
    main_rows = bench.run(B, R, W, rng)
    b3 = bench.run(1, big.n, max(1, big.max_degree()), rng)
    main_rows["neighbor_min_ell"] = b3["neighbor_min_ell"]
    print("kernels at the largest shapes the main path gave them:")
    for name, row in main_rows.items():
        print_row(name, row)
    launches = {**batch_launches,
                "neighbor_min_ell": graph_launches["neighbor_min_ell"]}
    kernels = []
    for name, row in main_rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": bench.max_err[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "shape": row["shape"], "call_ms": row["call_ms"]})
    record["kernels"] = kernels
    record["breakdown"] = breakdown(graphs, lams, card)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=1))

    # 5. Summary.
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
