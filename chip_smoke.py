#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py [--seed 0] [--out smoke.json] [--baseline OLD.cu]
                          [--b4-baseline OLD_FA.cu]

Phases, in order; any failure raises and exits non-zero:

1. provenance: card name and power limit, torch / CUDA / nvcc versions;
2. build: every kernel source under ``src/repro_torch/kernels/csrc``, one
   ``nvcc`` each, started together, and ptxas's registers, stack and spill
   bytes for every kernel instance;
3. kernel vs plain: B1 ``neighbor_min_ell_batch``, B2
   ``label_agree_ell_batch`` and B3 ``neighbor_min_ell`` on random inputs
   made with numpy from ``--seed``, at shapes that take every route of
   their launch plan, held against their plain PyTorch versions with
   ``torch.equal`` (integer outputs: tolerance 0); with ``--baseline``,
   also timed against an earlier kernel source on the same inputs; B4
   ``flash_attention`` at the reference's kernel-test shapes, at
   smollm-135m prefill shapes (S = 24, 512, 2048; f32 and bf16) and at a
   batch of eight 2048-token prefills, within 2e-5 (f32) / 2e-2 (bf16) of
   its plain version. Each with kernel and plain device times (profiler),
   per-call times of back-to-back runs (CUDA events) and the bound; B4
   also with ``scaled_dot_product_attention``'s time as the library
   yardstick and, with ``--b4-baseline``, at every shape with S >= 512 an
   earlier ``flash_attention.cu`` held to the same plain version and timed
   against the kernel, each in profiler sessions of its own (A B B A);
4. clustering main path: ``correlation_cluster_batch(method='pivot',
   num_samples=3)`` on 2,048 random λ-arboric graphs (n log-uniform in
   [64, 4096]) plus 8 graphs in the R = 2¹⁵ bucket, a cold pass and a warm
   pass. The launch counts are zeroed just before the warm pass and read
   just after; B1 and B2 must have launched. Labels are checked against
   sequential PIVOT on the eligible-induced subgraph, every cost against
   the host count, and 32 graphs against per-graph ``correlation_cluster``
   on the card, which must launch B3. B1–B3 are then timed at the largest
   shapes the path gave them, B1 and B2 also on the real arrays of the
   largest bucket, and a breakdown gives host time per layer, the card's
   busy share and B1's and B2's device time in a traced pass;
5. LM serving path: smollm-135m at full width, f32 weights from a
   ``torch.Generator`` seeded with ``--seed``, serving 8 requests (4 with
   4–23-token prompts, 4 with 512–2000, up to 32 new tokens each) through
   ``ContinuousBatcher`` (4 slots, cache_len 2048) and ``serve_all``, with
   every launch count zeroed just before and read just after: (e) every
   request done, B4 launched 30 times per prefill, prefill and decode
   tokens/s; (f) a short and the longest request against the same model on
   the CPU (prefill logits within 1e-3, teacher-forced decode logits within
   5e-2, greedy tokens equal where the CPU's top-2 margin exceeds twice the
   tolerance); a profiler breakdown of one long prefill and 16 decode
   steps; (g) ``repro_torch.launch.serve.run`` on the card. B4 is then
   timed at the longest prefill the path gave it (and against the
   ``--b4-baseline`` source there);
6. summary: the card line, a ``kernels`` JSON line (B1–B4), and last
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
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels.measure import (  # noqa: E402
    B4_SHAPES, B4_TOL, Baseline, FaBaseline, abba_ms, b4_bounds, bound_ms,
    bytes_and_ops, card_line, device_events, device_ms, fmt_ms,
    kernel_inputs)

SOURCE = "src/repro_torch/kernels/csrc/neighbor_min.cu"
REPLACES = {
    "neighbor_min_ell_batch": "src/repro/kernels/neighbor_min.py:97",
    "label_agree_ell_batch": "src/repro/kernels/neighbor_min.py:156",
    "neighbor_min_ell": "src/repro/kernels/neighbor_min.py:49",
}
B4_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
B4_REPLACES = "src/repro/kernels/flash_attention.py:90"
# The same-run A/B against --b4-baseline covers the B4 shapes from here up.
B4_AB_MIN_S = 512
# LM serving against the same model on the CPU: prefill logits after 30
# f32 layers summed in another order; decode logits after steps whose
# keys and values went through bf16 caches, where one value rounded to the
# other side of a bf16 unit moves a logit by ~1e-2.
PREFILL_TOL = 1e-3
DECODE_TOL = 5e-2
SERVE_CACHE_LEN = 2048          # smollm-135m's published context
# B1–B3 shapes (B, R, W) of phase 3, covering every route of the launch
# plan (``neighbor_min.launch_plan``); B3 runs on graph 0 of each, (R, W).
KERNEL_SHAPES = [
    (64, 8, 4),          # l2: under 2 MiB of ELL
    (512, 64, 8),
    (2048, 64, 8),       # staged: a block takes ~16 whole graphs
    (64, 4096, 4),       # staged at the narrowest bucket widths
    (64, 4096, 8),
    (48, 1024, 64),
    (64, 4097, 16),      # staged with R not a power of two
    (24, 32768, 16),     # staged: the R = 2^15 bucket, 131 KB per block
    (8, 32768, 16),
    (16, 512, 256),      # staged, wide rows: a warp per row
    (16, 4096, 4096),
    (3, 999, 7),         # odd W: l2 route (int32 loads), B3 too
    (1, 60000, 8),       # state above a block's 227 KB: l2 route
]
# Shapes of the same-run A/B against a baseline kernel source (--baseline):
# the main path's largest bucket at its three narrow widths, the R = 2^15
# bucket, the wide shape and B3's largest per-graph shape, (n, W) =
# (32312, 18); B3 is also timed at the largest shape of this run's path.
AB_SHAPES = [(768, 4096, 32), (768, 4096, 16), (768, 4096, 8), (8, 32768, 16),
             (16, 4096, 4096), (1, 32312, 18)]
B1_B2 = ("neighbor_min_ell_batch", "label_agree_ell_batch")


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


def profiled_passes(fns, key: str, calls: int = 20):
    """Device ms per call of each function in ``fns``, each one launch of
    its own kernel (names holding ``key``, a different name per function),
    timed in one profiler session in the order A, B, …, …, B, A: the median
    over the launches of each name, the names taken in the order they first
    ran. None where the profiler did not tell the functions apart."""
    from torch.profiler import ProfilerActivity, profile

    order = list(fns) + list(fns)[::-1]
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for fn in order:
            for _ in range(calls):
                fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and key in e.name), key=lambda e: e.time_range.start)
    names: list = []
    for e in events:
        if e.name not in names:
            names.append(e.name)
    if len(names) != len(fns):
        return [None] * len(fns)
    return [float(np.median([e.time_range.elapsed_us() for e in events
                             if e.name == name])) / 1e3 for name in names]


class KernelBench:
    """Calls each wrapper against its plain version and times both; with a
    :class:`Baseline`, also times the baseline kernel on the same inputs."""

    def __init__(self, nm, ref, dev, baseline=None):
        self.nm, self.ref, self.dev = nm, ref, dev
        self.baseline = baseline
        self.max_err = {name: 0 for name in REPLACES}

    def pairs(self, ell, ranks, active, labels, names=tuple(REPLACES)):
        """(kernel, plain, baseline kernel or None) per wrapper; B3 gets
        graph 0."""
        nm, ref, base = self.nm, self.ref, self.baseline
        every = {
            "neighbor_min_ell_batch": (
                lambda: nm.neighbor_min_ell_batch(ell, ranks, active),
                lambda: ref.neighbor_min_ref(ell, ranks, active),
                base and (lambda: base.neighbor_min(ell, ranks, active))),
            "label_agree_ell_batch": (
                lambda: nm.label_agree_ell_batch(ell, labels),
                lambda: ref.label_agree_ref(ell, labels),
                base and (lambda: base.label_agree(ell, labels))),
            "neighbor_min_ell": (
                lambda: nm.neighbor_min_ell(ell[0], ranks[0], active[0]),
                lambda: ref.neighbor_min_ref(ell[0], ranks[0], active[0]),
                base and (lambda: base.neighbor_min(ell[0], ranks[0],
                                                    active[0]))),
        }
        return {name: every[name] for name in names}

    def run(self, B, R, W, rng, timed=True, ab=False):
        """Check (and time) every kernel at one (B, R, W); B3 gets graph 0."""
        inputs = kernel_inputs(B, R, W, rng, self.dev)
        rows = self.check(self.pairs(*inputs), (B, R, W), timed, ab)
        del inputs
        torch.cuda.empty_cache()
        return rows

    def check(self, pairs, shape, timed=True, ab=False):
        """Each kernel ``torch.equal`` to its plain version; with ``timed``
        its device and per-call times, the plain version's and the bound;
        with ``ab`` and a baseline, kernel and baseline kernel in one
        profiler session (A B B A)."""
        B, R, W = shape
        rows = {}
        for name, (kernel, plain, old) in pairs.items():
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max()) \
                if got.numel() else 0
            self.max_err[name] = max(self.max_err[name], err)
            if not torch.equal(got, want):
                raise AssertionError(f"{name} differs from its plain version "
                                     f"at (B, R, W) = {(B, R, W)}")
            kshape = (1, R, W) if name == "neighbor_min_ell" else (B, R, W)
            nbytes, ops = bytes_and_ops(name, *kshape)
            bms, by = bound_ms(nbytes, ops)
            row = {"shape": list(kshape), "equal": True, "bound_ms": bms,
                   "bound_by": by,
                   "variant": self.nm.launch_plan(*kshape, R + 1).route}
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
            if ab and old is not None:
                if not torch.equal(old(), want):
                    raise AssertionError(f"the baseline {name} differs from "
                                         f"the plain version at {shape}")
                key = "label_agree" if "agree" in name else "neighbor_min"
                row["ab_ms"], row["baseline_ms"] = profiled_passes(
                    [kernel, old], key)
            rows[name] = row
        return rows


class AttentionBench:
    """Calls B4 against its plain version, times both and the library
    call (``scaled_dot_product_attention``) on the same inputs; with a
    :class:`FaBaseline`, also the baseline kernel where ``ab`` is set."""

    def __init__(self, fa, ref, dev, baseline=None):
        self.fa, self.ref, self.dev = fa, ref, dev
        self.baseline = baseline
        self.max_err = {dtype: 0.0 for dtype in B4_TOL}

    def run(self, shape, rng, timed=True, ab=False):
        B, H, KH, Sq, Sk, D, causal, dtype = shape
        dt = getattr(torch, dtype)
        q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32))
                   .to(self.dev, dt)
                   for s in ((B, H, Sq, D), (B, KH, Sk, D), (B, KH, Sk, D)))

        def kernel():
            return self.fa.flash_attention(q, k, v, causal=causal)

        def plain():
            return self.ref.attention_ref(q, k, v, causal=causal)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        self.max_err[dtype] = max(self.max_err[dtype], err)
        if not err < B4_TOL[dtype]:
            raise AssertionError(f"flash_attention differs from its plain "
                                 f"version by {err} at {shape}")
        bms, by, bounds = b4_bounds(shape)
        row = {"shape": list(shape), "max_abs_err": err, "bound_ms": bms,
               "bound_by": by, "bounds": bounds}
        if timed:
            row["call_ms"] = time_ms(kernel)
            row["plain_call_ms"] = time_ms(plain, calls=3)
            row["ms"] = device_ms(kernel)
            row["plain_ms"] = device_ms(plain, calls=3)
            # The library yardstick where the shape is one self-attention
            # call (Sq = Sk); never called by the port.
            row["library_ms"] = device_ms(library) if Sq == Sk else None
        if ab and self.baseline is not None:
            def old():
                return self.baseline(q, k, v, causal=causal)
            base_err = float((old().float() - want.float()).abs().max())
            if not base_err < B4_TOL[dtype]:
                raise AssertionError(f"the baseline flash_attention differs "
                                     f"from the plain version by {base_err}"
                                     f" at {shape}")
            row["baseline_err"] = base_err
            # Both builds name their kernel fa_forward_kernel<T, D>, so
            # each is timed in a profiler session of its own.
            row["ab_ms"], row["baseline_ms"] = abba_ms([kernel, old])
        del q, k, v, got, want
        torch.cuda.empty_cache()
        return row


def print_b4_row(row):
    bounds = ", ".join(f"{k} {v:.4f}" for k, v in row["bounds"].items())
    line = (f"  flash_attention {str(tuple(row['shape'])):48s} "
            f"err "
            f"{row['max_abs_err']:.3g}; device ms: kernel {fmt_ms(row['ms'])}"
            f", plain {fmt_ms(row['plain_ms'])}, library "
            f"{fmt_ms(row['library_ms'])}, bound {row['bound_ms']:.4f} "
            f"({row['bound_by']}; {bounds}); per call back to back: kernel "
            f"{fmt_ms(row['call_ms'])}")
    if "baseline_ms" in row:
        line += (f"; A/B (ABBA) kernel {fmt_ms(row['ab_ms'])} vs baseline "
                 f"{fmt_ms(row['baseline_ms'])} (baseline err "
                 f"{row['baseline_err']:.3g})")
    print(line)


def print_row(name, row):
    line = (f"  {name:24s} {str(tuple(row['shape'])):20s} {row['variant']:6s}"
            f" equal; device ms: kernel {fmt_ms(row.get('ms'))}, plain "
            f"{fmt_ms(row.get('plain_ms'))}, bound {row['bound_ms']:.4f} "
            f"({row['bound_by']}); per call back to back: kernel "
            f"{fmt_ms(row.get('call_ms'))}, plain "
            f"{fmt_ms(row.get('plain_call_ms'))}")
    if "baseline_ms" in row:
        line += (f"; A/B (ABBA) kernel {fmt_ms(row['ab_ms'])} vs baseline "
                 f"{fmt_ms(row['baseline_ms'])}")
    print(line)


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


class LargestCall:
    """For one pass, wraps the B1 and B2 wrappers and keeps a copy of the
    inputs of the first call on the largest ELL each was given: the real
    arrays of the largest bucket. The kernels still launch and count."""

    def __init__(self, nm):
        self.nm, self.args = nm, {}

    def __enter__(self):
        self.saved = {name: getattr(self.nm, name) for name in B1_B2}
        for name, fn in self.saved.items():
            setattr(self.nm, name, self._keep(name, fn))
        return self

    def _keep(self, name, fn):
        def wrapped(ell, *state):
            kept = self.args.get(name)
            if kept is None or ell.numel() > kept[0].numel():
                self.args[name] = [t.clone() for t in (ell, *state)]
            return fn(ell, *state)
        return wrapped

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.nm, name, fn)


def real_bucket_rows(bench, args):
    """B1 and B2 checked and timed on the real arrays of the largest bucket
    a pass packed (B1 on its first MIS round's active set)."""
    ell, ranks, active = args["neighbor_min_ell_batch"]
    ell2, labels = args["label_agree_ell_batch"]
    rows = bench.check(bench.pairs(ell, ranks, active, None,
                                   names=B1_B2[:1]),
                       tuple(ell.shape), ab=True)
    rows.update(bench.check(bench.pairs(ell2, None, None, labels,
                                        names=B1_B2[1:]),
                            tuple(ell2.shape), ab=True))
    for name, e in zip(B1_B2, (ell, ell2)):
        rows[name]["pad_share"] = float((e == e.shape[1]).float().mean())
    rows[B1_B2[0]]["active_share"] = float(active[:, :-1].float().mean())
    return rows


def breakdown(graphs, lams, card, nm, n_trace=256):
    """Where a warm pass spends its time: host seconds per layer (cProfile
    over the whole pass), the card's busy share and B1's and B2's device
    time (profiler trace of a pass over the first ``n_trace`` graphs).
    The cProfile pass also keeps the largest bucket's B1/B2 inputs
    (``result["largest"]``)."""
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
    with LargestCall(nm) as largest:
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
              "traced_graphs": n_trace, "traced_wall_s": traced_wall,
              "largest": largest.args}
    if events is None:
        print("  device busy share: not measured (no device events)")
        return result
    busy = sum(us for _, us in events) / 1e6
    # The ELL kernels' names: neighbor_min_{staged,l2}, label_agree_{...}.
    ell_ms = {name: sum(us for ev, us in events if key in ev) / 1e3
              for name, key in zip(B1_B2, ("neighbor_min", "label_agree"))}
    print(f"  traced pass: B1 {ell_ms[B1_B2[0]]:.4f} ms, B2 "
          f"{ell_ms[B1_B2[1]]:.4f} ms of device time  [{card}]")
    result["ell_kernel_device_ms"] = ell_ms
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


def serving_requests(rng, vocab_size, cache_len, pairs=4,
                     long_prompt=(512, 2001), max_new=33):
    """``pairs`` short prompts as the reference driver draws them (4–23
    tokens) alternating with long ones (512–2000); 2 to ``max_new - 1``
    new tokens each, prompt plus new tokens within ``cache_len``."""
    from repro_torch.serve.batching import Request

    reqs = []
    for uid in range(2 * pairs):
        lo, hi = (4, 24) if uid % 2 == 0 else long_prompt
        n = int(rng.integers(lo, hi))
        new = int(rng.integers(2, max_new))
        if n + new > cache_len - 1:
            raise ValueError("request longer than the cache")
        reqs.append(Request(uid=uid, prompt=rng.integers(
            2, vocab_size, n).astype(np.int32), max_new_tokens=new))
    return reqs


class TimedModel:
    """The model behind the batcher, with host seconds per entry point,
    each call ended by a synchronise (the batcher's argmax waits for the
    card right after every call anyway)."""

    def __init__(self, model):
        self.model, self.cfg, self.device = model, model.cfg, model.device
        self.prefill_s = self.decode_s = 0.0
        self.prefill_tokens = self.decode_tokens = 0
        self.prefill_calls = []     # (prompt tokens, seconds) per prefill

    def _timed(self, fn, *args, **kwargs):
        sync(self.device)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        sync(self.device)
        return out, time.perf_counter() - t0

    def prefill(self, tokens, cache_len):
        out, sec = self._timed(self.model.prefill, tokens, cache_len=cache_len)
        self.prefill_calls.append((tokens.numel(), sec))
        self.prefill_s += sec
        self.prefill_tokens += tokens.numel()
        return out

    def decode_step(self, tok, caches, pos):
        out, sec = self._timed(self.model.decode_step, tok, caches, pos)
        self.decode_s += sec
        self.decode_tokens += tok.numel()
        return out


def serving_path(model, requests, cache_len, card, slots=4):
    """Serve ``requests`` through ``ContinuousBatcher`` and ``serve_all``
    with every launch count zeroed just before and read just after."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import neighbor_min as nm
    from repro_torch.serve.batching import ContinuousBatcher
    from repro_torch.serve.engine import serve_all

    timed = TimedModel(model)
    batcher = ContinuousBatcher(timed, max_slots=slots, cache_len=cache_len)
    nm.reset_launch_counts()
    fa.reset_launch_counts()
    sync(model.device)
    t0 = time.perf_counter()
    retired = serve_all(batcher, requests)
    sync(model.device)
    wall = time.perf_counter() - t0
    launches = {**nm.launches, **fa.launches}
    st = batcher.stats
    if sorted(r.uid for r in retired) != [r.uid for r in requests] or not \
            all(r.done and r.out_tokens for r in requests):
        raise AssertionError("(e) not every request was served")
    want = model.cfg.num_layers * st.prefills
    if model.device.type == "cuda" and launches["flash_attention"] != want:
        raise AssertionError(f"(e) B4 launched {launches['flash_attention']}"
                             f" times for {st.prefills} prefills, not {want}")
    record = {
        "requests": len(requests), "slots": slots, "cache_len": cache_len,
        "prompt_lengths": [len(r.prompt) for r in requests],
        "new_tokens": [len(r.out_tokens) for r in requests],
        "wall_s": wall, "prefill_s": timed.prefill_s,
        "decode_s": timed.decode_s, "prefill_calls": timed.prefill_calls,
        "prefill_tokens": timed.prefill_tokens,
        "decode_tokens": timed.decode_tokens,
        "prefill_tokens_per_s": timed.prefill_tokens / timed.prefill_s,
        "decode_tokens_per_s": timed.decode_tokens / max(timed.decode_s,
                                                         1e-9),
        "prefills": st.prefills, "decode_steps": st.decode_steps,
        "emitted_tokens": st.emitted_tokens,
        "wasted_slot_steps": st.wasted_slot_steps, "launches": launches}
    print(f"  (e) {len(requests)} requests served in {wall:.3f} s wall: "
          f"prefill {timed.prefill_tokens} tokens in {timed.prefill_s:.3f} s"
          f" = {record['prefill_tokens_per_s']:.1f} tokens/s; decode "
          f"{timed.decode_tokens} tokens in {timed.decode_s:.3f} s = "
          f"{record['decode_tokens_per_s']:.1f} tokens/s  [{card}]")
    print(f"      prefills {st.prefills}, decode steps {st.decode_steps}, "
          f"wasted slot-steps {st.wasted_slot_steps}; launches {launches}")
    return record


def _margin(logits, vocab):
    top2 = torch.topk(logits[0, :vocab].float(), 2).values
    return float(top2[0] - top2[1])


def check_against_cpu(model, requests, cache_len):
    """(f) The same model on the CPU (plain path, weights copied) against
    the card: prefill logits, decode logits under teacher forcing with
    the CPU's greedy tokens fed to both, and greedy tokens wherever the
    CPU's top-2 margin exceeds twice the tolerance."""
    from repro_torch.models import build_model

    dev, cfg, vocab = model.device, model.cfg, model.cfg.vocab_size
    cpu = build_model(cfg, device="meta").to_empty(device="cpu")
    cpu.load_state_dict(model.state_dict())
    out = []
    for req in requests:
        prompt = torch.as_tensor(req.prompt[None, :], dtype=torch.long)
        lc, cc = cpu.prefill(prompt, cache_len=cache_len)
        lg, cg = model.prefill(prompt.to(dev), cache_len=cache_len)
        errs = [float((lg.cpu() - lc).abs().max())]
        tols = [PREFILL_TOL]
        cpu_tok = [int(lc[0, :vocab].argmax())]
        card_tok = [int(lg[0, :vocab].argmax())]
        margins = [_margin(lc, vocab)]
        for t in range(1, len(req.out_tokens)):
            pos = len(req.prompt) + t - 1
            tok = torch.tensor([cpu_tok[-1]])
            lc, cc = cpu.decode_step(tok, cc, pos)
            lg, cg = model.decode_step(tok.to(dev), cg, pos)
            errs.append(float((lg.cpu() - lc).abs().max()))
            tols.append(DECODE_TOL)
            cpu_tok.append(int(lc[0, :vocab].argmax()))
            card_tok.append(int(lg[0, :vocab].argmax()))
            margins.append(_margin(lc, vocab))
        for t, (err, tol) in enumerate(zip(errs, tols)):
            if not err <= tol:
                raise AssertionError(f"(f) request {req.uid} step {t}: "
                                     f"logits {err} apart (tolerance {tol})")
        clear = [m > 2 * tol for m, tol in zip(margins, tols)]
        for t in range(len(cpu_tok)):
            if clear[t] and card_tok[t] != cpu_tok[t]:
                raise AssertionError(f"(f) request {req.uid} step {t}: "
                                     "teacher-forced greedy token differs")
        served_equal = 0
        for t in range(len(cpu_tok)):
            if not clear[t]:
                break
            if req.out_tokens[t] != cpu_tok[t]:
                raise AssertionError(f"(f) request {req.uid} step {t}: "
                                     "served token differs from the CPU's")
            served_equal += 1
        row = {"uid": req.uid, "prompt": len(req.prompt),
               "steps": len(cpu_tok), "prefill_err": errs[0],
               "decode_err_max": max(errs[1:], default=0.0),
               "min_margin": min(margins),
               "served_tokens_checked": served_equal}
        print(f"  (f) request {req.uid} (prompt {row['prompt']}): prefill "
              f"logits {errs[0]:.3g} apart (tol {PREFILL_TOL}), decode max "
              f"{row['decode_err_max']:.3g} (tol {DECODE_TOL}) over "
              f"{len(errs) - 1} steps; {served_equal} of {len(cpu_tok)} "
              f"served tokens equal the CPU's (min margin "
              f"{row['min_margin']:.3g})")
        out.append(row)
    return out


def lm_breakdown(model, prompt_len, cache_len, rng, card, decode_steps=16):
    """Where the serving time goes on the card: a profiler trace of one
    prefill of ``prompt_len`` tokens and of ``decode_steps`` decode steps
    after it; device busy share and the busiest kernels of each."""
    vocab = model.cfg.vocab_size
    tokens = torch.as_tensor(rng.integers(2, vocab, (1, prompt_len)),
                             device=model.device)
    state = {"caches": model.prefill(tokens, cache_len=cache_len)[1]}
    result = {}

    def prefill():
        state["caches"] = model.prefill(tokens, cache_len=cache_len)[1]

    def decode():
        tok = torch.tensor([2], device=model.device)
        for t in range(decode_steps):
            model.decode_step(tok, state["caches"], prompt_len + t)

    result["decode_host"] = decode_host_split(decode, decode_steps,
                                              model.device)
    for name, fn in (("prefill", prefill), ("decode", decode)):
        t0 = time.perf_counter()
        events = device_events(fn)
        wall = time.perf_counter() - t0
        if events is None:
            print(f"  {name}: device busy share not measured (no events)")
            result[name] = {"wall_s": wall}
            continue
        busy = sum(us for _, us in events) / 1e6
        by_name: dict = {}
        for kname, us in events:
            by_name[kname] = by_name.get(kname, 0.0) + us / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        what = f"{prompt_len} tokens" if name == "prefill" else \
            f"{decode_steps} steps after {prompt_len} tokens"
        print(f"  {name} ({what}): device busy {busy * 1e3:.3f} ms of "
              f"{wall * 1e3:.3f} ms wall ({100 * busy / wall:.1f} %), "
              f"{len(events)} device events  [{card}]")
        for kname, sec in top:
            print(f"    {sec * 1e3:.4f} ms  {kname[:90]}")
        result[name] = {"wall_s": wall, "device_busy_s": busy,
                        "device_events": len(events),
                        "top_device": [[n[:120], t] for n, t in top]}
    return result


# Functions of the decode step and their modules, for the host-time split.
DECODE_LAYERS = {"decode_step": "decoding.py", "_logits": "decoding.py",
                 "decode_attention": "attention.py", "_project": "attention.py",
                 "apply_rope": "common.py", "linear": "common.py",
                 "rms_norm": "common.py", "mlp": "mlp.py"}


def decode_host_split(decode, steps, dev):
    """Host seconds per decode step in each function of the step
    (cProfile, cumulative, so nested functions overlap)."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    sync(dev)
    t0 = time.perf_counter()
    prof.runcall(decode)
    sync(dev)
    wall = time.perf_counter() - t0
    split = {name: 0.0 for name in DECODE_LAYERS}
    for (path, _, func), (_, _, _, cum, _) in pstats.Stats(prof).stats.items():
        if func in split and path.endswith(
                f"repro_torch/models/{DECODE_LAYERS[func]}"):
            split[func] += cum / steps
    print(f"  decode under cProfile: {wall / steps * 1e3:.2f} ms per step; "
          f"host ms per step: " + ", ".join(
              f"{k} {v * 1e3:.2f}" for k, v in split.items()))
    return {"ms_per_step": wall / steps * 1e3,
            "host_ms_per_step": {k: v * 1e3 for k, v in split.items()}}


def entry_point_check(card):
    """(g) The command-line entry point at full width on the card, its own
    counts zeroed before and read after."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve

    fa.reset_launch_counts()
    t0 = time.perf_counter()
    reqs, st = serve.run("smollm-135m", smoke=False, n_requests=4,
                         max_new=8, seed=1, device="cuda")
    wall = time.perf_counter() - t0
    if fa.launches["flash_attention"] != 30 * st.prefills:
        raise AssertionError("(g) launch.serve.run did not launch B4 once "
                             "per layer and prefill")
    print(f"  (g) launch.serve.run: {len(reqs)} requests in {wall:.2f} s "
          f"(model init included), B4 launches "
          f"{fa.launches['flash_attention']}  [{card}]")
    return {"wall_s": wall, "launches": dict(fa.launches)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=Path, default=None,
                        help="also write the full record as JSON here")
    parser.add_argument("--baseline", type=Path, default=None,
                        help="another csrc/neighbor_min.cu, built and timed "
                        "beside B1-B3 on the same inputs; its C entries "
                        "must take no launch plan or this checkout's (see "
                        "measure.bind_baseline)")
    parser.add_argument("--b4-baseline", type=Path, default=None,
                        help="another csrc/flash_attention.cu whose "
                        "fa_forward takes this checkout's 14 arguments, "
                        "built and timed beside B4 on the same inputs")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs on the card",
              file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.core.graph import build_graph, random_arboric
    from repro_torch.kernels import _build, flash_attention as fa
    from repro_torch.kernels import neighbor_min as nm, ref
    from repro_torch.models import build_model

    # Full f32 in every matrix product and convolution: TF32 keeps about
    # three decimal digits and would break the tolerances above.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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

    # 2. Build, the baseline source (if any) alongside.
    t0 = time.perf_counter()
    baseline = Baseline(args.baseline) if args.baseline else None
    fa_base = FaBaseline(args.b4_baseline) if args.b4_baseline else None
    logs = _build.build(_build.sources())
    for extra in (baseline, fa_base):
        if extra is not None:
            extra.load()
    record["build_s"] = time.perf_counter() - t0
    print(f"build: {record['build_s']:.2f} s for {_build.sources()}")
    record["ptxas"] = {}
    for name, text in logs.items():
        record["ptxas"][name] = _build.ptxas_report(text)
        print(f"  {name}.cu, ptxas per kernel: registers, stack / spill "
              f"store / spill load bytes")
        for r in record["ptxas"][name]:
            print(f"    {r['registers']} regs, {r['stack']} / "
                  f"{r['spill_stores']} / {r['spill_loads']} B  "
                  f"{r['function'][:80]}")

    # 3. Kernel vs plain, on the card.
    rng = np.random.default_rng(args.seed)
    bench = KernelBench(nm, ref, dev, baseline)
    record["kernel_shapes"] = []
    for shape in KERNEL_SHAPES:
        rows = bench.run(*shape, rng)
        record["kernel_shapes"].append(rows)
        for name, row in rows.items():
            print_row(name, row)
    if baseline is not None:
        print(f"A/B against {args.baseline}, same inputs, one profiler "
              f"session per kernel  [{card}]")
        record["ab_shapes"] = []
        for shape in AB_SHAPES:
            rows = bench.run(*shape, rng, ab=True)
            record["ab_shapes"].append(rows)
            for name, row in rows.items():
                print_row(name, row)
    abench = AttentionBench(fa, ref, dev, fa_base)
    record["b4_shapes"] = []
    if fa_base is not None:
        print(f"B4 A/B against {args.b4_baseline} at S >= {B4_AB_MIN_S}, "
              f"same inputs, a profiler session per kernel and pass  [{card}]")
    for shape in B4_SHAPES:
        row = abench.run(shape, rng, ab=shape[3] >= B4_AB_MIN_S)
        record["b4_shapes"].append(row)
        print_b4_row(row)

    # 4. Clustering main path.
    t0 = time.perf_counter()
    # Its own generator, so phase 3's draws do not change the workload.
    wrng = np.random.default_rng([args.seed, 4])
    graphs, lams = main_path_workload(wrng, build_graph, random_arboric, dev)
    print(f"main path: {len(graphs)} graphs built on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    mp = main_path(graphs, lams, wrng, dev, card)
    record["main_path"] = mp["record"]
    stats, per_graph = mp["stats"], mp["per_graph"]
    batch_launches = mp["record"]["launches"]
    graph_launches = mp["record"]["per_graph_launches"]

    # Each kernel timed at the largest shape the main path gave it.
    R, W, B = max(stats.bucket_shapes, key=lambda s: s[0] * s[1] * s[2])
    big = max(per_graph, key=lambda g: g.n)
    main_rows = bench.run(B, R, W, rng, ab=True)
    b3 = bench.run(1, big.n, max(1, big.max_degree()), rng, ab=True)
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
            "shape": row["shape"], "call_ms": row["call_ms"],
            "variant": row["variant"],
            **{k: row[k] for k in ("ab_ms", "baseline_ms") if k in row}})
    record["breakdown"] = breakdown(graphs, lams, card, nm)
    real = real_bucket_rows(bench, record["breakdown"].pop("largest"))
    print("B1 and B2 on the real arrays of the largest bucket the pass "
          "packed:")
    for name, row in real.items():
        print_row(name, row)
        print(f"    pad share of the ELL {row['pad_share']:.4f}"
              + (f", active share {row['active_share']:.4f}"
                 if "active_share" in row else ""))
    record["real_bucket"] = real
    del graphs, per_graph, mp, stats
    torch.cuda.empty_cache()

    # 5. LM serving path: smollm-135m at full width, f32, random weights.
    cfg = get_config("smollm-135m")
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, dtype=torch.float32,
                        generator=torch.Generator().manual_seed(args.seed))
    n_weights = sum(p.numel() for p in model.parameters())
    print(f"serving path: {cfg.name} ({n_weights} weights, f32) built in "
          f"{time.perf_counter() - t0:.2f} s")
    srng = np.random.default_rng([args.seed, 5])   # as wrng, for phase 5
    reqs = serving_requests(srng, cfg.vocab_size, SERVE_CACHE_LEN)
    serve_rec = serving_path(model, reqs, SERVE_CACHE_LEN, card)
    longest = max(reqs, key=lambda r: len(r.prompt))
    serve_rec["cpu_check"] = check_against_cpu(model, [reqs[0], longest],
                                               SERVE_CACHE_LEN)
    serve_rec["breakdown"] = lm_breakdown(model, len(longest.prompt),
                                          SERVE_CACHE_LEN, srng, card)
    serve_rec["entry_point"] = entry_point_check(card)
    record["serving_path"] = serve_rec

    # B4 timed at the largest prefill shape the serving path gave it.
    s_max = len(longest.prompt)
    row = abench.run((1, cfg.num_heads, cfg.num_kv_heads, s_max, s_max,
                      cfg.head_dim, True, "float32"), rng, ab=True)
    print("B4 at the largest prefill shape the serving path gave it:")
    print_b4_row(row)
    kernels.append({
        "name": "flash_attention", "route": "cuda", "source": B4_SOURCE,
        "replaces": B4_REPLACES,
        "launches": serve_rec["launches"]["flash_attention"],
        # Over every B4 check of this run, f32 and bf16 alike; by dtype
        # beside it.
        "max_abs_err": max(abench.max_err.values()),
        "max_abs_err_by_dtype": abench.max_err, "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        "shape": row["shape"], "call_ms": row["call_ms"],
        "bounds": row["bounds"],
        # What the path runs: element type and head dim; f32 products as
        # three TF32 MMAs.
        "variant": f"fa_forward_kernel<float32, {cfg.head_dim}>, "
                   f"mma.sync 3xTF32",
        **{k: row[k] for k in ("ab_ms", "baseline_ms") if k in row}})
    record["kernels"] = kernels
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(record, indent=1))

    # 6. Summary.
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
