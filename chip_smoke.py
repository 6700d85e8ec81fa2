#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py [--seed 0] [--out smoke.json] [--baseline OLD.cu]
                          [--b4-baseline OLD_FA.cu] [--ag-baseline OLD_AG.cu]
                          [--b3-baseline OLD_MP.cu]

Phases, in order; any failure raises and exits non-zero:

1. provenance: card name and power limit, torch / CUDA / nvcc versions;
2. build: every kernel source under ``src/repro_torch/kernels/csrc``, one
   ``nvcc`` each, started together, and ptxas's registers, stack and spill
   bytes for every kernel instance;
3. kernel vs plain: B1 ``neighbor_min_ell_batch``, B2
   ``label_agree_ell_batch`` and their one-graph form ``neighbor_min_ell``
   (the round step of the per-graph host loop) on random inputs made with
   numpy from ``--seed``, at shapes that take every route of their launch
   plan, held against their plain PyTorch versions with ``torch.equal``
   (integer outputs: tolerance 0); with ``--baseline``, also timed against
   an earlier kernel source on the same inputs; B3 ``mis_pivot`` (every MIS
   round and the PIVOT capture of k samples of one graph in one launch) on
   random λ-arboric graphs under the degree cap (n = 64, 4,096 and 32,768
   at k = 3, 60,000 above a block's shared memory, a star whose hub the cap
   leaves out, and k = 1), each route that takes the shape held to the
   plain version with ``torch.equal`` on status, labels and rounds, and the
   planned route timed with its bound, registers and spills (with
   ``--b3-baseline``, an earlier ``mis_pivot.cu`` held to the same plain
   version and timed against it at every shape, A B B A); B3's window mode
   (Algorithm 1's ``_run_window``) at n = 4,096, 32,768 and 60,000: the
   upper half of the ranks from scratch (its winners must remove vertices
   below the window), an empty window after it and [0, n), each route that
   takes the shape held to the plain version with ``torch.equal``, the
   planned route timed against its byte bound with registers and spills; B4
   ``flash_attention`` at the reference's kernel-test shapes, at
   smollm-135m prefill shapes (S = 24, 512, 2048; f32 and bf16), at a
   batch of eight 2048-token prefills and at 1024-token prefills with head
   dims 80 and 160, within 2e-5 (f32) / 2e-2 (bf16) of its plain version,
   and in bf16 with every output in [4.5, 7.5] within 2e-2 of the plain
   version's f32 output (with ``--b4-baseline``, that source's error there
   too). Each with kernel and plain device times (profiler),
   per-call times of back-to-back runs (CUDA events) and the bound; B4
   also with ``scaled_dot_product_attention``'s time as the library
   yardstick and, with ``--b4-baseline``, at every shape with S >= 512 an
   earlier ``flash_attention.cu`` held to the same plain version and timed
   against the kernel, each in profiler sessions of its own (A B B A);
4. clustering main path: ``correlation_cluster_batch(method='pivot',
   num_samples=3)`` on 2,048 random λ-arboric graphs (n log-uniform in
   [64, 4096]) plus 8 graphs in the R = 2¹⁵ bucket, one pass. The launch
   counts are zeroed just before the pass and read just after; B1 and B2
   must have launched. Labels are checked against
   sequential PIVOT on the eligible-induced subgraph, every cost against
   the host count; (d) 32 graphs through per-graph
   ``correlation_cluster`` on the card, its counts zeroed just before and
   read just after: bit-identical to the batch path (labels, cost, picked
   sample, depth), B3 launched once a graph and the ELL kernel never, with
   the wall time, the host split (cProfile), device events and blocking
   syncs per graph and the card's busy share, against the port's earlier
   path on the same graphs (every sample drawn alone, its MIS one round a
   host iteration over ``neighbor_min_ell``) in turns A B B A. B1 and B2
   are then timed at the largest shapes the path gave them, B3 at the
   largest per-graph graph against that earlier path, B1 and B2 also on
   the real arrays of the largest bucket, and a breakdown gives host time
   per layer, the card's busy share and B1's and B2's device time in a
   traced pass;
5. clustering serving layer: the main path's workload drawn anew (2,056
   graphs), one arrival trace of 2,467 requests (every graph once, 25 %
   precluster, plus exact repeats of 20 % of them), k = 3:
   the agreement kernel at three precluster buckets (the one packing the
   most ELL, the R = 2¹⁵ one, the largest at W <= 16) on every route its
   launch plan can pick, at ``replicas`` 3 (one pass a graph, the rounds
   body's call) and 1, ``torch.equal`` to the plain version, timed per
   route with both bounds, its peak device memory and its share of the
   bucket program (with ``--ag-baseline``, an earlier ``agreement.cu``
   timed against it at replicas 1, A B B A); B1 on those buckets'
   agreement graphs (``agree_ell``), on every route of its launch plan
   that takes the shape, ``torch.equal`` to the plain version; then (h)
   ``serve_all`` through
   ``ClusterBatcher(executor='async', policy='cost')``, its counts zeroed
   just before and read just after (B1 and B2 must have launched): every
   result equal to ``correlation_cluster_batch`` on the card for its
   graph, key and method, 64 equal to the CPU (precluster against
   ``precluster_host``), requests/s, flush wall p50/p99, cache hits and
   single-flight riders; the same trace on the sync executor (walls A B
   against async) and under ``policy='coalesce'``; 256 requests under
   ``objective='minmax'`` on the async and the sharded (one device)
   executors, against the batch path; ``submit``'s return time on the
   R = 2¹⁵ pivot bucket; the card's busy share over a traced pass;
6. LM serving path: smollm-135m at full width, f32 weights from a
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
7. the paper's other algorithms, each against the same call on the CPU:
   (a) ``correlation_cluster(method='pivot_phased', num_samples=3)`` on 8
   random λ-arboric graphs (n 4,096 and 32,768, λ 1–3), labels, cost and
   info with the ledger equal, B3's window mode launched and the fused
   PIVOT not (counts zeroed just before, read just after), blocking syncs;
   (b) ``algorithm1(subroutine='alg2')`` at n = 32,768, status, rounds and
   ledger equal, then the window mode timed on the first prefix Algorithm
   1 gives that graph; (c) ``correlation_cluster(lam=None)`` at
   n = 262,144 (the parallel degeneracy peel); (d) ``distributed_pivot``,
   raw and capped, packed and not, on an NCCL group of world size 1, equal
   to B3 on the same edge-masked graph, with rounds and all-reduce bytes a
   round, and ``correlation_cluster(distributed=True)`` for ``pivot`` and
   ``pivot_raw`` equal to the single-device call; (e) ``forest_exact`` and
   ``forest_approx`` on a random forest of n = 100,000 (partner and rounds
   of the augmenting matching equal, the approx/exact cost ratio); (f)
   ``cliques`` on 8,000 disjoint cliques plus noise; walls per method;
8. the near-duplicate dedup path (``repro_torch.data.dedup``) on a
   synthetic corpus of 20,000 documents (the reference test's recipe:
   lengths 64–256, 40 % near-duplicates at 5 % mutation, ``--seed``),
   threshold 0.45, best-of-4, each call's launch counts zeroed just before
   and read just after: (a) ``dedup_corpus_batched`` (B1 and B2 must
   launch) equal to the same call on the CPU in labels, keep, cost and
   info, with the wall of each stage (MinHash, similarity edges, sharding,
   graph build, clustering, stitching), the shard count and buckets, and
   the card's busy share over the clustering stage traced alone; (b)
   ``dedup_corpus_streaming`` through ``ClusterBatcher`` equal to batched
   (B1 and B2 launched); (c) ``dedup_corpus``, the whole graph through the
   per-graph engine (B3 launched), equal to the CPU; (d) the same with
   ``distributed=True`` on an NCCL group of world size 1, equal to
   ``distributed=False``; (e) ``dedup_quality`` on 2,000 documents of the
   same recipe, recall > 0.7, precision > 0.9, kept fraction < 0.85;
9. the launch-plan autotuner (``repro_torch.kernels.autotune``):
   ``ClusterBatcher(executor='sync').warmup(autotune=True)`` over phase
   5's graphs (one sample graph a bucket its trace flushes), the tuning
   cache in a temporary file; every candidate plan of B1 and B2 on the
   real packed tensors of every swept tier equal to the plain version
   (``torch.equal``) and no faster than its roofline model
   (``launch/roofline.py`` ``ell_kernel_roofline``); per bucket and tier
   the winner, the default's and the winner's device time (CUDA events);
   a second cache loaded from the file makes no sweep and hits every
   entry; phase 5's trace served untuned and tuned (sync executor, cost
   policy, A B B A), every tuned result equal to the untuned one, the
   program keys carrying the tuned plans, requests/s of each pass;
10. the training path (``repro_torch.launch.train``): (a) ``run`` at
   smollm-135m's full width (30 layers, d = 576, vocabulary 49,152, f32
   weights and AdamW state), 20 steps of 8 sequences of 1,024 tokens,
   checkpoints every 5, the dedup stage on: its wall, median step ms,
   tokens/s, peak memory, B3's launches in the dedup stage and none of B4
   (training takes chunked attention; counts zeroed just before, read just
   after), then B3 on every route held to its plain version at the inputs
   the stage gave it (k = 4, n = 300) and the stage's kept documents,
   labels and batches held to the CPU's; the cost of deterministic mode (step ms with and without it,
   A B B A) and the card's busy share over 3 traced steps; (b)
   ``fail_at=10`` then ``resume``: losses 10–19 equal (a)'s bit for bit;
   (c) 2 full-width steps at ``accum_steps=2`` with compression, sequences
   of 128, 4 a step, each from the CPU's state: loss within 1e-5 and
   grad_norm within 1e-3 of the CPU's; (d) B4 refuses q, k, v that require
   grad; (e) ``launch/cluster_dryrun.run`` at n = 2¹⁷ with its byte and
   time model; (f) every module of ``repro_torch.examples`` on the card;
11. summary: a ``training`` and a ``tuning`` JSON line, the card line, a
   ``kernels`` JSON line
   (B1, B2, B3 as the fused kernel and as the window mode, B4, the
   agreement kernel with its route, replicas and both bounds; B1 also on
   the agreement graphs, B4 also at head dims 80 and 160; B1's and B2's
   main-path rows also with their launches on the dedup path and the
   tuned winner beside the default; B3's with its launches and its check
   in the training launcher's dedup stage), and last
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package, and exits non-zero with no
result when no CUDA device is available.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels.measure import (  # noqa: E402
    AgBaseline, B4_LARGE_O_SHAPE, B4_SHAPES, B4_TOL, Baseline, FaBaseline,
    abba_ms, agreement_bytes_and_ops, b4_bounds, b4_large_output_check,
    b4_large_output_inputs, bound_ms, bytes_and_ops, card_line,
    device_events, device_ms, fmt_ms, kernel_inputs, MpBaseline,
    mis_pivot_bytes_and_ops, mis_pivot_inputs, window_rows)

SOURCE = "src/repro_torch/kernels/csrc/neighbor_min.cu"
REPLACES = {
    "neighbor_min_ell_batch": "src/repro/kernels/neighbor_min.py:97",
    "label_agree_ell_batch": "src/repro/kernels/neighbor_min.py:156",
    "neighbor_min_ell": "src/repro/kernels/neighbor_min.py:49",
}
B3_SOURCE = "src/repro_torch/kernels/csrc/mis_pivot.cu"
# B3's TPU kernel and the round loop around it, which the fused kernel
# replaces together.
B3_REPLACES = "src/repro/kernels/neighbor_min.py:49"
# Fused per-graph PIVOT shapes of phase 3, (graph, n, λ, k): random
# λ-arboric graphs under the degree cap 12·λ at the per-graph sizes, one
# above a block's shared memory (the grid route by size), a star whose hub
# of degree n - 1 the cap leaves out, and one sample.
# B3's window mode replaces Algorithm 1's _run_window, one jitted
# while_loop a window on the TPU.
B3_WINDOW_REPLACES = "src/repro/core/phases.py:96-119"
# Window-mode shapes of phase 3: n on the block route and on the grid
# route (one above a block's shared memory), λ = 2.
B3_WINDOW_NS = (4096, 32768, 60000)
B3_SHAPES = [("arboric", 64, 2, 3), ("arboric", 4096, 2, 3),
             ("arboric", 32768, 2, 3), ("arboric", 60000, 2, 3),
             ("star", 32768, 1, 3), ("arboric", 4096, 2, 1)]
AG_SOURCE = "src/repro_torch/kernels/csrc/agreement.cu"
# Not a Pallas kernel: the agreement pass of the reference's precluster
# rounds body, which XLA runs as ops; the kernel takes its place.
AG_REPLACES = "src/repro/core/programs.py:187"
B4_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
B4_REPLACES = "src/repro/kernels/flash_attention.py:90"
# The same-run A/B against --b4-baseline covers the B4 shapes from here up,
# at the head dims every earlier source builds.
B4_AB_MIN_S = 512
B4_AB_HEAD_DIMS = (16, 32, 64, 128)
# LM serving against the same model on the CPU: prefill logits after 30
# f32 layers summed in another order; decode logits after steps whose
# keys and values went through bf16 caches, where one value rounded to the
# other side of a bf16 unit moves a logit by ~1e-2.
PREFILL_TOL = 1e-3
DECODE_TOL = 5e-2
SERVE_CACHE_LEN = 2048          # smollm-135m's published context
# ELL kernel shapes (B, R, W) of phase 3, covering every route of the
# launch plan (``neighbor_min.launch_plan``); ``neighbor_min_ell`` runs on
# graph 0 of each, (R, W).
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
    (3, 999, 7),         # odd W: l2 route (int32 loads), one graph too
    (1, 60000, 8),       # state above a block's 227 KB: l2 route
]
# Shapes of the same-run A/B against a baseline kernel source (--baseline):
# the main path's largest bucket at its three narrow widths, the R = 2^15
# bucket, the wide shape and the one-graph form's largest shape of the
# earlier per-graph path, (n, W) = (32312, 18).
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
        """(kernel, plain, baseline kernel or None) per wrapper;
        ``neighbor_min_ell`` gets graph 0."""
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

    def run(self, B, R, W, rng, timed=True, ab=False, names=tuple(REPLACES)):
        """Check (and time) each named kernel at one (B, R, W);
        ``neighbor_min_ell`` gets graph 0."""
        inputs = kernel_inputs(B, R, W, rng, self.dev)
        rows = self.check(self.pairs(*inputs, names=names), (B, R, W), timed,
                          ab)
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


    def large_output(self, rng):
        """bf16 outputs in [4.5, 7.5] (``measure.B4_LARGE_O_SHAPE``), where
        one bf16 unit is 2^-5: B4 held within 2e-2 of the plain version's
        f32 output; with a baseline, its error printed beside."""
        shape = B4_LARGE_O_SHAPE
        q, k, v, want = b4_large_output_inputs(shape, rng, self.dev)
        got = self.fa.flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        err, low = b4_large_output_check(got, want, shape)
        row = {"shape": list(shape), "max_abs_err": err, "min_abs_out": low}
        if self.baseline is not None:
            row["baseline_err"] = float(
                (self.baseline(q, k, v).float() - want).abs().max())
        print(f"  flash_attention {str(tuple(shape)):48s} |o| >= "
              f"{row['min_abs_out']:.3g}: err {err:.3g} against the f32 "
              f"plain output" + (f", baseline err {row['baseline_err']:.3g}"
                                 if "baseline_err" in row else ""))
        self.max_err["bfloat16"] = max(self.max_err["bfloat16"], err)
        del q, k, v, want, got
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


class MisBench:
    """Holds kernel B3 (``mis_pivot``) and its window mode to their plain
    versions on every route that takes a shape and times the route the
    plan picks; with an :class:`MpBaseline`, also times an earlier
    ``mis_pivot.cu`` on the same inputs, A B B A."""

    def __init__(self, mp, ref, ptxas, baseline=None):
        self.mp, self.ref = mp, ref
        self.ptxas = {r["function"]: r for r in ptxas}
        self.baseline = baseline
        self.max_err = 0

    def _row(self, plan, shape, routes, nbytes_ops, instance):
        bms, by = bound_ms(*nbytes_ops)
        regs = self.ptxas.get(f"{instance}_{plan.route}", {})
        return {"shape": shape, "variant": plan.route,
                "threads": plan.threads, "blocks": plan.blocks,
                "equal_on": routes, "bound_ms": bms, "bound_by": by,
                "registers": regs.get("registers"),
                "spill_bytes": regs.get("spill_stores", 0)
                + regs.get("spill_loads", 0) if regs else None}

    def run_window(self, g, ranks, status, lo, hi, timed=True):
        """B3's window mode from ``status`` over ``[lo, hi)``: the row and
        the plain version's (status, rounds)."""
        mp, ref = self.mp, self.ref
        n = g.n
        args = (g.row_offsets, g.dst, ranks, status, lo, hi)
        want = ref.mis_window_ref(*args)
        routes = []
        for plan in (mp.block_plan(1, n), mp.grid_plan(1, n)):
            if plan is None:
                continue
            got = mp.mis_window_csr(*args, plan=plan)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"mis_window ({plan.route} route) "
                                     f"differs from its plain version at "
                                     f"n = {n}, [{lo}, {hi})")
            routes.append(plan.route)
        plan = mp.mis_launch_plan(1, n)
        row = self._row(plan, [n, g.dst.numel(), lo, hi], routes,
                        mis_pivot_bytes_and_ops(
                            n, g.dst.numel(), 1,
                            window=window_rows(g, ranks, status, lo, hi)),
                        "mis_window")
        row["rounds"] = int(want[1][0])
        if timed:
            def kernel():
                return mp.mis_window_csr(*args)

            def plain():
                return ref.mis_window_ref(*args)
            row["call_ms"] = time_ms(kernel)
            row["ms"] = device_ms(kernel)
            row["plain_ms"] = device_ms(plain, calls=3)
        return row, want

    def run(self, g, ranks, eligible, timed=True):
        mp, ref = self.mp, self.ref
        k, n = ranks.shape
        args = (g.row_offsets, g.dst, ranks, eligible)
        want = ref.mis_pivot_ref(*args)
        routes = []
        for plan in (mp.block_plan(k, n), mp.grid_plan(k, n)):
            if plan is None:
                continue
            got = mp.mis_pivot_csr(*args, plan=plan)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                if a.numel():
                    self.max_err = max(self.max_err, int(
                        (a.long() - b.long()).abs().max()))
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"mis_pivot ({plan.route} route) "
                                     f"differs from its plain version at "
                                     f"(k, n, 2m) = {(k, n, g.dst.numel())}")
            routes.append(plan.route)
        plan = mp.mis_launch_plan(k, n)
        row = self._row(plan, [k, n, g.dst.numel()], routes,
                        mis_pivot_bytes_and_ops(n, g.dst.numel(), k),
                        "mis_pivot")
        row["rounds"] = want[2].tolist()
        if timed:
            def kernel():
                return mp.mis_pivot_csr(*args)

            def plain():
                return ref.mis_pivot_ref(*args)
            row["call_ms"] = time_ms(kernel)
            row["ms"] = device_ms(kernel)
            row["plain_ms"] = device_ms(plain, calls=3)
            if self.baseline is not None:
                got = self.baseline(*args)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError("the B3 baseline differs from the "
                                         "plain version")
                row["ab_ms"], row["baseline_ms"] = abba_ms(
                    [kernel, lambda: self.baseline(*args)])
        return row


def print_b3_row(row, name="mis_pivot (k, n, 2m)"):
    line = (f"  {name} {str(tuple(row['shape'])):22s} "
            f"{row['variant']:5s} ({row['threads']} threads x "
            f"{row['blocks']} blocks; {row['registers']} registers, spill "
            f"{row['spill_bytes']} B) equal on {'+'.join(row['equal_on'])};"
            f" rounds {row['rounds']}; device ms: kernel "
            f"{fmt_ms(row.get('ms'))}, plain {fmt_ms(row.get('plain_ms'))}, "
            f"bound {row['bound_ms']:.4f} ({row['bound_by']}); per call back "
            f"to back: kernel {fmt_ms(row.get('call_ms'))}")
    if "baseline_ms" in row:
        line += (f"; A/B (ABBA) kernel {fmt_ms(row['ab_ms'])} vs baseline "
                 f"{fmt_ms(row['baseline_ms'])}")
    if "host_loop_ms" in row:
        line += (f"; the earlier host loop on the same ranks: device "
                 f"{fmt_ms(row['host_loop_ms'])}, per call "
                 f"{fmt_ms(row['host_loop_call_ms'])}")
    print(line)


def b3_window_rows(b3bench, rng, dev):
    """B3's window mode at ``B3_WINDOW_NS`` on three windows each: the
    upper half of the ranks from scratch (its winners remove undecided
    vertices below it, which must happen), an empty window after it, and
    [0, n) from scratch; each on every route that takes the shape, equal
    to the plain version, timed on the planned route."""
    rows = []
    for n in B3_WINDOW_NS:
        g, ranks, _ = mis_pivot_inputs(n, 1, 2, rng, dev)
        ranks = ranks[0]
        zeros = torch.zeros(n, dtype=torch.int32, device=dev)
        row, (after, _) = b3bench.run_window(g, ranks, zeros, n // 2, n)
        hit = int(((after == 2) & (ranks < n // 2)).sum())
        if hit == 0:
            raise AssertionError("the upper-half window removed no vertex "
                                 "below it")
        row["hit_outside"] = hit
        rows.append(row)
        rows.append(b3bench.run_window(g, ranks, after, n // 4, n // 4)[0])
        rows.append(b3bench.run_window(g, ranks, zeros, 0, n)[0])
        for r in rows[-3:]:
            print_b3_row(r, "mis_window (n, 2m, lo, hi)")
        torch.cuda.empty_cache()
    return rows


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
    from repro_torch.core.degree_cap import high_degree
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

    # One pass (the kernels' libraries are loaded by phase 3); the cold
    # pass of earlier slices was cut to make room for phases 8 and 9.
    nm.reset_launch_counts()
    (warm, stats), warm_s = drive()
    batch_launches = dict(nm.launches)
    print(f"  pass {warm_s:.3f} s = {len(graphs) / warm_s:.1f} graphs/s  "
          f"[{card}]")
    print(f"  launches in the pass: {batch_launches}")
    if dev.type == "cuda":
        for name in ("neighbor_min_ell_batch", "label_agree_ell_batch"):
            if batch_launches[name] <= 0:
                raise AssertionError(f"(a) the main path never launched {name}")
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
        eligible = ~high_degree(g, lams[gi])[0].cpu().numpy()
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
    record = {
        "graphs": len(graphs), "warm_s": warm_s,
        "graphs_per_s": len(graphs) / warm_s,
        "rounds_p50": float(np.median(depth)), "rounds_max": int(depth.max()),
        "buckets": [list(x) for x in stats.bucket_shapes],
        "launches": batch_launches,
        "per_graph": per_graph_phase(graphs, keys, lams, warm, per_graph,
                                     dev, card)}
    return {"record": record, "stats": stats, "per_graph": per_graph,
            "keys": keys}


def host_loop_cluster(g, key, lam, num_samples):
    """Per-graph ``correlation_cluster(method='pivot')`` as the port ran it
    before B3 was fused: per sample its own rank draw, the MIS one round a
    host iteration (``mis._greedy_mis_host_loop``: the ELL neighbour-min,
    the removal and a blocking test), the capture and the copies to the
    host; the same cost and first-minimum selection. Returns (cost, labels,
    depth, picked)."""
    from repro_torch.core import api, mis
    from repro_torch.core.cost import clustering_cost
    from repro_torch.core.degree_cap import high_degree

    best = None
    own = torch.arange(g.n, dtype=torch.int32, device=g.device)
    for i, k in enumerate(api.sample_keys(key, num_samples)):
        high = high_degree(g, lam)[0]
        ranks = mis.random_permutation_ranks(g.n, k, device=g.device)
        state = mis._greedy_mis_host_loop(g, ranks, eligible=~high)
        in_mis = state.status == mis.IN_MIS
        labels = mis.assign_to_min_rank_mis_neighbor(g, ranks, in_mis)
        labels = torch.where(~high, labels, own).cpu().numpy()
        in_mis.cpu().numpy(), high.cpu().numpy()
        cost = clustering_cost(g, labels)
        if best is None or cost < best[0]:
            best = (cost, labels, state.rounds, i)
    return best


def host_loop_capture(g, ranks, eligible):
    """The MIS and capture of each sample's ranks by the earlier host loop:
    (labels, rounds) per sample, for B3's A/B on the same inputs."""
    from repro_torch.core import mis

    out = []
    own = torch.arange(g.n, dtype=torch.int32, device=g.device)
    for r in ranks:
        state = mis._greedy_mis_host_loop(g, r, eligible=eligible)
        labels = mis.assign_to_min_rank_mis_neighbor(
            g, r, state.status == mis.IN_MIS)
        out.append((torch.where(eligible, labels, own), state.rounds))
    return out


def count_syncs(fn):
    """Blocking host syncs ``fn`` makes, as PyTorch's sync debug mode
    reports them (copies to the host, ``.item()``, ``nonzero``, ...)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


# Functions of the per-graph path, for its host-time split.
PER_GRAPH_LAYERS = ("correlation_cluster", "_pivot_samples",
                    "permutation_batch", "mis_pivot_csr", "clustering_cost")


def per_graph_phase(graphs, keys, lams, warm, idx, dev, card):
    """(d) Per-graph ``correlation_cluster`` on the graphs ``idx``, its
    counts zeroed just before and read just after, against the batch
    path's results ``warm`` and against the earlier host-loop path on the
    same graphs (walls in turns A B B A); its host split, device events,
    blocking syncs and the card's busy share."""
    import cProfile
    import pstats

    from repro_torch.core import api
    from repro_torch.kernels import mis_pivot as mp
    from repro_torch.kernels import neighbor_min as nm

    def fused():
        return [api.correlation_cluster(graphs[gi], key=keys[gi],
                                        lam=lams[gi], num_samples=3,
                                        device=dev) for gi in idx]

    def host_loop():
        return [host_loop_cluster(graphs[gi], keys[gi], lams[gi], 3)
                for gi in idx]

    def timed(fn):
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        return out, time.perf_counter() - t0

    nm.reset_launch_counts()
    mp.reset_launch_counts()
    out, wall = timed(fused)
    launches = {**nm.launches, **mp.launches}
    for gi, single in zip(idx, out):
        res = warm[gi]
        if not ((single.labels == res.labels).all()
                and single.cost == res.cost
                and single.info["picked_sample"] == res.info["picked_sample"]
                and single.info["depth"] == res.info["depth"]):
            raise AssertionError(f"(d) graph {gi}: per-graph path differs "
                                 "from the batch path")
    if dev.type == "cuda" and (launches["mis_pivot"] != len(idx)
                               or launches["neighbor_min_ell"] != 0):
        raise AssertionError(f"(d) {len(idx)} graphs launched {launches}: "
                             "B3 once a graph and no ELL kernel expected")
    for gi, single, old in zip(idx, out, host_loop()):
        cost, labels, depth, picked = old
        if not ((labels == single.labels).all() and cost == single.cost
                and picked == single.info["picked_sample"]
                and depth == single.info["depth"]):
            raise AssertionError(f"(d) graph {gi}: the host-loop path "
                                 "differs from the fused one")
    print(f"  (d) {len(idx)} graphs equal the batch path through per-graph "
          f"correlation_cluster ({wall:.3f} s) and the earlier host loop; "
          f"launches {launches}  [{card}]")
    walls = {"fused": [], "host_loop": []}
    for name in ("fused", "host_loop", "host_loop", "fused"):
        walls[name].append(timed(fused if name == "fused" else host_loop)[1])
    print(f"      wall A B B A, fused {walls['fused'][0]:.3f} / "
          f"{walls['fused'][1]:.3f} s, host loop {walls['host_loop'][0]:.3f}"
          f" / {walls['host_loop'][1]:.3f} s  [{card}]")
    prof = cProfile.Profile()
    sync(dev)
    prof.runcall(fused)
    sync(dev)
    split = {name: 0.0 for name in PER_GRAPH_LAYERS}
    for (path, _, func), (_, _, _, cum, _) in pstats.Stats(prof).stats.items():
        if "repro_torch" in path and func in split:
            split[func] += cum / len(idx) * 1e3
    print("      host ms per graph under cProfile: " + ", ".join(
        f"{k} {v:.3f}" for k, v in split.items()))
    record = {"graphs": len(idx), "wall_s": wall, "walls_abba_s": walls,
              "launches": launches, "host_ms_per_graph": split}
    if dev.type != "cuda":
        return record
    for name, fn in (("fused", fused), ("host_loop", host_loop)):
        t0 = time.perf_counter()
        events = device_events(fn)
        traced = time.perf_counter() - t0
        syncs = count_syncs(fn)
        busy = sum(us for _, us in events) / 1e6 if events else None
        record[name] = {
            "device_events_per_graph": len(events or []) / len(idx),
            "syncs_per_graph": syncs / len(idx), "traced_wall_s": traced,
            "device_busy_s": busy}
        print(f"      {name}: {len(events or []) / len(idx):.1f} device "
              f"events and {syncs / len(idx):.2f} blocking syncs per graph; "
              + ("device busy not measured" if busy is None else
                 f"device busy {busy * 1e3:.3f} ms of {traced * 1e3:.1f} ms"
                 f" traced wall ({100 * busy / traced:.2f} %)")
              + f"  [{card}]")
    return record


# Layers of the batch path, by function, for the host-time breakdown.
LAYERS = ("correlation_cluster_batch", "plan_graph", "pack_bucket",
          "permutation_batch", "_scatter_ell", "_launch",
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
        def wrapped(ell, *state, **kw):
            kept = self.args.get(name)
            if kept is None or ell.numel() > kept[0].numel():
                self.args[name] = [t.clone() for t in (ell, *state)]
            return fn(ell, *state, **kw)
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


# Serving layer of the clustering path: the traffic of phase 5.
SERVE_MAX_BATCH = 64
SERVE_MAX_WAIT = 0.02        # seconds an admitted request may wait
SERVE_SUBSET = 256           # requests of the minmax and sharded engines
SERVE_CPU_CHECKS = 64
# Layers of a serving pass, by function, for its host-time split.
SERVE_LAYERS = ("admit", "plan_graph", "graph_fingerprint",
                "build_packed_rows", "permutation_batch", "_execute",
                "pack_bucket", "_launch", "_harvest")


def serving_trace(graphs, lams, rng):
    """One arrival trace over the workload: every graph once, 25 % of them
    as precluster requests, keyed by index, plus exact repeats (same graph,
    key and method) of 20 % of them at later random positions."""
    rows = [(gi, "precluster" if rng.random() < 0.25 else "pivot")
            for gi in range(len(graphs))]
    for gi in rng.choice(len(graphs), len(graphs) // 5, replace=False):
        pos = int(rng.integers(int(gi) + 1, len(rows) + 1))
        rows.insert(pos, rows[[r[0] for r in rows].index(int(gi))])
    return rows


def agreement_plans(ag, B, R, W, replicas):
    """Every plan the agreement kernel's launch plan can pick at this shape,
    by route: the warp route, and the smem route where it can run."""
    plans = {"warp": ag.warp_plan(B, R, W, replicas)}
    smem = ag.smem_plan(B, R, W, replicas)
    if smem is not None:
        plans["smem"] = smem
    return plans


def precluster_kernel_rows(bench, graphs, lams, dev, card, ag_base=None):
    """The precluster agreement pass and B1 on its output, at three buckets
    of the workload under ``method='precluster'``, k = 3: the one packing
    the most ELL, the R = 2^15 one, and the one packing the most ELL at
    W <= 16 (λ = 1 graphs, where edges agree: at λ >= 2 almost none do).
    The agreement kernel on every route its launch plan can pick, at
    ``replicas`` 3 (the rounds body's call: one pass a graph) and 1 (every
    entry), ``torch.equal`` to the plain version, each with its device
    time and both bounds; its peak device memory at replicas 3 and the
    plain version's; with ``ag_base`` (an earlier ``agreement.cu``) that
    kernel against this one at replicas 1, A B B A; their share of the
    bucket program. B1 with the first hop's state as its ranks and the
    eligibility row as its active mask, on the route its launch plan picks
    and on the other one where that can run, each ``torch.equal`` to the
    plain version."""
    from repro_torch.core import api, plan as tplan, programs
    from repro_torch.core import rng as trng
    from repro_torch.kernels import agreement as ag
    from repro_torch.kernels import neighbor_min as nm
    from repro_torch.kernels import ref
    from repro_torch.util import next_pow2

    plans = [tplan.plan_graph(g, method="precluster", lam=lam)
             for g, lam in zip(graphs, lams)]
    buckets: dict = {}
    for gi, p in enumerate(plans):
        buckets.setdefault(p.bucket, []).append(gi)

    def size(b):
        return b[0] * b[1] * next_pow2(len(buckets[b]))

    picks = {"largest": max(buckets, key=size),
             "R=2^15": max((b for b in buckets if b[0] == 1 << 15),
                           key=size),
             "largest W<=16": max((b for b in buckets if b[1] <= 16),
                                  key=size)}
    rows = {}

    def peak(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    k = 3
    for tag, bucket in picks.items():
        members = buckets[bucket]
        ell, ranks, elig, m_edges, _ = tplan.pack_bucket(
            [plans[gi] for gi in members],
            [api.sample_keys(trng.PRNGKey(gi), k) for gi in members], k=k)
        ell, ranks, elig, m_edges = (torch.from_numpy(a).to(dev) for a in
                                     (ell, ranks, elig, m_edges))
        B, R, W = ell.shape
        want, plain_peak = peak(lambda: ref.agreement_ell_ref(ell))
        if not torch.equal(ref.agreement_ell_ref(ell, replicas=k), want):
            raise AssertionError(f"the {tag} bucket's groups do not carry "
                                 "one ELL each")
        agree_ell, kernel_peak = peak(
            lambda: ag.agreement_ell_batch(ell, replicas=k))
        if kernel_peak > 4 * ell.numel() + 4 * (B // k) * R:
            raise AssertionError(f"the agreement kernel's peak memory "
                                 f"{kernel_peak} B exceeds its output and a "
                                 f"(B/k, R) scratch at {B, R, W}")
        # Every route at replicas k and 1, each equal to the plain version.
        by_route: dict = {}
        for rep in (k, 1):
            for route, plan in agreement_plans(ag, B, R, W, rep).items():
                def fn(plan=plan, rep=rep):
                    return ag.agreement_ell_batch(ell, replicas=rep,
                                                  plan=plan)
                if not torch.equal(fn(), want):
                    raise AssertionError(
                        f"the agreement kernel ({route} route, replicas "
                        f"{rep}) differs from its plain version at the "
                        f"{tag} bucket {B, R, W}")
                by_route[f"{route}/{rep}"] = device_ms(fn)
        chosen = {rep: ag.agreement_launch_plan(B, R, W, rep)
                  for rep in (k, 1)}
        bounds = {rep: bound_ms(*agreement_bytes_and_ops(ell, rep))
                  for rep in (k, 1)}
        plain_ms = time_ms(lambda: ref.agreement_ell_ref(ell, replicas=k),
                           calls=1, samples=3)
        program_ms = time_ms(lambda: programs.bucket_impl(
            ell, ranks, elig, m_edges, k=k, program="precluster"), calls=1,
            samples=3)
        ag_row = {
            "shape": [B, R, W], "equal": True, "replicas": k,
            "route": chosen[k].route, "bound_ms": bounds[k][0],
            "bound_by": bounds[k][1], "bound_ms_replicas_1": bounds[1][0],
            "call_ms": time_ms(lambda: ag.agreement_ell_batch(
                ell, replicas=k)),
            "ms": by_route[f"{chosen[k].route}/{k}"],
            "ms_replicas_1": by_route[f"{chosen[1].route}/1"],
            "route_replicas_1": chosen[1].route, "ms_by_route": by_route,
            "plain_call_ms": plain_ms, "peak_bytes": kernel_peak,
            "plain_peak_bytes": plain_peak, "program_ms": program_ms,
            "variant": f"{chosen[k].route} route, replicas {k}, "
                       f"{chosen[k].blocks} blocks of {chosen[k].threads}"}
        ag_row["plain_ms"] = device_ms(
            lambda: ref.agreement_ell_ref(ell, replicas=k), calls=1)
        if ag_base is not None:
            if not torch.equal(ag_base(ell), want):
                raise AssertionError(f"the agreement baseline differs from "
                                     f"the plain version at {B, R, W}")
            # Two builds: a profiler session each, A B B A.
            ag_row["ab_ms"], ag_row["baseline_ms"] = abba_ms(
                [lambda: ag.agreement_ell_batch(ell), lambda: ag_base(ell)])
        state = torch.where(elig[:, :R], ranks[:, :R], nm.INF)
        state_p = torch.cat([state, state.new_full((B, 1), nm.INF)], 1)
        want_b1 = ref.neighbor_min_ref(agree_ell, state_p, elig)
        routes = []
        for plan in (nm.launch_plan(B, R, W, R + 1), nm.l2_plan(B, R, W),
                     nm.staged_plan(B, R, W, R + 1)):
            if dev.type != "cuda" or plan is None or plan.route in routes:
                continue
            out = nm.neighbor_min_ell_batch(agree_ell, state_p, elig,
                                            plan=plan)
            torch.cuda.synchronize()
            if not torch.equal(out, want_b1):
                raise AssertionError(f"B1 ({plan.route} route) differs from "
                                     f"its plain version on the {tag} "
                                     f"precluster agreement graph {B, R, W}")
            routes.append(plan.route)
        row = bench.check(bench.pairs(agree_ell, state_p, elig, None,
                                      names=B1_B2[:1]), (B, R, W))[B1_B2[0]]
        kept = float((agree_ell != R).sum()) / max(1, int((ell != R).sum()))
        row.update(bucket=tag, equal_on=routes, kept_edge_share=kept,
                   agreement=ag_row)
        rows[tag] = row
        print_row(f"B1 agree_ell {tag}", row)
        print(f"    equal on {'+'.join(routes)}; "
              f"{100 * kept:.4f} % of the ELL's edges agree")
        base = "" if ag_base is None else (
            f"; A B B A at replicas 1: kernel {fmt_ms(ag_row['ab_ms'])}, "
            f"baseline {fmt_ms(ag_row['baseline_ms'])}")
        print(f"  agreement {str((B, R, W)):28s} equal on every route at "
              f"replicas {k} and 1; device ms: kernel "
              f"{fmt_ms(ag_row['ms'])} ({ag_row['variant']}), replicas 1 "
              f"{fmt_ms(ag_row['ms_replicas_1'])} ({chosen[1].route}), by "
              f"route/replicas " + ", ".join(
                  f"{name} {fmt_ms(t)}" for name, t in by_route.items())
              + f"; bound {bounds[k][0]:.4f} ({bounds[k][1]}), replicas 1 "
              f"{bounds[1][0]:.4f}; plain {fmt_ms(ag_row['plain_ms'])}"
              f"{base}; per call back to back: kernel "
              f"{fmt_ms(ag_row['call_ms'])}, plain {plain_ms:.3f}; peak "
              f"memory kernel {kernel_peak / 2**20:.1f} MiB, plain "
              f"{plain_peak / 2**20:.1f} MiB; the bucket program "
              f"{program_ms:.3f} ms per call  [{card}]")
        del ell, ranks, elig, m_edges, agree_ell, want, state, state_p
        torch.cuda.empty_cache()
    return rows


def _requests(rows, graphs, lams, pick=None):
    from repro_torch.core import rng as trng
    from repro_torch.serve import ClusterRequest

    idx = range(len(rows)) if pick is None else pick
    return [ClusterRequest(uid=i, graph=graphs[rows[i][0]],
                           key=trng.PRNGKey(rows[i][0]), lam=lams[rows[i][0]],
                           method=rows[i][1]) for i in idx]


def serve_pass(rows, graphs, lams, dev, pick=None, **engine):
    """Serve the trace (or the ``pick`` subset) through one fresh
    ``ClusterBatcher``; returns (retired by uid, engine, wall s)."""
    from repro_torch.serve import ClusterBatcher, serve_all

    eng = ClusterBatcher(max_batch=SERVE_MAX_BATCH, max_wait=SERVE_MAX_WAIT,
                         num_samples=3, device=dev, **engine)
    reqs = _requests(rows, graphs, lams, pick)
    sync(dev)
    t0 = time.perf_counter()
    out = serve_all(eng, reqs)
    sync(dev)
    wall = time.perf_counter() - t0
    eng.close()
    if sorted(r.uid for r in out) != sorted(r.uid for r in reqs):
        raise AssertionError(f"serving ({engine}) did not retire every "
                             "request exactly once")
    return {r.uid: r for r in out}, eng, wall


def check_served(out, rows, want, what):
    """Every retired result equals the batch path's for its graph, key,
    method and objective: labels, cost and info (picked sample, depth)."""
    for uid, req in out.items():
        ref_res = want[rows[uid]]
        res = req.result
        if not ((res.labels == ref_res.labels).all()
                and res.cost == ref_res.cost and res.info == ref_res.info):
            raise AssertionError(f"{what}: request {uid} (graph "
                                 f"{rows[uid][0]}, {rows[uid][1]}) differs "
                                 "from correlation_cluster_batch")


def batch_results(rows, graphs, lams, dev, objective, pick=None):
    """correlation_cluster_batch on the card per method over the trace's
    distinct (graph, method) pairs: {(graph, method): result}."""
    from repro_torch.core import batch
    from repro_torch.core import rng as trng

    pairs = sorted({rows[i] for i in (range(len(rows)) if pick is None
                                      else pick)})
    want = {}
    for method in ("pivot", "precluster"):
        gis = [gi for gi, m in pairs if m == method]
        res = batch.correlation_cluster_batch(
            [graphs[gi] for gi in gis], keys=[trng.PRNGKey(gi) for gi in gis],
            lams=[lams[gi] for gi in gis], method=method, num_samples=3,
            objective=objective, device=dev)
        want.update({(gi, method): r for gi, r in zip(gis, res)})
    return want


def check_against_host(out, rows, graphs, lams, n_checks, rng):
    """``n_checks`` retired requests against the CPU: pivot through the
    batch path on the CPU, precluster through the host oracle
    ``precluster_host`` on the picked sample's ranks; costs against the
    host disagreement count."""
    from repro_torch.core import api, batch, mis, plan as tplan, programs
    from repro_torch.core import rng as trng

    small = [uid for uid in sorted(out) if graphs[rows[uid][0]].n <= 4096]
    uids = rng.choice(small, n_checks, replace=False)
    for uid in uids:
        gi, method = rows[uid]
        g, res = graphs[gi].to(torch.device("cpu")), out[uid].result
        if method == "precluster":
            p = tplan.plan_graph(g, method="precluster", lam=lams[gi])
            key = api.sample_keys(trng.PRNGKey(gi), 3)[
                res.info["picked_sample"]]
            ranks = mis.random_permutation_ranks(g.n, key, device="cpu")
            labels, rounds = programs.precluster_host(
                g.n, p.canonical_edges, p.eligible, ranks.numpy())
            same = (labels == res.labels).all() and \
                rounds == res.info["depth"]
        else:
            cpu = batch.correlation_cluster_batch(
                [g], keys=[trng.PRNGKey(gi)], lams=[lams[gi]], method=method,
                num_samples=3, device="cpu")[0]
            same = (cpu.labels == res.labels).all() and cpu.info == res.info
        if not (same and res.cost == batch._cost_host(g, res.labels)):
            raise AssertionError(f"request {uid} (graph {gi}, {method}) "
                                 "differs from the CPU")
    return len(uids)


def submit_return(graphs, lams, dev, card):
    """``submit``'s return time against the flush's wall on the R = 2^15
    pivot bucket, async and sync executors."""
    from repro_torch.core import api, executor as ex, plan as tplan
    from repro_torch.core import rng as trng

    big = [gi for gi, g in enumerate(graphs) if g.n > 16384]
    plans = [tplan.plan_graph(graphs[gi], lam=lams[gi]) for gi in big]
    W = max(p.W for p in plans)
    plans = [tplan.promote_plan(p, 1 << 15, W) for p in plans]
    keys = [api.sample_keys(trng.PRNGKey(gi), 3) for gi in big]
    pool = tplan.BucketBufferPool(device=dev)
    out = {}
    for name in ("async", "sync", "sync", "async"):
        exe = ex.make_executor(name, device=dev)
        handle, _ = ex.pack_and_submit(plans, keys, 3, exe, pool=pool)
        handle.result()
        out.setdefault(name, []).append(
            {"returned_s": handle.returned_seconds,
             "wall_s": handle.wall_seconds})
        if hasattr(exe, "close"):
            exe.close()
    for name, passes in out.items():
        print(f"    {name} submit on ({len(plans) * 3}, 32768, {W}): "
              "returned after " + " / ".join(
                  f"{p['returned_s'] * 1e3:.3f}" for p in passes)
              + " ms of a " + " / ".join(
                  f"{p['wall_s'] * 1e3:.1f}" for p in passes)
              + f" ms flush  [{card}]")
    return out


def serving_phase(dev, card, seed, bench, ag_base=None):
    """The clustering serving layer on the card, at the main path's
    workload: the trace through ``serve_all`` and ``ClusterBatcher``, every
    result against the batch path and 64 against the CPU."""
    from repro_torch.core.graph import build_graph, random_arboric
    from repro_torch.kernels import agreement as ag
    from repro_torch.kernels import neighbor_min as nm

    rng = np.random.default_rng([seed, 6])
    graphs, lams = main_path_workload(rng, build_graph, random_arboric, dev)
    rows = serving_trace(graphs, lams, rng)
    n_pre = sum(m == "precluster" for _, m in rows)
    print(f"serving layer: {len(rows)} requests over {len(graphs)} graphs "
          f"({n_pre} precluster, {len(rows) - len(set(rows))} exact "
          f"repeats), k = 3, max_batch {SERVE_MAX_BATCH}, max_wait "
          f"{SERVE_MAX_WAIT} s")
    record = {"requests": len(rows), "precluster": n_pre,
              "repeats": len(rows) - len(set(rows))}
    record["agree_rows"] = precluster_kernel_rows(bench, graphs, lams, dev,
                                                  card, ag_base)
    want = batch_results(rows, graphs, lams, dev, "disagree")

    # The measured run: async executor, cost policy, counts zeroed just
    # before and read just after.
    nm.reset_launch_counts()
    ag.reset_launch_counts()
    out, eng, wall = serve_pass(rows, graphs, lams, dev, executor="async",
                                policy="cost")
    launches = {**nm.launches, **ag.launches}
    check_served(out, rows, want, "async/cost")
    for name in B1_B2 + ("agreement_ell_batch",):
        if dev.type == "cuda" and launches[name] <= 0:
            raise AssertionError(f"the serving path never launched {name}")
    walls = np.array(eng.stats.latency.samples("wall")) * 1e3
    st = eng.stats
    record.update(
        wall_s=wall, requests_per_s=len(rows) / wall, launches=launches,
        flushes=st.flushes, cache_hits=st.cache_hits,
        subscribed=st.subscribed, coalesced_flushes=st.coalesced_flushes,
        in_flight_peak=st.in_flight_peak,
        result_cache=eng.result_cache.info(),
        flush_ms_p50=float(np.percentile(walls, 50)),
        flush_ms_p99=float(np.percentile(walls, 99)))
    print(f"  (h) async/cost: {len(rows)} requests in {wall:.3f} s = "
          f"{len(rows) / wall:.1f} requests/s; {st.flushes} flushes, flush "
          f"wall p50 {record['flush_ms_p50']:.3f} ms p99 "
          f"{record['flush_ms_p99']:.3f} ms; {st.cache_hits} cache hits, "
          f"{st.subscribed} single-flight riders ("
          f"{st.result_cache.evictions} cache evictions), "
          f"{st.coalesced_flushes} "
          f"coalesced flushes, in flight at most {st.in_flight_peak}; "
          f"launches {launches}  [{card}]")
    print(f"      every result equals correlation_cluster_batch; "
          f"{check_against_host(out, rows, graphs, lams, SERVE_CPU_CHECKS, rng)}"
          f" equal the CPU (precluster against precluster_host)")
    # Async against sync on the same trace and policy, A B (the B A half
    # of earlier slices was cut to make room for phases 8 and 9, whose
    # phase 9 serves this trace four times on the sync executor); then the
    # coalescing policy on the sync executor.
    abba = {"async": [wall], "sync": []}
    for name in ("sync",):
        o, _, w = serve_pass(rows, graphs, lams, dev, executor=name,
                             policy="cost")
        check_served(o, rows, want, f"{name}/cost")
        abba[name].append(w)
    o, eng, w = serve_pass(rows, graphs, lams, dev, executor="sync",
                           policy="coalesce")
    check_served(o, rows, want, "sync/coalesce")
    rates = {name: [len(rows) / t for t in ts] for name, ts in abba.items()}
    record.update(walls_ab_s=abba, requests_per_s_ab=rates,
                  coalesce_sync_s=w,
                  coalesce_sync_requests_per_s=len(rows) / w,
                  coalesce_stolen=eng.stats.stolen_requests)
    print(f"      wall A B on the same trace (cost policy): async "
          f"{abba['async'][0]:.3f} s = {rates['async'][0]:.1f} requests/s, "
          f"sync {abba['sync'][0]:.3f} s = {rates['sync'][0]:.1f} "
          "requests/s; "
          f"sync/coalesce {w:.3f} s = {len(rows) / w:.1f} requests/s "
          f"({eng.stats.stolen_requests} stolen requests)  [{card}]")
    # The minmax objective and the sharded executor on a subset.
    pick = sorted(rng.choice(len(rows), SERVE_SUBSET, replace=False))
    want_mm = batch_results(rows, graphs, lams, dev, "minmax", pick)
    for name in ("async", "sharded"):
        o, eng, w = serve_pass(rows, graphs, lams, dev, pick=pick,
                               executor=name, policy="cost",
                               objective="minmax")
        check_served(o, rows, want_mm, f"{name}/minmax")
        record[f"minmax_{name}_s"] = w
        print(f"      minmax, {name} executor: {SERVE_SUBSET} requests in "
              f"{w:.3f} s, equal to the batch path  [{card}]")
    record["submit"] = submit_return(graphs, lams, dev, card)
    # Host seconds per layer of a sync pass over 512 requests (cProfile
    # sees the calling thread only, so the sync executor).
    import cProfile
    import pstats

    prof = cProfile.Profile()
    wall = time.perf_counter()
    prof.runcall(serve_pass, rows, graphs, lams, dev,
                 pick=range(min(512, len(rows))), executor="sync",
                 policy="cost")
    wall = time.perf_counter() - wall
    split = {name: 0.0 for name in SERVE_LAYERS}
    for (path, _, func), (_, _, _, cum, _) in pstats.Stats(prof).stats.items():
        if "repro_torch" in path and func in split:
            split[func] += cum
    record["host_s_512"] = {"wall_s": wall, **split}
    print(f"      sync pass over 512 requests under cProfile {wall:.3f} s; "
          "cumulative host s per layer: " + ", ".join(
              f"{k} {v:.3f}" for k, v in split.items()))
    # The card's busy share over a traced pass of the first 512 requests.
    t0 = time.perf_counter()
    events = device_events(lambda: serve_pass(
        rows, graphs, lams, dev, pick=range(min(512, len(rows))),
        executor="async", policy="cost"))
    traced = time.perf_counter() - t0
    if events is None:
        print("      device busy share: not measured (no device events)")
    else:
        busy = sum(us for _, us in events) / 1e6
        ell_ms = {name: sum(us for ev, us in events if key in ev) / 1e3
                  for name, key in zip(B1_B2, ("neighbor_min",
                                               "label_agree"))}
        record.update(traced_wall_s=traced, device_busy_s=busy,
                      traced_ell_ms=ell_ms)
        print(f"      traced pass over 512 requests: device busy "
              f"{busy:.3f} s of {traced:.3f} s ({100 * busy / traced:.1f} "
              f"%), B1 {ell_ms[B1_B2[0]]:.3f} ms, B2 "
              f"{ell_ms[B1_B2[1]]:.3f} ms  [{card}]")
    del graphs
    torch.cuda.empty_cache()
    return record


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
        "wasted_slot_steps": st.wasted_slot_steps, "launches": launches,
        # B4's launches by (dtype, head dim) instance, for the kernels line.
        "b4_instance_launches": {f"{d}/{h}": n for (d, h), n in
                                 fa.instance_launches.items()}}
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


# The paper's algorithms (phase 7): pivot_phased on random λ-arboric
# graphs (n, λ), as a caller of single requests sends them; lam=None above
# the 200,000-vertex cut of the exact degeneracy; forests; disjoint cliques
# of 1-12 vertices with noise edges between them.
PAPER_GRAPHS = [(4096, 1), (4096, 2), (4096, 3), (32768, 1), (32768, 2),
                (32768, 3), (4096, 2), (32768, 2)]
PAPER_ALG2_N = 32768
PAPER_LARGE_N = 262_144
PAPER_FOREST_N = 100_000
PAPER_CLIQUES = 8000


def _same_result(a, b) -> bool:
    return bool((a.labels == b.labels).all()) and (a.cost, a.method, a.info) \
        == (b.cost, b.method, b.info)


def _ledger_rows(ledger):
    import dataclasses

    return ([dataclasses.astuple(p) for p in ledger.phases],
            ledger.extra_rounds, ledger.total_rounds, ledger.summary())


def paper_phase(dev, card, seed, bench):
    """(7) The paper's other algorithms through ``correlation_cluster`` on
    ``dev``, each against the same call on the CPU: ``pivot_phased``
    (B3's window mode, its counts zeroed just before and read just after),
    ``algorithm1(subroutine='alg2')``, ``lam=None`` at 262,144 vertices,
    the edge-sharded engine on an NCCL group of world size 1 against the
    single-device engine (B3), the forest methods and ``cliques``. Returns
    the record, with B3's window-mode row timed on the phased path's
    first window of the alg2 graph."""
    from repro_torch.core import api, forest, phases
    from repro_torch.core.graph import (build_graph, disjoint_cliques,
                                        random_arboric, random_forest)
    from repro_torch.core.mis import random_permutation_ranks
    from repro_torch.core.rng import PRNGKey
    from repro_torch.kernels import mis_pivot as mp

    cpu = torch.device("cpu")
    rng = np.random.default_rng([seed, 7])
    rec: dict = {"walls_s": {}, "syncs": {}}

    def both(name, fn, count_sync=True):
        """fn(device) on dev (timed) and on the CPU; returns both results."""
        sync(dev)
        t0 = time.perf_counter()
        got = fn(dev)
        sync(dev)
        rec["walls_s"][name] = time.perf_counter() - t0
        if count_sync and dev.type == "cuda":
            rec["syncs"][name] = count_syncs(lambda: fn(dev))
        t0 = time.perf_counter()
        want = fn(cpu)
        rec["walls_s"][name + "_cpu"] = time.perf_counter() - t0
        return got, want

    # (a) pivot_phased, best-of-3, on 8 graphs.
    edges = [random_arboric(n, lam, rng)[0] for n, lam in PAPER_GRAPHS]

    def phased(device):
        gs = [build_graph(n, e, device=device)
              for (n, _), e in zip(PAPER_GRAPHS, edges)]
        mp.reset_launch_counts()
        out = [api.correlation_cluster(g, method="pivot_phased", lam=lam,
                                       key=PRNGKey(1000 + i), num_samples=3,
                                       device=device)
               for i, (g, (_, lam)) in enumerate(zip(gs, PAPER_GRAPHS))]
        return out, dict(mp.launches)

    (got, launches), (want, _) = both("pivot_phased", phased)
    for i, (a, b) in enumerate(zip(got, want)):
        if not _same_result(a, b):
            raise AssertionError(f"(7a) pivot_phased graph {i} differs on "
                                 f"{dev} from the CPU")
    if dev.type == "cuda" and (launches["mis_window"] == 0
                               or launches["mis_pivot"] != 0):
        raise AssertionError(f"(7a) pivot_phased launched {launches}: B3's "
                             "window mode (and not the fused PIVOT) expected")
    rec["pivot_phased"] = {
        "graphs": len(got), "launches": launches,
        "mpc_rounds": [r.info["mpc_rounds"] for r in got],
        "depth": [r.info["depth"] for r in got]}
    print(f"  (7a) pivot_phased, k = 3, on {len(got)} graphs (n, λ) "
          f"{PAPER_GRAPHS}: equal to the CPU (labels, cost, info with the "
          f"ledger); {rec['walls_s']['pivot_phased']:.3f} s on {dev.type}, "
          f"{rec['walls_s']['pivot_phased_cpu']:.3f} s on the CPU; launches "
          f"{launches}; blocking syncs {rec['syncs'].get('pivot_phased')}  "
          f"[{card}]")

    # (b) Algorithm 1 with Algorithm 2's chunks on one graph.
    e2 = random_arboric(PAPER_ALG2_N, 2, rng)[0]

    def alg2(device):
        g = build_graph(PAPER_ALG2_N, e2, device=device)
        ranks = random_permutation_ranks(PAPER_ALG2_N, PRNGKey(77),
                                         device=device)
        mp.reset_launch_counts()
        state, _, ledger = phases.algorithm1(g, ranks=ranks,
                                             subroutine="alg2")
        return state, ledger, dict(mp.launches)

    (s1, l1, launches), (s2, l2, _) = both("algorithm1_alg2", alg2)
    if not (torch.equal(s1.status.cpu(), s2.status) and s1.rounds ==
            s2.rounds and _ledger_rows(l1) == _ledger_rows(l2)):
        raise AssertionError("(7b) algorithm1(alg2) differs from the CPU")
    chunks = sum(p.chunks for p in l1.phases)
    rec["algorithm1_alg2"] = {"n": PAPER_ALG2_N, "chunks": chunks,
                              "launches": launches,
                              "ledger": l1.summary(), "rounds": s1.rounds}
    print(f"  (7b) algorithm1(alg2) at n = {PAPER_ALG2_N}: equal to the CPU "
          f"(status, rounds, ledger); {len(l1.phases)} phases, {chunks} "
          f"chunks, {l1.total_rounds} MPC rounds; "
          f"{rec['walls_s']['algorithm1_alg2']:.3f} s on {dev.type}, "
          f"{rec['walls_s']['algorithm1_alg2_cpu']:.3f} s on the CPU; "
          f"launches {launches}; blocking syncs "
          f"{rec['syncs'].get('algorithm1_alg2')}  [{card}]")
    if dev.type == "cuda":
        # B3's window mode at the shape the phased path gives it: the
        # first prefix of Algorithm 1 (alg3) on this graph, from scratch.
        g = build_graph(PAPER_ALG2_N, e2, device=dev)
        ranks = random_permutation_ranks(PAPER_ALG2_N, PRNGKey(77),
                                         device=dev)
        _, _, l3 = phases.algorithm1(g, ranks=ranks)
        hi = l3.phases[0].prefix_end
        row, _ = bench.run_window(g, ranks, torch.zeros_like(ranks), 0, hi)
        print_b3_row(row, "mis_window (n, 2m, lo, hi)")
        rec["window_row"] = row

    # (c) lam=None above the exact degeneracy's cut: the parallel peel.
    e3 = random_arboric(PAPER_LARGE_N, 2, rng)[0]
    got, want = both("lam_none", lambda d: api.correlation_cluster(
        build_graph(PAPER_LARGE_N, e3, device=d), key=PRNGKey(3),
        device=d))
    if not _same_result(got, want):
        raise AssertionError("(7c) lam=None at n = 262,144 differs from "
                             "the CPU")
    rec["lam_none"] = {"n": PAPER_LARGE_N,
                       "lambda_estimate": got.info["lambda_estimate"]}
    print(f"  (7c) correlation_cluster(lam=None) at n = {PAPER_LARGE_N}: "
          f"equal to the CPU, lambda_estimate "
          f"{got.info['lambda_estimate']}; "
          f"{rec['walls_s']['lam_none']:.3f} s on {dev.type}, "
          f"{rec['walls_s']['lam_none_cpu']:.3f} s on the CPU  [{card}]")

    # (d) The edge-sharded engine on a group of world size 1.
    rec["distributed"] = dist_world_one(dev, card, rng, rec)

    # (e) Forests: the exact and the (1 + ε) matchings.
    ef = random_forest(PAPER_FOREST_N, rng)

    def forests(device):
        g = build_graph(PAPER_FOREST_N, ef, device=device)
        partner, rounds = forest.augmenting_matching_parallel(g, PRNGKey(5))
        return ([api.correlation_cluster(g, method=m, key=PRNGKey(5),
                                         device=device)
                 for m in ("forest_exact", "forest_approx")],
                partner, rounds)

    (got, p1, r1), (want, p2, r2) = both("forests", forests,
                                         count_sync=False)
    if not ((p1 == p2).all() and r1 == r2
            and all(_same_result(a, b) for a, b in zip(got, want))):
        raise AssertionError("(7e) the forest methods differ from the CPU")
    ratio = got[1].cost / got[0].cost
    rec["forests"] = {"n": PAPER_FOREST_N, "exact_cost": got[0].cost,
                      "approx_cost": got[1].cost, "ratio": ratio,
                      "rounds": r1}
    print(f"  (7e) forest_exact / forest_approx at n = {PAPER_FOREST_N}: "
          f"equal to the CPU (partner, rounds {r1}, labels, info); cost "
          f"{got[0].cost} / {got[1].cost}, approx/exact {ratio:.6f}; "
          f"{rec['walls_s']['forests']:.3f} s on {dev.type}  [{card}]")

    # (f) Corollary 32 on disjoint cliques plus noise edges.
    sizes = rng.integers(1, 13, PAPER_CLIQUES)
    nc, ec = disjoint_cliques(sizes)
    noise = rng.integers(0, nc, (nc // 200, 2))
    ec = np.concatenate([ec, noise])
    got, want = both("cliques", lambda d: api.correlation_cluster(
        build_graph(nc, ec, device=d), method="cliques", device=d))
    if not _same_result(got, want):
        raise AssertionError("(7f) cliques differs from the CPU")
    rec["cliques"] = {"n": int(nc),
                      "clusters": int(len(np.unique(got.labels))),
                      "cost": got.cost}
    print(f"  (7f) cliques on {len(sizes)} disjoint cliques + {len(noise)} "
          f"noise edges (n = {nc}): equal to the CPU; cost {got.cost}; "
          f"{rec['walls_s']['cliques']:.3f} s on {dev.type}  [{card}]")
    return rec


def dist_world_one(dev, card, rng, rec):
    """(7d) ``distributed_pivot`` (raw and capped, packed and not) and
    ``correlation_cluster(distributed=True)`` on a group of world size 1
    (NCCL on the card, gloo on the CPU, over a ``FileStore`` in a temporary
    directory), each against the single-device engine: B3 on the same
    edge-masked graph and ranks, and the non-distributed call."""
    import datetime
    import os
    import tempfile

    import torch.distributed as dist

    from repro_torch.core import api, dist as tdist
    from repro_torch.core.degree_cap import degree_threshold
    from repro_torch.core.graph import build_graph, random_arboric
    from repro_torch.core.mis import random_permutation_ranks
    from repro_torch.core.rng import PRNGKey
    from repro_torch.kernels import mis_pivot as mp

    out = {"backend": "nccl" if dev.type == "cuda" else "gloo", "runs": []}
    with tempfile.TemporaryDirectory() as tmpd:
        dist.init_process_group(
            out["backend"], store=dist.FileStore(os.path.join(tmpd, "s"), 1),
            rank=0, world_size=1, timeout=datetime.timedelta(seconds=120))
        try:
            t0 = time.perf_counter()
            for n, lam in ((4096, 1), (32768, 2)):
                e = random_arboric(n, lam, rng)[0]
                g = build_graph(n, e, device=dev)
                ranks = random_permutation_ranks(n, PRNGKey(n), device=dev)
                high = (g.deg > degree_threshold(lam, 2.0)).cpu().numpy()
                own = np.arange(n)
                for capped in (False, True):
                    keep = ~(high[e[:, 0]] | high[e[:, 1]]) if capped \
                        else np.ones(len(e), bool)
                    gm = build_graph(n, e[keep], device=dev)
                    st, lab, rnd = mp.mis_pivot_csr(
                        gm.row_offsets, gm.dst, ranks[None].contiguous(),
                        torch.ones(n, dtype=torch.bool, device=dev))
                    want = (np.where(high & capped, own, lab[0].cpu().numpy()),
                            (st[0] == 1).cpu().numpy(), int(rnd[0]))
                    for packed in (False, True):
                        tdist.reset_stats()
                        got = api._distributed_capped(
                            g, ranks, high, packed=packed) if capped else \
                            tdist.distributed_pivot(g, ranks, packed=packed)
                        if not ((got[0] == want[0]).all()
                                and (got[1] == want[1]).all()
                                and got[2] == want[2]):
                            raise AssertionError(
                                f"(7d) distributed_pivot (n {n}, capped "
                                f"{capped}, packed {packed}) differs from "
                                "the single-device engine")
                        per_round = (tdist.stats["all_reduce_bytes"]
                                     - 4 * (n + 1)) / got[2]
                        out["runs"].append({
                            "n": n, "capped": capped, "packed": packed,
                            "rounds": got[2], "all_reduces":
                            tdist.stats["all_reduces"],
                            "all_reduce_bytes_per_round": per_round})
                for method in ("pivot", "pivot_raw"):
                    a, b = (api.correlation_cluster(
                        g, method=method, lam=lam, key=PRNGKey(n + 1),
                        num_samples=3, device=dev, distributed=d)
                        for d in (True, False))
                    if not _same_result(a, b):
                        raise AssertionError(f"(7d) {method} distributed "
                                             "differs from one device")
            rec["walls_s"]["distributed"] = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
    for r in out["runs"]:
        print(f"  (7d) distributed_pivot on {out['backend']}, world size 1, "
              f"n {r['n']}, capped {r['capped']}, packed {r['packed']}: "
              f"equal to B3; {r['rounds']} rounds, {r['all_reduces']} "
              f"all-reduces, {r['all_reduce_bytes_per_round']:.0f} bytes a "
              f"round  [{card}]")
    print(f"  (7d) correlation_cluster(distributed=True), pivot and "
          f"pivot_raw, k = 3: equal to one device; "
          f"{rec['walls_s']['distributed']:.3f} s in all  [{card}]")
    return out


# The near-duplicate dedup path (phase 8): the reference test's recipe
# (tests/test_data.py:29-36) at a corpus a pipeline stage runs; its
# quality, O(n²) host Python, on a smaller corpus of the same recipe.
DEDUP_DOCS = 20_000
DEDUP_QUALITY_DOCS = 2_000
DEDUP_RECIPE = dict(doc_len=(64, 256), dup_fraction=0.4, mutate_p=0.05)
DEDUP_THRESHOLD = 0.45
DEDUP_SAMPLES = 4
DEDUP_LIMITS = {"pairs_recall": 0.7, "pairs_precision": 0.9,
                "kept_fraction": 0.85}
# The card's busy share is traced over the clustering of this many shards
# (the profiler's per-event cost would make a trace of every shard take
# minutes).
DEDUP_TRACE_SHARDS = 128
# The stages of a dedup call, by the function of repro_torch.data.dedup
# that runs each; what none of them takes is the stitching.
DEDUP_STAGES = {"minhash_signatures": "MinHash",
                "similarity_edges": "similarity edges",
                "shard_similarity_graph": "sharding",
                "build_graph": "graph build",
                "correlation_cluster_batch": "clustering"}


class StageWalls:
    """Wraps the stage functions of the dedup module for one call and sums
    each one's wall (the device synchronised at its end); keeps the
    clustering call's arguments, so that it can be traced again alone."""

    def __init__(self, mod, dev):
        self.mod, self.dev = mod, dev
        self.walls = {name: 0.0 for name in DEDUP_STAGES}
        self.cluster_call = None

    def __enter__(self):
        self.saved = {name: getattr(self.mod, name) for name in DEDUP_STAGES}
        for name, fn in self.saved.items():
            setattr(self.mod, name, self._timed(name, fn))
        return self

    def _timed(self, name, fn):
        def wrapped(*args, **kw):
            if name == "correlation_cluster_batch":
                self.cluster_call = (fn, args, kw)
            t = time.perf_counter()
            out = fn(*args, **kw)
            sync(self.dev)
            self.walls[name] += time.perf_counter() - t
            return out
        return wrapped

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.mod, name, fn)


class SignatureMemo(StageWalls):
    """Keeps the MinHash signatures and similarity edges of the first call
    on a corpus for the later calls on it, which then time the sharding,
    graph build, clustering and stitching alone: the numpy stages are
    deterministic and held bit-equal to the reference by the CPU tests."""

    def __init__(self, mod):
        self.mod, self.memo = mod, {}

    def __enter__(self):
        names = ("minhash_signatures", "similarity_edges")
        self.saved = {name: getattr(self.mod, name) for name in names}
        for name, fn in self.saved.items():
            setattr(self.mod, name, self._kept(name, fn))
        return self

    def _kept(self, name, fn):
        def wrapped(first, **kw):
            key = (name, id(first), tuple(sorted(kw.items())))
            if key not in self.memo:
                self.memo[key] = (first, fn(first, **kw))
            return self.memo[key][1]
        return wrapped


def _same_dedup(a, b, what, info=True):
    if not (np.array_equal(a.labels, b.labels)
            and np.array_equal(a.keep, b.keep)
            and a.clustering.cost == b.clustering.cost
            and a.n_edges == b.n_edges
            and (not info or a.clustering.info == b.clustering.info)):
        raise AssertionError(f"(8) {what}")


def dedup_phase(dev, card, seed):
    """(8) The near-duplicate dedup path on ``dev``: MinHash → LSH
    similarity graph → one graph per component → the batch engine (B1, B2)
    and ``ClusterBatcher``, and the whole graph through the per-graph
    engine (B3) and the edge-sharded engine on a group of world size 1;
    each against the CPU or the call it must equal, launch counts zeroed
    just before each call and read just after; stage walls and the card's
    busy share over the clustering stage; quality on a smaller corpus."""
    import datetime
    import os
    import tempfile

    import torch.distributed as dist

    from repro_torch.data import dedup, synthetic
    from repro_torch.kernels import mis_pivot, neighbor_min as nm

    t_phase = time.perf_counter()
    corpus = synthetic.synthetic_corpus(n_docs=DEDUP_DOCS, seed=seed,
                                        **DEDUP_RECIPE)
    kw = dict(threshold=DEDUP_THRESHOLD, num_samples=DEDUP_SAMPLES,
              seed=seed)
    rec = {"docs": DEDUP_DOCS, "walls_s": {}, "launches": {}}

    def run(name, fn, device, **extra):
        nm.reset_launch_counts()
        mis_pivot.reset_launch_counts()
        sync(dev)
        t = time.perf_counter()
        out = fn(corpus, device=device, **kw, **extra)
        sync(dev)
        rec["walls_s"][name] = time.perf_counter() - t
        rec["launches"][name] = {**nm.launches, **mis_pivot.launches}
        return out

    def launched(name, kernels):
        if dev.type != "cuda":
            return
        for k in kernels:
            if rec["launches"][name][k] <= 0:
                raise AssertionError(f"(8) {name} never launched {k}")

    # (a) the batch engine, its stages timed, against the CPU. The later
    # calls reuse its signatures and edges (SignatureMemo).
    with SignatureMemo(dedup):
        with StageWalls(dedup, dev) as stages:
            batched = run("batched", dedup.dedup_corpus_batched, dev)
        launched("batched", B1_B2)
        walls = {DEDUP_STAGES[k]: v for k, v in stages.walls.items()}
        walls["stitching"] = rec["walls_s"]["batched"] - sum(walls.values())
        rec["stages_s"] = walls
        info = batched.clustering.info
        rec.update(edges=batched.n_edges, shards=info["n_shards"],
                   buckets=[list(b) for b in info["buckets"]],
                   kept=int(batched.keep.sum()), cost=batched.clustering.cost)
        print(f"  (8a) dedup_corpus_batched on {DEDUP_DOCS} documents: "
              f"{batched.n_edges} similarity edges, {info['n_shards']} "
              f"shards in {info['n_buckets']} buckets {info['buckets']}, "
              f"{rec['kept']} kept, cost {rec['cost']}; "
              f"{rec['walls_s']['batched']:.3f} s: "
              + ", ".join(f"{k} {v:.3f}" for k, v in walls.items())
              + f"; launches {rec['launches']['batched']}  [{card}]")
        # The card's busy share over the clustering of the first shards:
        # their device time (profiler) over the same call's untraced wall.
        fn, (graphs,), ckw = stages.cluster_call
        n = DEDUP_TRACE_SHARDS

        def window():
            return fn(graphs[:n], **{**ckw, "keys": ckw["keys"][:n]})

        sync(dev)
        t = time.perf_counter()
        window()
        sync(dev)
        window_s = time.perf_counter() - t
        events = device_events(window) if dev.type == "cuda" else None
        if events is None:
            print("       card busy share over the clustering stage: not "
                  "measured (no device events)")
        else:
            busy = sum(us for _, us in events) / 1e6
            rec.update(cluster_window_shards=n, cluster_window_s=window_s,
                       cluster_window_busy_s=busy,
                       cluster_window_events=len(events))
            print(f"       clustering of the first {n} shards: card busy "
                  f"{busy:.4f} s of its {window_s:.3f} s untraced wall "
                  f"({100 * busy / window_s:.2f} %), {len(events)} device "
                  f"events  [{card}]")
        cpu = run("batched_cpu", dedup.dedup_corpus_batched, "cpu")
        _same_dedup(batched, cpu, "batched on the card differs from the CPU")
        # (b) streaming through ClusterBatcher, against the batch engine.
        stream = run("streaming", dedup.dedup_corpus_streaming, dev,
                     max_batch=SERVE_MAX_BATCH)
        launched("streaming", B1_B2)
        _same_dedup(stream, batched, "streaming differs from batched",
                    info=False)
        sinfo = stream.clustering.info
        rec["streaming"] = {k: sinfo[k] for k in ("flushes", "padded_slots",
                                                  "cache_hits")}
        # (c) the whole graph through the per-graph engine (B3), against the
        # CPU; (d) the edge-sharded engine on a group of world size 1.
        per = run("per_graph", dedup.dedup_corpus, dev)
        launched("per_graph", ("mis_pivot",))
        _same_dedup(per, run("per_graph_cpu", dedup.dedup_corpus, "cpu"),
                    "per-graph on the card differs from the CPU")
        backend = "nccl" if dev.type == "cuda" else "gloo"
        with tempfile.TemporaryDirectory() as tmpd:
            dist.init_process_group(
                backend, store=dist.FileStore(os.path.join(tmpd, "s"), 1),
                rank=0, world_size=1, timeout=datetime.timedelta(seconds=120))
            try:
                sharded = run("distributed", dedup.dedup_corpus, dev,
                              distributed=True)
            finally:
                dist.destroy_process_group()
        _same_dedup(sharded, per, "distributed=True differs from "
                    "distributed=False", info=False)
    print(f"  (8b) dedup_corpus_streaming ({SERVE_MAX_BATCH} a flush): "
          f"{sinfo['flushes']} flushes, equal to batched; "
          f"{rec['walls_s']['streaming']:.3f} s, launches "
          f"{rec['launches']['streaming']}  [{card}]")
    print(f"  (8c) dedup_corpus, one graph of {DEDUP_DOCS} vertices: equal "
          f"to the CPU, cost {per.clustering.cost}; "
          f"{rec['walls_s']['per_graph']:.3f} s (CPU "
          f"{rec['walls_s']['per_graph_cpu']:.3f} s), launches "
          f"{rec['launches']['per_graph']}  [{card}]")
    print(f"  (8d) dedup_corpus(distributed=True), {backend} world size 1: "
          f"equal to distributed=False; "
          f"{rec['walls_s']['distributed']:.3f} s  [{card}]")
    print(f"       batched on the CPU {rec['walls_s']['batched_cpu']:.3f} s, "
          "equal to the card (the walls after (8a) reuse its signatures "
          "and edges)")
    # Quality on the smaller corpus, with the reference test's limits.
    small = synthetic.synthetic_corpus(n_docs=DEDUP_QUALITY_DOCS, seed=seed,
                                       **DEDUP_RECIPE)
    q = dedup.dedup_quality(dedup.dedup_corpus_batched(
        small, device=dev, **kw), small)
    rec["quality"] = q
    if not (q["pairs_recall"] > DEDUP_LIMITS["pairs_recall"]
            and q["pairs_precision"] > DEDUP_LIMITS["pairs_precision"]
            and q["kept_fraction"] < DEDUP_LIMITS["kept_fraction"]):
        raise AssertionError(f"(8) dedup quality {q} misses the limits "
                             f"{DEDUP_LIMITS}")
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"  (8e) quality on {DEDUP_QUALITY_DOCS} documents: recall "
          f"{q['pairs_recall']:.4f}, precision {q['pairs_precision']:.4f}, "
          f"kept {q['kept_fraction']:.4f} (limits > 0.7, > 0.9, < 0.85); "
          f"phase {rec['phase_s']:.1f} s  [{card}]")
    return rec


def autotune_phase(dev, card, seed):
    """(9) ``ClusterBatcher.warmup(autotune=True)`` over phase 5's graphs
    (one sample graph a bucket its trace flushes), the cache in a
    temporary file: every candidate of every sweep equal to the plain
    version and no faster than its roofline model; a second cache loaded
    from the file makes no sweep; phase 5's trace served tuned and untuned
    (sync executor, cost policy, A B B A), results equal, program keys
    carrying the plans."""
    import os
    import tempfile

    from repro_torch.core import executor as ex, plan as tplan
    from repro_torch.core.graph import build_graph, random_arboric
    from repro_torch.kernels import autotune as at
    from repro_torch.launch.roofline import ell_kernel_roofline
    from repro_torch.serve import ClusterBatcher

    t_phase = time.perf_counter()
    rng = np.random.default_rng([seed, 6])      # phase 5's, draw for draw
    graphs, lams = main_path_workload(rng, build_graph, random_arboric, dev)
    rows = serving_trace(graphs, lams, rng)
    samples = {}
    for gi, method in sorted(set(rows)):
        samples.setdefault(tplan.plan_graph(graphs[gi], method=method,
                                            lam=lams[gi]).bucket, gi)
    sample_graphs = [graphs[gi] for gi in samples.values()]
    engine = dict(max_batch=SERVE_MAX_BATCH, max_wait=SERVE_MAX_WAIT,
                  num_samples=3, device=dev, executor="sync", policy="cost")
    rec = {"buckets": sorted(list(b) for b in samples)}
    untuned = at.TuningCache(path=None)
    prev = at.set_tuning_cache(untuned)
    prev_capacity = ex.set_program_cache_capacity(1 << 14)
    try:
        with tempfile.TemporaryDirectory() as tmpd:
            path = os.path.join(tmpd, "tuning.json")
            tuned = at.TuningCache(path)
            at.set_tuning_cache(tuned)
            eng = ClusterBatcher(**engine)
            sync(dev)
            t = time.perf_counter()
            eng.warmup(sample_graphs, autotune=True)
            sync(dev)
            rec["warmup_s"] = time.perf_counter() - t
            eng.close()
            swept = {(r["R"], r["W"]) for r in tuned.sweep_log}
            if not set(samples) <= swept:
                raise AssertionError(f"(9) buckets {set(samples) - swept} "
                                     "were not swept")
            sweeps = []
            for r in tuned.sweep_log:
                model = ell_kernel_roofline(r["kernel"], r["batch"], r["R"],
                                            r["W"]).t_model * 1e3
                if not r["equal"]:
                    raise AssertionError(f"(9) {r['kernel']} differs from "
                                         "its plain version")
                for name, ms in r["timings_ms"].items():
                    if ms < model:
                        raise AssertionError(
                            f"(9) {r['kernel']} {name} at "
                            f"{(r['batch'], r['R'], r['W'])}: {ms:.6f} ms is "
                            f"below its roofline model {model:.6f} ms")
                sweeps.append({**r, "model_ms": model})
            rec["sweeps"] = sweeps
            print(f"  (9a) warmup(autotune=True) over {len(sample_graphs)} "
                  f"sample graphs: {tuned.sweeps} sweeps, {len(tuned)} "
                  f"entries in {rec['warmup_s']:.2f} s; every candidate "
                  f"equal to the plain version and no faster than its "
                  f"roofline model  [{card}]")
            print("       per (R, W) and tier (B), B1 | B2: winner, default's "
                  "and winner's device ms")
            by_bucket: dict = {}
            for r in sweeps:
                by_bucket.setdefault((r["R"], r["W"]), {}).setdefault(
                    r["batch"], {})[r["kernel"]] = r
            for (R, W), tiers in sorted(by_bucket.items()):
                print(f"       ({R}, {W}) " + "; ".join(
                    f"B {b}: " + " | ".join(
                        f"{t[k]['winner']} {t[k]['default_ms']:.4f} "
                        f"{t[k]['winner_ms']:.4f}" for k in at.KERNELS)
                    for b, t in sorted(tiers.items())))
            # A second process: a cache loaded from the file.
            second = at.TuningCache(path)
            at.set_tuning_cache(second)
            eng = ClusterBatcher(**engine)
            eng.warmup(sample_graphs, autotune=True)
            eng.close()
            rec["second"] = {"sweeps": second.sweeps, "hits": second.hits,
                             "stale": second.stale, "entries": len(second)}
            if not (second.sweeps == 0 and second.stale == 0
                    and second.hits == len(second) == len(tuned)):
                raise AssertionError(f"(9) second cache {rec['second']}")
            # Phase 5's trace, untuned and tuned, A B B A.
            walls: dict = {"untuned": [], "tuned": []}
            results: dict = {}
            for name in ("untuned", "tuned", "tuned", "untuned"):
                at.set_tuning_cache(second if name == "tuned" else untuned)
                out, _, wall = serve_pass(rows, graphs, lams, dev,
                                          executor="sync", policy="cost")
                walls[name].append(wall)
                results.setdefault(name, out)
            for uid, req in results["untuned"].items():
                a, b = req.result, results["tuned"][uid].result
                if not ((a.labels == b.labels).all() and a.cost == b.cost
                        and a.info == b.info):
                    raise AssertionError(f"(9) request {uid} differs tuned")
            at.set_tuning_cache(second)
            keys = list(ex._program_cache)
            tuned_keys = [k for k in keys if len(k) == 5]
            for k in keys:
                if len(k) == 2 and k[1] == 3 and \
                        at.resolve_plans(k[0], dev) is not None and \
                        not ex.program_cache_contains(k[0], 3, device=dev):
                    raise AssertionError(f"(9) {k[0]} ran untuned only")
            if not tuned_keys:
                raise AssertionError("(9) no program key carries a plan")
    finally:
        at.set_tuning_cache(prev)
        ex.set_program_cache_capacity(prev_capacity)
    rates = {name: [len(rows) / w for w in ws] for name, ws in walls.items()}
    wins: dict = {}
    for r in sweeps:
        wins.setdefault(r["kernel"], {}).setdefault(r["winner"], 0)
        wins[r["kernel"]][r["winner"]] += 1
    rec.update(walls_abba_s=walls, requests_per_s=rates, winners=wins,
               tuned_keys=len(tuned_keys), entries=len(tuned),
               sweeps_n=len(sweeps),
               phase_s=time.perf_counter() - t_phase)
    print(f"  (9b) a second TuningCache from the file: {second.sweeps} "
          f"sweeps, {second.hits} hits of {len(second)} entries, "
          f"{second.stale} stale")
    print(f"  (9c) phase 5's trace ({len(rows)} requests), sync/cost, A B B "
          f"A: untuned {rates['untuned'][0]:.1f} / {rates['untuned'][1]:.1f}"
          f", tuned {rates['tuned'][0]:.1f} / {rates['tuned'][1]:.1f} "
          f"requests/s; every tuned result equals the untuned one; "
          f"{len(tuned_keys)} program keys carry tuned plans; winners "
          f"{wins}; phase {rec['phase_s']:.1f} s  [{card}]")
    return rec


# The training path (phase 10): smollm-135m at full width, the reference
# launcher's full-size settings (chunked attention, loss chunks of 256), 8
# sequences of 1,024 tokens a step.
TRAIN_ARCH = "smollm-135m"
TRAIN_STEPS = 20
TRAIN_SEQ = 1024
TRAIN_BATCH = 8
TRAIN_FAIL_AT = 10
TRAIN_TRACED_STEPS = 3
TRAIN_TIMED_STEPS = 3
# (c) against the CPU: the CPU tests' tolerances (tests/test_torch_train.py):
# the loss to 1e-5, grad_norm to 1e-3 with compression (a value near a
# half quantum may round either way).
TRAIN_CPU_SEQ = 128
TRAIN_CPU_BATCH = 4
TRAIN_LOSS_TOL = 1e-5
TRAIN_GNORM_TOL = 1e-3


class KeepB3Calls:
    """For one run, wraps B3's wrapper where the per-graph engine and the
    MIS rounds call it and keeps a copy of the inputs of every call: the
    real arrays the run gave the kernel. The kernel still launches and
    counts."""

    def __init__(self):
        import importlib

        # The modules themselves: ``repro_torch.core.pivot`` is also the
        # name of a function there.
        pivot, mis, mis_pivot = (importlib.import_module(f"repro_torch.{m}")
                                 for m in ("core.pivot", "core.mis",
                                           "kernels.mis_pivot"))
        self.sites = ((pivot, "mis_pivot_csr"), (mis_pivot, "mis_pivot_csr"))
        self.fn = mis_pivot.mis_pivot_csr
        self.calls = []
        assert mis._mp is mis_pivot

    def __enter__(self):
        def wrapped(*args, **kw):
            self.calls.append([t.clone() for t in args])
            return self.fn(*args, **kw)
        for mod, name in self.sites:
            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name in self.sites:
            setattr(mod, name, self.fn)


def train_dedup_check(b3bench, kept, cfg, dev, card, seed):
    """(10a) B3 held to its plain version on every route at the inputs the
    training launcher's dedup stage gave it, timed; and the stage's kept
    documents, labels and first batches on the card equal to the CPU's."""
    from types import SimpleNamespace

    from repro_torch.launch import train

    rows = []
    for row_offsets, dst, ranks, eligible in kept:
        g = SimpleNamespace(row_offsets=row_offsets, dst=dst)
        row = b3bench.run(g, ranks, eligible)
        rows.append(row)
        print(f"  (10a) dedup stage's B3 call (k, n, 2m) = {row['shape']}: "
              f"equal to the plain version on {'+'.join(row['equal_on'])}; "
              f"device ms: kernel {fmt_ms(row['ms'])}, plain "
              f"{fmt_ms(row['plain_ms'])}, bound {row['bound_ms']:.6f} "
              f"({row['bound_by']})  [{card}]")
    (_, on_card), (_, on_cpu) = (train.dedup_stage(cfg, seed, d)
                                 for d in (dev, "cpu"))
    if not (np.array_equal(on_card.keep, on_cpu.keep)
            and np.array_equal(on_card.labels, on_cpu.labels)):
        raise AssertionError("(10a) the dedup stage's kept documents or "
                             "labels differ between the card and the CPU")
    pipes = [train.build_pipeline(cfg, TRAIN_SEQ, TRAIN_BATCH, dedup=True,
                                  seed=seed, device=d) for d in (dev, "cpu")]
    for step in range(TRAIN_STEPS):
        a, b = (p.batch_at(step) for p in pipes)
        if not all(np.array_equal(a[k], b[k]) for k in b):
            raise AssertionError(f"(10a) batch {step} of the deduped "
                                 f"pipeline differs from the CPU's")
    print(f"  (10a) dedup stage on the card equals the CPU's: "
          f"{int(on_cpu.keep.sum())} of {on_cpu.keep.size} documents kept, "
          f"the same labels, batches 0-{TRAIN_STEPS - 1} equal  [{card}]")
    return rows


def training_phase(dev, card, seed, b3bench):
    """(10) The training path: (a) ``launch.train.run`` at full width (the
    dedup stage launches B3, held after the run to its plain version at the
    inputs it was given and to the CPU's stage; B4 is never launched:
    training takes chunked attention), step walls, tokens/s, peak memory,
    the card's busy share over traced steps, and the cost of deterministic
    mode, A B B A; (b)
    ``--fail-at`` then ``--resume`` equal to (a) bit for bit; (c) two steps
    at ``accum_steps=2`` with compression against the CPU from the same
    state; (d) B4's gradient guard; (e) the cluster dry run at its default
    size; (f) every example module on the card."""
    import contextlib
    import io
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.examples import (batch_serving, dedup_pipeline,
                                      forest_clustering, quickstart,
                                      serve_decode, train_smollm)
    from repro_torch.kernels import flash_attention as fa, mis_pivot
    from repro_torch.launch import cluster_dryrun, train
    from repro_torch.models import build_model
    from repro_torch.models.transformer import RunConfig
    from repro_torch.train import optimizer, train_step
    from repro_torch.train.fault import SimulatedFailure

    rec: dict = {}
    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    common = dict(arch=TRAIN_ARCH, smoke=False, seq_len=TRAIN_SEQ,
                  global_batch=TRAIN_BATCH, steps=TRAIN_STEPS, dedup=True,
                  seed=seed, log_every=5, device=dev)
    try:
        # (a) The full-width run, with its dedup stage.
        mis_pivot.reset_launch_counts()
        fa.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with KeepB3Calls() as kept:
            whole = train.run(ckpt_dir=str(tmp / "a"), resume=False,
                              fail_at=None, ckpt_every=5, **common)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        b3 = mis_pivot.launches["mis_pivot"]
        b4 = fa.launches["flash_attention"]
        peak = torch.cuda.max_memory_allocated()
        losses = whole["losses"]
        step_ms = float(np.median(whole["step_s"])) * 1e3
        if dev.type == "cuda" and (b3 < 1 or b4 != 0):
            raise AssertionError(f"(a) the dedup stage launched B3 {b3} "
                                 f"times and training B4 {b4} times "
                                 f"(want >= 1 and 0)")
        if not (len(losses) == TRAIN_STEPS and np.isfinite(losses).all()):
            raise AssertionError(f"(a) losses {losses}")
        shutil.rmtree(tmp / "a")
        rec.update(wall_s=wall, losses=losses, step_s=whole["step_s"],
                   median_step_ms=step_ms,
                   tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3,
                   peak_bytes=peak, b3_launches_dedup=b3, b4_launches=b4)
        print(f"  (10a) {TRAIN_ARCH} full width, {TRAIN_STEPS} steps of "
              f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens: wall {wall:.2f} s, "
              f"median step {step_ms:.2f} ms "
              f"({rec['tokens_per_s']:.1f} tokens/s), peak "
              f"{peak / 2**30:.2f} GiB, loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}; dedup stage: B3 launched {b3} times; B4 "
              f"{b4}  [{card}]")
        if dev.type == "cuda" and not kept.calls:
            raise AssertionError("(a) no B3 call was kept")
        rec["b3_dedup_rows"] = train_dedup_check(
            b3bench, kept.calls, get_config(TRAIN_ARCH), dev, card, seed)
        del kept

        # (b) Fail at step 10, resume: the same losses bit for bit.
        with contextlib.redirect_stdout(io.StringIO()):
            try:
                train.run(ckpt_dir=str(tmp / "b"), resume=False,
                          fail_at=TRAIN_FAIL_AT, ckpt_every=TRAIN_FAIL_AT,
                          **common)
            except SimulatedFailure:
                pass
            else:
                raise AssertionError("(b) --fail-at raised nothing")
            resumed = train.run(ckpt_dir=str(tmp / "b"), resume=True,
                                fail_at=None, ckpt_every=TRAIN_FAIL_AT,
                                **common)
        if resumed["losses"] != losses[TRAIN_FAIL_AT:]:
            raise AssertionError(f"(b) resumed losses {resumed['losses']} "
                                 f"differ from {losses[TRAIN_FAIL_AT:]}")
        shutil.rmtree(tmp / "b")
        rec["restart_bitwise"] = True
        print(f"  (10b) --fail-at {TRAIN_FAIL_AT} then --resume: losses "
              f"{TRAIN_FAIL_AT}-{TRAIN_STEPS - 1} equal the uninterrupted "
              f"run's bit for bit  [{card}]")

        # Traced steps and deterministic mode's cost, on the run's model.
        cfg = get_config(TRAIN_ARCH)
        rc = RunConfig(attn_impl="chunked", loss_chunk=min(256, TRAIN_SEQ))
        model = build_model(cfg, device=dev, rc=rc,
                            generator=torch.Generator().manual_seed(seed))
        oc = optimizer.OptConfig(lr=1e-3, warmup_steps=5, total_steps=20)
        state = train_step.init_train_state(model, oc)
        step_fn = train_step.make_train_step(model, oc)
        pipe = train.build_pipeline(cfg, TRAIN_SEQ, TRAIN_BATCH, dedup=False,
                                    seed=seed, device=dev)
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe.batch_at(0).items()}

        def steps(n):
            nonlocal state
            for _ in range(n):
                state, m = step_fn(state, batch)
            float(m["loss"])

        def timed(det):
            ctx = train.deterministic(dev) if det else contextlib.nullcontext()
            with ctx:
                steps(1)
                torch.cuda.synchronize()
                t = time.perf_counter()
                steps(TRAIN_TIMED_STEPS)
                torch.cuda.synchronize()
                return (time.perf_counter() - t) / TRAIN_TIMED_STEPS * 1e3

        det_ms = {True: [], False: []}
        for det in (True, False, False, True):
            det_ms[det].append(timed(det))
        # Device time a step without deterministic mode: its cost on the
        # card, free of the host's noise.
        loose = device_events(lambda: steps(TRAIN_TRACED_STEPS))
        with train.deterministic(dev):
            t0 = time.perf_counter()
            events = device_events(lambda: steps(TRAIN_TRACED_STEPS))
            traced = time.perf_counter() - t0
        busy = sum(us for _, us in events) / 1e6 if events else None
        loose_ms = (sum(us for _, us in loose) / 1e3 / TRAIN_TRACED_STEPS
                    if loose else None)
        by_name: dict = {}
        for name, us in events or []:
            by_name[name] = by_name.get(name, 0.0) + us / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        untraced = float(np.mean(det_ms[True]))
        rec.update(deterministic_step_ms=det_ms[True],
                   nondeterministic_step_ms=det_ms[False],
                   traced_wall_s=traced, device_busy_s=busy,
                   device_events=len(events or []),
                   device_ms_per_step=None if busy is None else
                   busy / TRAIN_TRACED_STEPS * 1e3,
                   nondeterministic_device_ms_per_step=loose_ms,
                   top_kernels_ms=top)
        print(f"  (10a) step ms, A B B A, {TRAIN_TIMED_STEPS} steps a pass: "
              f"deterministic {det_ms[True][0]:.2f} / {det_ms[True][1]:.2f},"
              f" not {det_ms[False][0]:.2f} / {det_ms[False][1]:.2f}  "
              f"[{card}]")
        if busy is not None:
            per_step = busy / TRAIN_TRACED_STEPS * 1e3
            print(f"  (10a) {TRAIN_TRACED_STEPS} traced steps: device busy "
                  f"{busy:.3f} s of {traced:.3f} s traced wall "
                  f"({100 * busy / traced:.1f} %; the profiler slows the "
                  f"host), {len(events) / TRAIN_TRACED_STEPS:.0f} device "
                  f"events a step; {per_step:.1f} device ms a step against "
                  f"{untraced:.1f} ms untraced ({100 * per_step / untraced:.1f}"
                  f" %); without deterministic mode "
                  f"{fmt_ms(loose_ms)} device ms a step  [{card}]")
            for name, ms in top:
                print(f"      {ms / TRAIN_TRACED_STEPS:9.2f} ms a step  "
                      f"{name[:90]}")
        del model, state, step_fn, batch
        torch.cuda.empty_cache()

        # (c) accum_steps=2 with compression, against the CPU.
        rec["cpu_check"] = train_cpu_check(dev, card, seed)

        # (d) B4's gradient guard on the card (the CPU's plain version is
        # differentiable and takes such inputs).
        if dev.type == "cuda":
            rec["b4_guard"] = b4_guard_check(dev)
            print(f"  (10d) B4 refuses q, k, v that require grad; under "
                  f"no_grad it launches  [{card}]")

        # (e) The cluster dry run at its default size.
        t0 = time.perf_counter()
        dry = cluster_dryrun.run(device=dev)
        dry["wall_s"] = time.perf_counter() - t0
        dry["link_bytes_per_s"] = cluster_dryrun.link_bytes_per_s(256)
        rec["dryrun"] = dry
        print(f"  (10e) cluster dry run n={dry['n']} m={dry['m']} "
              f"(256 cards): depth raw {dry['depth_raw']} / capped "
              f"{dry['depth_capped']}, {len(dry['phases'])} phases, "
              f"{dry['high_degree']} high-degree; bytes a round "
              f"{dry['bytes_per_round_unpacked']} / "
              f"{dry['bytes_per_round_packed']} (packed); collective s "
              f"{dry['t_collective_s']}, compute s {dry['t_compute_s']:.3e}"
              f" (H100 rates: {dry['link_bytes_per_s'] / 1e9:.0f} GB/s a "
              f"card's link, 67 TOP/s); wall {dry['wall_s']:.2f} s  "
              f"[{card}]")

        # (f) Every example module on the card.
        rec["examples_s"] = {}
        for mod, argv in (
                (quickstart, []), (forest_clustering, []),
                (dedup_pipeline, []), (batch_serving, []),
                (serve_decode, []),
                (train_smollm, ["--ckpt-dir", str(tmp / "example")])):
            name = mod.__name__.rsplit(".", 1)[1]
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                mod.main(argv + ["--device", dev.type])
            rec["examples_s"][name] = time.perf_counter() - t0
            last = buf.getvalue().strip().splitlines()[-1]
            print(f"  (10f) examples.{name}: "
                  f"{rec['examples_s'][name]:.2f} s, last line: {last}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["phase_s"] = time.perf_counter() - t_phase
    print(f"  (10) {rec['phase_s']:.1f} s in all  [{card}]")
    return rec


def b4_guard_check(dev) -> bool:
    """B4 raises on CUDA inputs that require grad, and launches for the
    same inputs under ``torch.no_grad()``."""
    from repro_torch.kernels import flash_attention as fa

    q = torch.randn(1, 9, 64, 64, device=dev, requires_grad=True)
    k = torch.randn(1, 3, 64, 64, device=dev)
    v = torch.randn(1, 3, 64, 64, device=dev)
    try:
        fa.flash_attention(q, k, v)
    except RuntimeError as exc:
        if "no backward" not in str(exc):
            raise
    else:
        raise AssertionError("(10d) B4 took an input that requires grad")
    fa.reset_launch_counts()
    with torch.no_grad():
        fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    if fa.launches["flash_attention"] != 1:
        raise AssertionError("(10d) B4 under no_grad did not launch")
    return True


def train_cpu_check(dev, card, seed):
    """(10c) Two full-width steps at ``accum_steps=2`` with
    ``compress_cross_pod=True`` on the card and on the CPU, each step from
    the same state (the CPU's carried to the card first): loss and
    grad_norm within the CPU tests' tolerances."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.models.transformer import RunConfig
    from repro_torch.train import optimizer, train_step

    cfg = get_config(TRAIN_ARCH)
    rc = RunConfig(attn_impl="chunked", loss_chunk=min(256, TRAIN_CPU_SEQ))
    oc = optimizer.OptConfig(lr=1e-3, warmup_steps=5, total_steps=20)
    sc = train_step.StepConfig(accum_steps=2, compress_cross_pod=True)
    sides = {}
    for side, d in (("cpu", "cpu"), ("card", dev)):
        model = build_model(cfg, device=d, rc=rc,
                            generator=torch.Generator().manual_seed(seed))
        state = train_step.init_train_state(model, oc, sc)
        sides[side] = [model, state,
                       train_step.make_train_step(model, oc, sc)]
    cpu, card_side = sides["cpu"], sides["card"]
    pipe = train.build_pipeline(cfg, TRAIN_CPU_SEQ, TRAIN_CPU_BATCH,
                                dedup=False, seed=seed, device="cpu")
    out = []
    for i in range(2):
        with torch.no_grad():                     # carry the CPU's state
            for part in ("params", "err"):
                for n, t in getattr(card_side[1], part).items():
                    t.copy_(getattr(cpu[1], part)[n])
            for part in ("mu", "nu"):
                for n, t in getattr(card_side[1].opt, part).items():
                    t.copy_(getattr(cpu[1].opt, part)[n])
        card_side[1] = card_side[1]._replace(
            opt=card_side[1].opt._replace(step=cpu[1].opt.step))
        batch = {k: torch.from_numpy(v) for k, v in pipe.batch_at(i).items()}
        cpu[1], want = cpu[2](cpu[1], batch)
        with train.deterministic(dev):
            card_side[1], got = card_side[2](
                card_side[1], {k: v.to(dev) for k, v in batch.items()})
        row = {k: (float(got[k]), float(want[k]))
               for k in ("loss", "grad_norm", "lr")}
        out.append(row)
        for k, tol in (("loss", TRAIN_LOSS_TOL),
                       ("grad_norm", TRAIN_GNORM_TOL)):
            g, w = row[k]
            if not abs(g - w) <= tol * abs(w):
                raise AssertionError(f"(10c) step {i} {k}: card {g}, CPU "
                                     f"{w} (tolerance {tol} relative)")
        if row["lr"][0] != row["lr"][1]:
            raise AssertionError(f"(10c) step {i} lr {row['lr']}")
        print(f"  (10c) accum 2 + compression, step {i}: loss card "
              f"{row['loss'][0]:.6f} / CPU {row['loss'][1]:.6f}, grad_norm "
              f"{row['grad_norm'][0]:.6f} / {row['grad_norm'][1]:.6f}  "
              f"[{card}]")
    del sides, cpu, card_side
    torch.cuda.empty_cache()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", type=Path, default=None,
                        help="also write the full record as JSON here")
    parser.add_argument("--baseline", type=Path, default=None,
                        help="another csrc/neighbor_min.cu, built and timed "
                        "beside B1, B2 and their one-graph form on the "
                        "same inputs; its C entries "
                        "must take no launch plan or this checkout's (see "
                        "measure.bind_baseline)")
    parser.add_argument("--b4-baseline", type=Path, default=None,
                        help="another csrc/flash_attention.cu whose "
                        "fa_forward takes this checkout's 14 arguments, "
                        "built and timed beside B4 on the same inputs")
    parser.add_argument("--b3-baseline", type=Path, default=None,
                        help="another csrc/mis_pivot.cu whose mp_mis_pivot "
                        "takes this checkout's 18 arguments, built and "
                        "timed beside B3 at phase 3's shapes, A B B A")
    parser.add_argument("--ag-baseline", type=Path, default=None,
                        help="another csrc/agreement.cu (none or this "
                        "checkout's ag_abi_version), built and timed beside "
                        "the agreement kernel at replicas 1 on the same "
                        "inputs")
    args = parser.parse_args()
    # Phase 10 trains under torch.use_deterministic_algorithms, whose
    # cuBLAS products need the workspace set before the first one runs.
    from repro_torch.launch.train import set_cublas_workspace
    set_cublas_workspace()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs on the card",
              file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.core import api, mis
    from repro_torch.core.degree_cap import high_degree
    from repro_torch.core.graph import build_graph, random_arboric, star
    from repro_torch.kernels import _build, flash_attention as fa
    from repro_torch.kernels import mis_pivot, neighbor_min as nm, ref
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
    ag_base = AgBaseline(args.ag_baseline) if args.ag_baseline else None
    mp_base = MpBaseline(args.b3_baseline) if args.b3_baseline else None
    logs = _build.build(_build.sources())
    for extra in (baseline, fa_base, ag_base, mp_base):
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
    b3bench = MisBench(mis_pivot, ref, record["ptxas"].get("mis_pivot", []),
                       mp_base)
    record["b3_shapes"] = []
    if mp_base is not None:
        print(f"B3 A/B against {args.b3_baseline}, same inputs, a profiler "
              f"session per kernel and pass  [{card}]")
    for graph, n, lam, k in B3_SHAPES:
        row = b3bench.run(*mis_pivot_inputs(
            n, k, lam, rng, dev, capped=True,
            edges=star(n) if graph == "star" else None))
        row["graph"] = graph
        record["b3_shapes"].append(row)
        print_b3_row(row)
        torch.cuda.empty_cache()
    record["b3_windows"] = b3_window_rows(b3bench, rng, dev)
    abench = AttentionBench(fa, ref, dev, fa_base)
    record["b4_shapes"] = []
    if fa_base is not None:
        print(f"B4 A/B against {args.b4_baseline} at S >= {B4_AB_MIN_S}, "
              f"same inputs, a profiler session per kernel and pass  [{card}]")
    for shape in B4_SHAPES:
        row = abench.run(shape, rng, ab=shape[3] >= B4_AB_MIN_S
                         and shape[5] in B4_AB_HEAD_DIMS)
        record["b4_shapes"].append(row)
        print_b4_row(row)
    record["b4_large_o"] = abench.large_output(rng)

    # 4. Clustering main path.
    t0 = time.perf_counter()
    # Its own generator, so phase 3's draws do not change the workload.
    wrng = np.random.default_rng([args.seed, 4])
    graphs, lams = main_path_workload(wrng, build_graph, random_arboric, dev)
    print(f"main path: {len(graphs)} graphs built on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    path = main_path(graphs, lams, wrng, dev, card)
    record["main_path"] = path["record"]
    stats, per_graph = path["stats"], path["per_graph"]
    batch_launches = path["record"]["launches"]
    graph_launches = path["record"]["per_graph"]["launches"]

    # B1 and B2 timed at the largest bucket shape the main path gave them.
    R, W, B = max(stats.bucket_shapes, key=lambda s: s[0] * s[1] * s[2])
    main_rows = bench.run(B, R, W, rng, ab=True, names=B1_B2)
    print("kernels at the largest shapes the main path gave them:")
    for name, row in main_rows.items():
        print_row(name, row)
    kernels = []
    for name, row in main_rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": batch_launches[name],
            "max_abs_err": bench.max_err[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "shape": row["shape"], "call_ms": row["call_ms"],
            "variant": row["variant"],
            **{k: row[k] for k in ("ab_ms", "baseline_ms") if k in row}})
    # B3 on the largest graph of (d), its real keys and degree cap, and the
    # earlier host loop on the same ranks.
    gi = max(per_graph, key=lambda i: graphs[i].n)
    g = graphs[gi]
    ranks = mis.random_permutation_ranks_batch(
        g.n, api.sample_keys(path["keys"][gi], 3), device=dev)
    eligible = ~high_degree(g, lams[gi])[0]
    b3 = b3bench.run(g, ranks, eligible)
    kernel_out = mis_pivot.mis_pivot_csr(g.row_offsets, g.dst, ranks,
                                         eligible)
    for s_, (labels, rounds) in enumerate(host_loop_capture(g, ranks,
                                                            eligible)):
        if not (torch.equal(labels, kernel_out[1][s_])
                and rounds == int(kernel_out[2][s_])):
            raise AssertionError("B3 and the earlier host loop differ on the "
                                 "largest per-graph graph")
    b3["host_loop_ms"] = device_ms(
        lambda: host_loop_capture(g, ranks, eligible), calls=3)
    b3["host_loop_call_ms"] = time_ms(
        lambda: host_loop_capture(g, ranks, eligible), calls=3, samples=3)
    print_b3_row(b3)
    kernels.append({
        "name": "mis_pivot", "route": "cuda", "source": B3_SOURCE,
        "replaces": B3_REPLACES, "launches": graph_launches["mis_pivot"],
        "max_abs_err": b3bench.max_err, "ms": b3["ms"],
        "plain_ms": b3["plain_ms"], "bound_ms": b3["bound_ms"],
        "bound_by": b3["bound_by"], "library_ms": None,
        "shape": b3["shape"], "call_ms": b3["call_ms"],
        "variant": b3["variant"], "rounds": b3["rounds"],
        "host_loop_ms": b3["host_loop_ms"],
        "host_loop_call_ms": b3["host_loop_call_ms"]})
    del g, ranks, eligible, kernel_out
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
    del graphs, per_graph, path, stats
    torch.cuda.empty_cache()

    # 5. The clustering serving layer.
    serve_cl = serving_phase(dev, card, args.seed, bench, ag_base)
    record["cluster_serving"] = serve_cl
    for tag, row in serve_cl["agree_rows"].items():
        kernels.append({
            "name": "neighbor_min_ell_batch", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES["neighbor_min_ell_batch"],
            "launches": serve_cl["launches"]["neighbor_min_ell_batch"],
            "max_abs_err": 0, "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "shape": row["shape"],
            "call_ms": row["call_ms"],
            "variant": f"precluster agree_ell, {tag} bucket, "
                       f"{row['variant']} route (equal on "
                       f"{'+'.join(row['equal_on'])})",
            "kept_edge_share": row["kept_edge_share"]})
    for tag, row in serve_cl["agree_rows"].items():
        a = row["agreement"]
        kernels.append({
            "name": "agreement_ell_batch", "route": "cuda",
            "source": AG_SOURCE, "replaces": AG_REPLACES,
            "launches": serve_cl["launches"]["agreement_ell_batch"],
            "max_abs_err": 0, "ms": a["ms"], "plain_ms": a["plain_ms"],
            "bound_ms": a["bound_ms"], "bound_by": a["bound_by"],
            "library_ms": None, "shape": a["shape"],
            "call_ms": a["call_ms"],
            "variant": f"{a['variant']}, {tag} bucket",
            "replicas": a["replicas"], "route_taken": a["route"],
            "bound_ms_replicas_1": a["bound_ms_replicas_1"],
            "ms_replicas_1": a["ms_replicas_1"],
            "ms_by_route": a["ms_by_route"],
            "peak_bytes": a["peak_bytes"],
            "plain_peak_bytes": a["plain_peak_bytes"],
            "program_ms": a["program_ms"],
            **{k: a[k] for k in ("ab_ms", "baseline_ms") if k in a}})

    # 6. LM serving path: smollm-135m at full width, f32, random weights.
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

    # B4 timed at the largest prefill shape the LM serving path gave it.
    s_max = len(longest.prompt)
    row = abench.run((1, cfg.num_heads, cfg.num_kv_heads, s_max, s_max,
                      cfg.head_dim, True, "float32"), rng, ab=True)
    print("B4 at the largest prefill shape the serving path gave it:")
    print_b4_row(row)
    kernels.append({
        "name": "flash_attention", "route": "cuda", "source": B4_SOURCE,
        "replaces": B4_REPLACES,
        "launches": serve_rec["b4_instance_launches"].get(
            f"float32/{cfg.head_dim}", 0),
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
    # B4's instances at head dims 80 and 160: no ported model runs them
    # yet (ROADMAP A18), so each row carries its own instance's launches
    # on the LM path, which are 0.
    b4_inst = serve_rec["b4_instance_launches"]
    for row in record["b4_shapes"]:
        if row["shape"][5] in (80, 160):
            dtype = row["shape"][7]
            kernels.append({
                "name": "flash_attention", "route": "cuda",
                "source": B4_SOURCE, "replaces": B4_REPLACES,
                "launches": b4_inst.get(f"{dtype}/{row['shape'][5]}", 0),
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], "shape": row["shape"],
                "call_ms": row["call_ms"], "bounds": row["bounds"],
                "variant": f"fa_forward_kernel<{dtype}, {row['shape'][5]}>,"
                           " off the path"})
    # 7. The paper's other algorithms.
    t0 = time.perf_counter()
    paper = paper_phase(dev, card, args.seed, b3bench)
    paper["phase_s"] = time.perf_counter() - t0
    print(f"  (7) {paper['phase_s']:.1f} s in all  [{card}]")
    record["paper"] = paper
    w = paper["window_row"]
    kernels.append({
        "name": "mis_window", "route": "cuda", "source": B3_SOURCE,
        "replaces": B3_WINDOW_REPLACES,
        "launches": paper["pivot_phased"]["launches"]["mis_window"],
        "max_abs_err": 0, "ms": w["ms"], "plain_ms": w["plain_ms"],
        "bound_ms": w["bound_ms"], "bound_by": w["bound_by"],
        "library_ms": None, "shape": w["shape"], "call_ms": w["call_ms"],
        "variant": f"window mode, {w['variant']} route (equal on "
                   f"{'+'.join(w['equal_on'])})", "rounds": w["rounds"]})
    # 8. The near-duplicate dedup path.
    dedup_rec = dedup_phase(dev, card, args.seed)
    record["dedup"] = dedup_rec
    # 9. The launch-plan autotuner.
    tune = autotune_phase(dev, card, args.seed)
    record["autotune"] = tune
    # B1's and B2's main-path rows also carry their launches on the dedup
    # path and the tuned winner at the largest tier of phase 9's widest
    # R = 4096 bucket, beside the default.
    R4 = max((r for r in tune["sweeps"] if r["R"] == 4096),
             key=lambda r: (r["W"], r["batch"]), default=None)
    for row, kern in zip(kernels[:2], ("neighbor_min", "label_agree")):
        row["launches_dedup"] = {
            path: dedup_rec["launches"][path][row["name"]]
            for path in ("batched", "streaming")}
        if R4 is not None:
            at_shape = next(r for r in tune["sweeps"] if r["kernel"] == kern
                            and (r["R"], r["W"], r["batch"])
                            == (R4["R"], R4["W"], R4["batch"]))
            row["tuned"] = {k: at_shape[k] for k in (
                "batch", "R", "W", "default", "default_ms", "winner",
                "winner_ms", "model_ms")}
    # 10. The training path; B3's row gains its launches in the training
    # launcher's dedup stage.
    train_rec = training_phase(dev, card, args.seed, b3bench)
    record["training"] = train_rec
    for row in kernels:
        if row["name"] == "mis_pivot":
            row["launches_train_dedup"] = train_rec["b3_launches_dedup"]
            row["max_abs_err"] = b3bench.max_err
            row["train_dedup"] = [
                {k: r[k] for k in ("shape", "variant", "equal_on", "ms",
                                   "plain_ms", "bound_ms", "bound_by")}
                for r in train_rec["b3_dedup_rows"]]
    record["kernels"] = kernels
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        # numpy scalars (sizes, counts) as plain numbers
        args.out.write_text(json.dumps(record, indent=1, default=lambda o:
                                       o.item()))

    # 11. Summary.
    print(json.dumps({"training": {
        k: train_rec[k] for k in (
            "wall_s", "median_step_ms", "tokens_per_s", "peak_bytes",
            "device_busy_s", "traced_wall_s", "device_ms_per_step",
            "nondeterministic_device_ms_per_step", "deterministic_step_ms",
            "nondeterministic_step_ms", "b3_launches_dedup",
            "restart_bitwise")}}))
    print(json.dumps({"tuning": {
        "entries": tune["entries"], "sweeps": tune["sweeps_n"],
        "warmup_s": tune["warmup_s"], "second": tune["second"],
        "winners": tune["winners"], "tuned_program_keys": tune["tuned_keys"],
        "requests_per_s_abba": tune["requests_per_s"],
        "dedup_stages_s": dedup_rec["stages_s"],
        "dedup_walls_s": dedup_rec["walls_s"]}}))
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
