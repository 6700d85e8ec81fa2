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
   against async) and its first 512 under ``policy='coalesce'``; 256
   requests under
   ``objective='minmax'`` on the async and the sharded (one device)
   executors, against the batch path; ``submit``'s return time on the
   R = 2¹⁵ pivot bucket; the card's busy share over a traced pass;
6. LM serving path: smollm-135m at full width, f32 weights from a
   ``torch.Generator`` seeded with ``--seed``, serving 8 requests (4 with
   4–23-token prompts, 4 with 512–2000, up to 8 new tokens each) through
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
   synthetic corpus of 5,000 documents (the reference test's recipe:
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
   entry; the first 256 requests of phase 5's trace served untuned and
   tuned (sync executor, cost policy, A B B A), every tuned result equal to the untuned one, the
   program keys carrying the tuned plans, requests/s of each pass;
10. the training path (``repro_torch.launch.train``): (a) ``run`` at
   smollm-135m's full width (30 layers, d = 576, vocabulary 49,152, f32
   weights and AdamW state), 6 steps of 8 sequences of 1,024 tokens,
   the dedup stage on: its wall, median step ms,
   tokens/s, peak memory, B3's launches in the dedup stage and none of B4
   (training takes chunked attention; counts zeroed just before, read just
   after), then B3 on every route held to its plain version at the inputs
   the stage gave it (k = 4, n = 300) and the stage's kept documents,
   labels and batches held to the CPU's; the cost of deterministic mode (step ms with and without it,
   A B B A) and the card's busy share over a traced step; (b)
   ``fail_at=3`` then ``resume``: losses 3–5 equal (a)'s bit for bit;
   (c) 2 full-width steps at ``accum_steps=2`` with compression, sequences
   of 64, 4 a step, each from the CPU's state: loss within 1e-5 and
   grad_norm within 1e-3 of the CPU's; (d) B4 refuses q, k, v that require
   grad; (e) ``launch/cluster_dryrun.run`` at n = 2¹⁷ with its byte and
   time model; (f) every module of ``repro_torch.examples`` on the card;
11. the other dense configs and mixture of experts
   (``repro_torch.configs``): qwen3-8b, granite-3-2b, stablelm-12b and
   olmoe-1b-7b in turn, each at its published widths and full depth with
   f32 weights drawn on the card from ``--seed`` and freed before the next
   (grok-1-314b fits no card): (a) phase 6's request recipe (4 prompts of
   4–23 tokens, 4 of 512–2,000; 4 slots, cache_len 2,048) through
   ``ContinuousBatcher`` and ``serve_all``, counts zeroed just before and
   read just after: every request served, B4 launched layers × prefills
   times at the config's (f32, head dim) instance and at no other; build
   seconds, weight bytes, peak memory, prefill and decode tokens/s, the
   wall, and for olmoe (served under deterministic algorithms, its logits
   kept for phase 13) the dropped assignments per prefill; (b) the
   config cut to 2 layers at its published widths, drawn on the card and
   copied to the CPU: a short prompt and a 512-token one, each with 8
   teacher-forced decode steps, logits within the config's stated
   tolerances (``CUT_TOL``), greedy tokens equal where the CPU's top-2
   margin exceeds twice the tolerance; for olmoe, router logits within
   ``ROUTER_TOL``, the top-k experts of every token and layer equal
   wherever the CPU's gap between its k-th and (k+1)-th logit exceeds
   twice that, and the dropped assignments equal where every decision is
   clear; (c) B4 at the config's longest served prefill against its plain
   version, timed with its bound, SDPA's time and ptxas's registers and
   spills of that instance;
12. the other model families (``repro_torch.configs``), each at its
   published widths with f32 weights drawn on the card from ``--seed`` and
   freed before the next: (a) rwkv6-1.6b (6 of its 24 layers,
   attention-free, the
   exact RWKV scan in prefill as the serving launcher sets it) and
   zamba2-2.7b (54 Mamba2 layers, the shared attention block after every
   6, SSD chunks of 16) through ``ContinuousBatcher`` and ``serve_all``
   with phase 6's request recipe from ``[seed, 12]``, counts zeroed just
   before and read just after: every request served, B4 launched 0 times
   (rwkv6) or 9 times a prefill at (f32, 80) and at no other instance
   (zamba2); build seconds, weight bytes, peak memory, prefill and decode
   tokens/s, the wall; (b) whisper-base (6 + 6 layers, 1,500 frames) and
   (c) llama-3.2-vision-90b cut to 10 layers (2 groups; 337.84 GiB at full
   depth), whose prefill reads stub embeddings the batcher does not
   carry: the same 8 prompts through ``Model.prefill`` with
   ``audio_embeds`` (1, 1,500, 512) or ``image_embeds`` (1, 1,024, 8,192)
   drawn from the seed, then greedy ``decode_step`` s under the batcher's
   stop rules; B4 18 times a prefill at (f32, 64) (6 causal, 12
   non-causal) and 10 at (f32, 128) (8 causal, 2 non-causal); (d) each
   family's cut (rwkv6 2 layers, zamba2 6, whisper whole, the VLM 5),
   drawn on the card with the constant-initialised leaves (gates, ``u``,
   ``w0``, ``A_log``, ``dt_bias``) drawn from the seed, against its copy
   on the CPU: a short prompt and one of 512 tokens (128 for the VLM), 8
   teacher-forced decode steps each, prefill logits within 1e-3 and
   decode logits within 5e-2, greedy tokens equal where the CPU's top-2
   margin exceeds twice the tolerance; (e) B4 at each new instance's
   longest served prefill (zamba2 causal D = 80; whisper's encoder and
   cross-attention, non-causal with Sq != Sk; the VLM's self and cross
   layers) against its plain version, timed with its bound, SDPA's time
   and ptxas's registers and spills; (f) ``rwkv_chunked`` against
   ``rwkv_scan`` on rwkv6's first layer at its longest served prompt: the
   largest difference and each one's wall;
13. sharded serving (``repro_torch.models.{sharding,parallel}``,
   ``launch/mesh.py``): olmoe-1b-7b at its published widths and full
   depth, f32 weights drawn from ``--seed``, phase 11's 8 requests through
   ``ContinuousBatcher``; (a) under deterministic algorithms, as phase 11
   serves olmoe, one NCCL rank on a (data 1, model 1) mesh with
   ``moe_impl`` 'sort' (its logits equal phase 11's bit for bit)
   and 'ep_local' (``moe_ep_local``, its own capacity); collective calls
   and bytes by kind per prefill and per decode step, tokens/s, peak
   memory; (b) two ranks spawned on the one card on (data 1, model 2) in
   a gloo group (NCCL refuses two ranks on one device; gloo carries the
   CUDA tensors through host memory, and the walls are not a two-card
   figure), each holding its half of the weights, every rank on the same
   requests in lockstep (a rank whose greedy tokens differ from rank 0's
   raises), B4 16 times a prefill a rank at (f32, 128) on 8 q and 8 kv
   heads; each impl against (a)'s: prefill logits within 1e-4, decode
   within 5e-2 (phase 11's), greedy tokens equal where (a)'s top-2 margin
   exceeds twice that, router logits within 1e-4 / 5e-2 and the experts equal at every
   clear decision, drops equal; the drops of 'ep_local' against 'sort'
   a prefill; (c) B4 at the local-head instance (1, 8, 8, S, S, 128) at
   the longest served prompt, timed with its bound, SDPA's time and
   ptxas's registers and spills;
14. training every family and the sharded train step
   (``repro_torch.launch.train``, ``train/``, ``models/parallel.py``), f32,
   deterministic algorithms: (f) rwkv6-1.6b (4 x 1,024 tokens a step),
   zamba2-2.7b (2 x 512) and whisper-base (8 x 1,024, zero stub frames) at
   their published widths and full depth through ``launch.train.run``,
   weights drawn on the card, the dedup stage on (B3 launched, B4 not), 2
   steps, then for whisper a fail at 1 and a resume equal bit for bit to
   an uninterrupted run at full depth (checkpoints take ~9.5 s a GB; rwkv6
   and zamba2 restart on the CPU): step ms, tokens/s, peak memory; each
   family's smoke config, 2 steps on the card against the CPU from the
   same state (loss 1e-5, grad_norm 1e-3, relative); (g) smollm-135m at
   full width, 8 x 1,024 tokens, 2 steps: the unsharded step and one NCCL
   rank on (data 1, model 1) (bit for bit), then two gloo ranks of the one
   card on (2, 1) (ZeRO, data-parallel, gradients reduce-scattered; its
   checkpoint saved from the shards against the arrays a (1, 1) save
   writes) and (1, 2) (SwiGLU and vocabulary tensor-parallel, attention
   replicated; its gathered params and moments at seeded positions), each
   against (1, 1) (losses 1e-5, grad_norm 1e-3, relative, the state within
   the stated bounds), the (2, 1) checkpoint restored into the unsharded
   model; collective
   calls and bytes a step by kind, state bytes a rank, peaks; (h)
   olmoe-1b-7b at its published widths cut to 2 layers, 'sort' on the
   expert-parallel plan, 2 steps of 8 x 1,024 tokens on (1, 1) and (1, 2):
   losses and grad_norm as (g), params and moments at seeded positions,
   the first step's routing (router logits, experts at clear decisions,
   drops);
15. the four other families on a mesh (ROADMAP 18d-2; ``models/rwkv.py``
   and ``models/ssm.py`` head-parallel, cross-attention tensor-parallel),
   f32, deterministic algorithms: (a) rwkv6-1.6b (4 of 24 layers),
   zamba2-2.7b (one group: 6 Mamba2 layers and the shared block),
   whisper-base (whole) and llama-3.2-vision-90b (one group: 4 self and a
   cross layer) at their published widths, weights drawn on the card
   from ``--seed``, 4 requests (2 of 4-23 and 2 of 512-1,000 tokens, 8 new
   tokens each, stub embeddings drawn from the seed) through
   ``Model.prefill`` / ``decode_step``: unsharded, one NCCL rank on
   (1, 1) (bit for bit: logits and WKV/SSD states), two gloo ranks of the
   one card on (1, 2) in lockstep (greedy tokens equal on both ranks),
   held to (1, 1): prefill logits 1e-4, decode 5e-2, states 1e-4 of their
   largest value, greedy tokens where the margin is clear; B4 launched a
   prefill at each local-head instance only; collective calls and bytes
   a prefill and a decode step, weight bytes a rank, peaks, tokens/s; (b)
   training, 2 steps of 2 x 128 tokens (rwkv6 1 layer, zamba2 one group
   of 2 Mamba2 layers and the shared block, whisper whole, the VLM one
   gated cross layer): unsharded and (1, 1) bit for bit, (1, 2) for all
   four on the gloo ranks (and (2, 1) on NCCL, ``scripts/shard_train.py``),
   each within 1e-5 (loss) and 1e-3 (grad_norm) of (1, 1) and its state at
   seeded positions within phase 14 (g)'s bounds (on NCCL also whisper's
   (2, 1) checkpoint saved from the shards and restored into the
   unsharded model); (c) B4 at
   each new local-head instance, the longest served prompt, against its
   plain version with its bound, SDPA's time, registers and spills;
16. the dry run and the roofline (ROADMAP 18e, 18f): (a) the dry run's
   meta train step (``launch.dryrun.count_train_step``, a stand-in mesh)
   at phase 14's settings: its collective calls and bytes by kind and its
   state bytes a rank must equal what phase 14 (g) and (h) measured in
   this run, smollm-135m on (1, 1), (2, 1), (1, 2) and olmoe-1b-7b's cut on
   (1, 1), (1, 2); (b) the ported roofline (``launch.roofline``, f32 peak,
   TF32 off) of every prefill of phases 6, 11, 12 and every training step
   of phases 10, 14, and each measured time over its bound; (c)
   ``launch.dryrun.run_cell`` for one grid cell of each family on the
   16 x 16 stand-in mesh; at most 40 s;
17. summary: a ``dryrun``, a ``train_families``, a ``sharding`` (phase 15 under
   ``families``), a ``families``, an ``lm_configs``, a ``training`` and a
   ``tuning`` JSON line, the card line, a ``kernels`` JSON line
   (B1, B2, B3 as the fused kernel and as the window mode, B4, the
   agreement kernel with its route, replicas and both bounds; B1 also on
   the agreement graphs, B4 also at head dims 80 and 160 off the path and
   at each phase-11 config's longest prefill with its launches there; B1's
   and B2's main-path rows also with their launches on the dedup path and
   the tuned winner beside the default; B3's with its launches and its
   check in the training launcher's dedup stage; B4 also at each phase-12
   instance with its launches there, and at phase 13's local-head
   instance with its launches on a rank, and at each phase-15 local-head
   instance with its launches on a rank's path; B3's also with its
   launches in each family's training dedup stage), and last
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package, and exits non-zero with no
result when no CUDA device is available.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import time
import types
from contextlib import nullcontext
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
            # The library yardstick where SDPA computes the same function:
            # Sq = Sk, or no mask (cross-attention); its causal mask with
            # Sq != Sk is aligned top-left, B4's bottom-right. Never called
            # by the port.
            row["library_ms"] = device_ms(library) if Sq == Sk or not \
                causal else None
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


def breakdown(graphs, lams, card, nm, n_trace=128):
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
# Requests of the trace under the coalescing policy (a prefix: the
# smoke's time is short).
SERVE_COALESCE_REQUESTS = 512
# Requests of the traced pass that reads the card's busy share: a prefix,
# as the smoke's time is short.
SERVE_TRACED_REQUESTS = 128
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
    n_co = min(len(rows), SERVE_COALESCE_REQUESTS)
    o, eng, w = serve_pass(rows, graphs, lams, dev, pick=range(n_co),
                           executor="sync", policy="coalesce")
    check_served(o, rows, want, "sync/coalesce")
    rates = {name: [len(rows) / t for t in ts] for name, ts in abba.items()}
    record.update(walls_ab_s=abba, requests_per_s_ab=rates,
                  coalesce_sync_s=w, coalesce_requests=n_co,
                  coalesce_sync_requests_per_s=n_co / w,
                  coalesce_stolen=eng.stats.stolen_requests)
    print(f"      wall A B on the same trace (cost policy): async "
          f"{abba['async'][0]:.3f} s = {rates['async'][0]:.1f} requests/s, "
          f"sync {abba['sync'][0]:.3f} s = {rates['sync'][0]:.1f} "
          "requests/s; "
          f"sync/coalesce on the first {n_co} {w:.3f} s = {n_co / w:.1f} "
          f"requests/s ({eng.stats.stolen_requests} stolen requests)  "
          f"[{card}]")
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
    # The card's busy share over a traced pass of the first
    # SERVE_TRACED_REQUESTS requests.
    t0 = time.perf_counter()
    events = device_events(lambda: serve_pass(
        rows, graphs, lams, dev, pick=range(min(SERVE_TRACED_REQUESTS,
                                                len(rows))),
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
        print(f"      traced pass over {SERVE_TRACED_REQUESTS} requests: "
              f"device busy "
              f"{busy:.3f} s of {traced:.3f} s ({100 * busy / traced:.1f} "
              f"%), B1 {ell_ms[B1_B2[0]]:.3f} ms, B2 "
              f"{ell_ms[B1_B2[1]]:.3f} ms  [{card}]")
    del graphs
    torch.cuda.empty_cache()
    return record


# New tokens a served request asks for: at most SERVE_MAX_NEW - 1. Decode
# is host-bound and its steps take most of phases 6 and 11-13, so 8 keeps
# the smoke within its time.
SERVE_MAX_NEW = 9


def serving_requests(rng, vocab_size, cache_len, pairs=4,
                     long_prompt=(512, 2001), max_new=SERVE_MAX_NEW):
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

    def prefill(self, tokens, cache_len, **stubs):
        out, sec = self._timed(self.model.prefill, tokens, cache_len=cache_len,
                               **stubs)
        self.prefill_calls.append((tokens.numel(), sec))
        self.prefill_s += sec
        self.prefill_tokens += tokens.numel()
        return out

    def decode_step(self, tok, caches, pos):
        out, sec = self._timed(self.model.decode_step, tok, caches, pos)
        self.decode_s += sec
        self.decode_tokens += tok.numel()
        return out


def serving_path(model, requests, cache_len, card, slots=4, label="(e)",
                 timed=None):
    """Serve ``requests`` through ``ContinuousBatcher`` and ``serve_all``
    with every launch count zeroed just before and read just after;
    ``timed`` (a :class:`TimedModel` of ``model``) records the calls."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import neighbor_min as nm
    from repro_torch.serve.batching import ContinuousBatcher
    from repro_torch.serve.engine import serve_all

    timed = timed or TimedModel(model)
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
        raise AssertionError(f"{label} not every request was served")
    want = sum(b4_per_prefill(model.cfg).values()) * st.prefills
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
        # B4's launches by instance and mask, for the kernels line.
        "b4_instance_launches": b4_instance_launches(fa)}
    print(f"  {label} {len(requests)} requests served in {wall:.3f} s wall: "
          f"prefill {timed.prefill_tokens} tokens in {timed.prefill_s:.3f} s"
          f" = {record['prefill_tokens_per_s']:.1f} tokens/s; decode "
          f"{timed.decode_tokens} tokens in {timed.decode_s:.3f} s = "
          f"{record['decode_tokens_per_s']:.1f} tokens/s  [{card}]")
    print(f"      prefills {st.prefills}, decode steps {st.decode_steps}, "
          f"wasted slot-steps {st.wasted_slot_steps}; launches {launches}")
    return record


def b4_key(dtype, head_dim, causal=True) -> str:
    """An instance key of B4's launch counts as the records print it:
    ``float32/64`` (causal) or ``float32/64/non-causal``."""
    return f"{dtype}/{head_dim}" + ("" if causal else "/non-causal")


def b4_instance_launches(fa) -> dict:
    return {b4_key(*key): n for key, n in fa.instance_launches.items()}


def b4_per_prefill(cfg, dtype="float32") -> dict:
    """B4's launches in one prefill of ``cfg``, by instance key: one a
    self-attention layer (causal), one an encoder layer and one a
    cross-attention layer (non-causal); the hybrid's shared block once a
    group, none for RWKV."""
    causal, cross = b4_key(dtype, cfg.head_dim), b4_key(dtype, cfg.head_dim,
                                                       False)
    if cfg.family in ("dense", "moe"):
        return {causal: cfg.num_layers}
    if cfg.family == "ssm":
        return {}
    if cfg.family == "hybrid":
        return {causal: cfg.num_layers // cfg.attn_every}
    if cfg.family == "encdec":
        return {causal: cfg.num_layers,
                cross: cfg.encoder_layers + cfg.num_layers}
    groups = cfg.num_layers // cfg.cross_attn_every
    return {causal: groups * (cfg.cross_attn_every - 1), cross: groups}


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


# Phase 11: the other dense configs and mixture of experts at their
# published widths and full depth, f32 weights drawn on the card from
# --seed, each served with phase 6's request recipe. grok-1-314b (1,179
# GiB of f32 weights) fits no card and waits for sharding (ROADMAP A18d).
LM_ARCHS = ("qwen3-8b", "granite-3-2b", "stablelm-12b", "olmoe-1b-7b")
# The CPU comparison runs a cut of each config: its published widths at
# CUT_LAYERS layers, drawn on the card and copied to the host, on a short
# prompt and one of CUT_LONG tokens, each followed by CUT_DECODE
# teacher-forced decode steps.
CUT_LAYERS = 2
CUT_LONG = 512
CUT_DECODE = 8
# Tolerances of the cut against the CPU, per config. Prefill logits: two
# f32 layers summed in another order, on logits of order 1 (phase 6 holds
# 1e-3 over 30 layers); decode logits: keys and values through bf16 caches,
# where one value rounded to the other side of a bf16 unit moves a logit by
# ~1e-2 (phase 6's reasoning). Router logits (olmoe), of order 1 after a
# norm: in prefill f32 throughout, summed in another order; in decode
# after the bf16 caches, where one cached value rounded the other way moves
# the first layer's attention output by up to ~4e-4 of itself, and the
# first layer's experts (weights drawn at fan-in E, outputs of order 100)
# carry that into the second layer's router input, so decode takes the
# decode logits' reasoning at a tenth of phase 6's bound over two layers
# (PERF.md §6). A routing decision is clear where the CPU's gap
# between its k-th and (k+1)-th logit exceeds twice the tolerance.
CUT_TOL = {arch: {"prefill": 1e-3, "decode": 5e-2} for arch in LM_ARCHS}
ROUTER_TOL = {"prefill": 1e-4, "decode": 1e-2}


class RouterLog:
    """While active, wraps ``repro_torch.models.mlp._router``, which both
    MoE dispatches call once a layer (and token chunk): per call, the token
    count and the assignments dropped at the capacity ``capacity_factor``
    gives that call (a device tensor, so the served run takes no extra
    sync), and with ``logits`` also the f32 router logits and the experts
    chosen."""

    def __init__(self, capacity_factor, logits=False, capacity=None):
        self.factor, self.logits = capacity_factor, logits
        self.capacity = capacity      # mlp._capacity when None
        self.calls: list = []

    def __enter__(self):
        from repro_torch.models import mlp
        self._mlp, self._inner = mlp, mlp._router
        mlp._router = self._route
        return self

    def __exit__(self, *exc):
        self._mlp._router = self._inner

    def _route(self, p, x, cfg):
        gates, idx = self._inner(p, x, cfg)
        c = (self.capacity or self._mlp._capacity)(x.shape[0], cfg,
                                                  self.factor)
        counts = torch.bincount(idx.reshape(-1), minlength=cfg.num_experts)
        call = {"tokens": x.shape[0],
                "dropped": (counts - c).clamp(min=0).sum()}
        if self.logits:
            call["logits"] = self._mlp.linear(x.float(), p.router)
            call["experts"] = idx
        self.calls.append(call)
        return gates, idx

    def take(self) -> list:
        calls, self.calls = self.calls, []
        return calls


def _routing_agrees(cpu_calls, card_calls, k, row, tol):
    """(b) One forward's routing, layer by layer: router logits within
    ``tol``, experts equal at every clear decision, dropped assignments
    equal where every decision of the call is clear. Returns False where
    the experts differ at an unclear decision: the two contexts part
    there."""
    if len(cpu_calls) != len(card_calls):
        raise AssertionError("(b) the card and the CPU routed a different "
                             "number of times")
    for layer, (c, g) in enumerate(zip(cpu_calls, card_calls)):
        err = float((g["logits"].cpu() - c["logits"]).abs().max())
        key = "router_err_" + ("prefill" if c["tokens"] > 1 else "decode")
        row[key] = max(row[key], err)
        if not err <= tol:
            raise AssertionError(f"(b) router logits {err} apart at layer "
                                 f"{layer} (tolerance {tol})")
        top = c["logits"].sort(dim=-1, descending=True).values
        clear = top[:, k - 1] - top[:, k] > 2 * tol
        same = (c["experts"].sort(dim=-1).values
                == g["experts"].cpu().sort(dim=-1).values).all(dim=-1)
        if bool((clear & ~same).any()):
            raise AssertionError(f"(b) layer {layer}: a clear routing "
                                 "decision differs from the CPU's")
        row["decisions"] += int(clear.numel())
        row["unclear"] += int((~clear).sum())
        row["dropped_cpu"] += int(c["dropped"])
        row["dropped_card"] += int(g["dropped"])
        if bool(clear.all()) and int(c["dropped"]) != int(g["dropped"]):
            raise AssertionError(f"(b) layer {layer}: {int(g['dropped'])} "
                                 f"dropped on the card, "
                                 f"{int(c['dropped'])} on the CPU")
        if not bool(same.all()):
            return False
    return True


def check_cut_against_cpu(cut, prompts, cache_len, tol, log=None,
                          stubs=None, label=None):
    """(b) The cut on the card against its copy on the CPU: per prompt the
    prefill logits and CUT_DECODE teacher-forced decode steps (the CPU's
    greedy token fed to both) within ``tol``, greedy tokens equal where the
    CPU's top-2 margin exceeds twice the tolerance; with ``log`` (an MoE),
    the routing of every forward (:func:`_routing_agrees`). Where the
    experts differ at an unclear decision the prompt's comparison ends
    there, and the row says so. ``stubs`` (CPU tensors by batch key) go
    to both prefills; the CPU copy runs with the cut's ``RunConfig``."""
    from repro_torch.models import build_model

    dev, cfg, vocab = cut.device, cut.cfg, cut.cfg.vocab_size
    stubs = stubs or {}
    card_stubs = {k: v.to(dev) for k, v in stubs.items()}
    cpu = build_model(cfg, device="meta", rc=cut.rc).to_empty(device="cpu")
    cpu.load_state_dict(cut.state_dict())
    rows = []
    for prompt in prompts:
        tokens = torch.as_tensor(prompt[None, :], dtype=torch.long)
        row = {"prompt": len(prompt), "errs": [], "margins": [],
               "router_err_prefill": 0.0, "router_err_decode": 0.0,
               "decisions": 0, "unclear": 0,
               "dropped_cpu": 0, "dropped_card": 0, "parted_at": None}
        tok = cc = cg = None
        for step in range(CUT_DECODE + 1):
            if step == 0:
                lc, cc = cpu.prefill(tokens, cache_len=cache_len, **stubs)
                cpu_calls = log.take() if log else []
                lg, cg = cut.prefill(tokens.to(dev), cache_len=cache_len,
                                     **card_stubs)
            else:
                pos, t = len(prompt) + step - 1, torch.tensor([tok])
                lc, cc = cpu.decode_step(t, cc, pos)
                cpu_calls = log.take() if log else []
                lg, cg = cut.decode_step(t.to(dev), cg, pos)
            kind = "prefill" if step == 0 else "decode"
            if log and not _routing_agrees(cpu_calls, log.take(),
                                           cfg.experts_per_tok, row,
                                           ROUTER_TOL[kind]):
                row["parted_at"] = step
                break
            step_tol = tol[kind]
            err = float((lg.cpu() - lc).abs().max())
            if not err <= step_tol:
                raise AssertionError(f"(b) {cfg.name} prompt {len(prompt)} "
                                     f"step {step}: logits {err} apart "
                                     f"(tolerance {step_tol})")
            margin = _margin(lc, vocab)
            tok = int(lc[0, :vocab].argmax())
            if margin > 2 * step_tol and int(lg[0, :vocab].argmax()) != tok:
                raise AssertionError(f"(b) {cfg.name} prompt {len(prompt)} "
                                     f"step {step}: greedy token differs")
            row["errs"].append(err)
            row["margins"].append(margin)
        print(f"  {label or '(b)'} {cfg.name}, {cfg.num_layers} layers, "
              f"prompt {len(prompt)}:"
              f" prefill logits {row['errs'][0]:.3g} apart (tol "
              f"{tol['prefill']}), decode max "
              f"{max(row['errs'][1:], default=0.0):.3g} (tol "
              f"{tol['decode']}) over {len(row['errs']) - 1} steps"
              + (f"; router logits {row['router_err_prefill']:.3g} apart "
                 f"in prefill (tol {ROUTER_TOL['prefill']}), "
                 f"{row['router_err_decode']:.3g} in decode (tol "
                 f"{ROUTER_TOL['decode']}), {row['unclear']} of "
                 f"{row['decisions']} "
                 f"decisions unclear, dropped {row['dropped_card']} on the "
                 f"card / {row['dropped_cpu']} on the CPU" if log else "")
              + ("" if row["parted_at"] is None else
                 f"; routing parted at an unclear decision at step "
                 f"{row['parted_at']}"))
        rows.append(row)
    del cpu
    return rows


def _b4_ptxas(ptxas, head_dim):
    """ptxas's row of B4's f32 instance at ``head_dim``."""
    name = f"fa_forward_kernel<float, {head_dim}>"
    return next((r for r in ptxas if r["function"] == name), None)


def lm_config_phase(arch, dev, card, seed, abench, rng, ptxas):
    """Phase 11 for one architecture: (a) served at full width and depth,
    (b) its cut against the CPU, (c) B4 at its longest prefill. Returns
    the record and the ``kernels`` row."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config(arch)
    moe = bool(cfg.num_experts)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, dtype=torch.float32,
                        generator=torch.Generator(dev).manual_seed(seed))
    sync(dev)
    build_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    print(f"  {arch}: {cfg.num_layers} layers, d {cfg.d_model}, heads "
          f"{cfg.num_heads}/{cfg.num_kv_heads} of {cfg.head_dim}, d_ff "
          f"{cfg.moe_d_ff or cfg.d_ff}"
          + (f", {cfg.num_experts} experts top {cfg.experts_per_tok}"
             if moe else "")
          + f", vocabulary {cfg.vocab_size} (padded {cfg.padded_vocab}): "
          f"{weight_bytes} bytes of f32 weights drawn on the card in "
          f"{build_s:.2f} s")
    reqs = serving_requests(np.random.default_rng([seed, 11]),
                            cfg.vocab_size, SERVE_CACHE_LEN)
    # olmoe serves under deterministic algorithms (its combine adds with
    # atomics otherwise): phase 13 holds its sharded logits to these.
    from repro_torch.launch.train import deterministic
    calls = CallLog(model, reqs) if arch == SHARD_ARCH else None
    with (RouterLog(model.rc.moe_capacity) if moe else nullcontext()) as log, \
            (deterministic(dev) if calls else nullcontext()):
        rec = serving_path(model, reqs, SERVE_CACHE_LEN, card, timed=calls)
    if calls is not None:
        rec["served_logits"], rec["deterministic"] = calls.logits, True
        calls.model = None
    peak = torch.cuda.max_memory_allocated()
    inst = f"float32/{cfg.head_dim}"
    if dev.type == "cuda" and rec["b4_instance_launches"] != {
            inst: cfg.num_layers * rec["prefills"]}:
        raise AssertionError(f"(a) {arch}: B4 launched "
                             f"{rec['b4_instance_launches']}, not "
                             f"{cfg.num_layers} × {rec['prefills']} of "
                             f"{inst}")
    rec.update(arch=arch, build_s=build_s, weight_bytes=weight_bytes,
               peak_bytes=peak)
    print(f"  (a) {arch}: peak {peak} bytes allocated; B4 {inst} launched "
          f"{rec['launches']['flash_attention']} times  [{card}]")
    if moe:
        calls = log.take()
        prefill = [int(c["dropped"]) for c in calls if c["tokens"] > 1]
        per = [sum(prefill[i:i + cfg.num_layers])
               for i in range(0, len(prefill), cfg.num_layers)]
        decode = sum(int(c["dropped"]) for c in calls if c["tokens"] == 1)
        rec["dropped_per_prefill"] = per
        rec["dropped_decode"] = decode
        print(f"      dropped assignments per prefill (of "
              f"{cfg.experts_per_tok} × prompt × {cfg.num_layers} layers): "
              f"{per}; in decode {decode}")
    longest = max(reqs, key=lambda r: len(r.prompt))
    del model
    torch.cuda.empty_cache()

    # (b) The cut against the CPU.
    cut_cfg = dataclasses.replace(cfg, num_layers=CUT_LAYERS)
    cut = build_model(cut_cfg, device=dev, dtype=torch.float32,
                      generator=torch.Generator(dev).manual_seed(seed))
    crng = np.random.default_rng([seed, 11, 2])
    prompts = [crng.integers(2, cfg.vocab_size, n).astype(np.int32)
               for n in (int(crng.integers(4, 24)), CUT_LONG)]
    with (RouterLog(cut.rc.moe_capacity, logits=True) if moe
          else nullcontext()) as log:
        rec["cpu_check"] = check_cut_against_cpu(
            cut, prompts, CUT_LONG + CUT_DECODE + 1, CUT_TOL[arch], log)
    del cut
    torch.cuda.empty_cache()

    # (c) B4 at the longest prefill the path gave it.
    s_max = len(longest.prompt)
    row = abench.run((1, cfg.num_heads, cfg.num_kv_heads, s_max, s_max,
                      cfg.head_dim, True, "float32"), rng)
    print_b4_row(row)
    regs = _b4_ptxas(ptxas, cfg.head_dim)
    if regs is not None:
        print(f"      {regs['function']}: {regs['registers']} registers, "
              f"stack / spill store / spill load {regs['stack']} / "
              f"{regs['spill_stores']} / {regs['spill_loads']} B")
    kernel = {
        "name": "flash_attention", "route": "cuda", "source": B4_SOURCE,
        "replaces": B4_REPLACES,
        "launches": rec["launches"]["flash_attention"],
        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        "shape": row["shape"], "call_ms": row["call_ms"],
        "bounds": row["bounds"],
        "variant": f"fa_forward_kernel<float32, {cfg.head_dim}>, {arch} "
                   f"prefill ({cfg.num_heads}/{cfg.num_kv_heads} heads)",
        "ptxas": regs}
    return rec, kernel


def lm_configs_phase(dev, card, seed, abench, rng, ptxas):
    """Phase 11: every architecture of :data:`LM_ARCHS` in turn, each
    freed before the next is drawn."""
    t0 = time.perf_counter()
    out = {"configs": {}, "kernels": []}
    for arch in LM_ARCHS:
        rec, kernel = lm_config_phase(arch, dev, card, seed, abench, rng,
                                      ptxas)
        out["configs"][arch] = rec
        out["kernels"].append(kernel)
    out["phase_s"] = time.perf_counter() - t0
    print(f"  (11) {out['phase_s']:.1f} s in all  [{card}]")
    return out


# Phase 12: the other model families at their published widths, f32
# weights drawn on the card from --seed, each freed before the next.
# rwkv6-1.6b and zamba2-2.7b serve through ContinuousBatcher with the
# serving launcher's run settings; whisper-base and the VLM read stub
# embeddings the batcher does not carry, so their requests go through
# Model.prefill with the embeddings (drawn from the seed, not zeros: zero
# frames would make every cross K/V zero) and greedy decode_step.
FAMILY_SERVED = ("rwkv6-1.6b", "zamba2-2.7b")
FAMILY_DIRECT = ("whisper-base", "llama-3.2-vision-90b")
# llama-3.2-vision-90b at full depth holds 337.84 GiB of f32 weights (the
# reference's param_count); at its published widths cut to 10 layers (2
# groups of 4 self layers and a cross layer) it holds 39.7 GiB.
VLM_SERVED_LAYERS = 10
# rwkv6-1.6b serves 6 of its 24 layers: its prefill runs the exact scan,
# a few host launches a token and layer, and the smoke's time is short.
RWKV_SERVED_LAYERS = 6
# The CPU comparison (d): each family's cut, drawn on the card and copied
# to the host (None: the whole model), and its long prompt.
FAMILY_CUT_LAYERS = {"rwkv6-1.6b": 2, "zamba2-2.7b": 6, "whisper-base": None,
                     "llama-3.2-vision-90b": 5}
FAMILY_CUT_LONG = {"llama-3.2-vision-90b": 128}
# Phase 11's tolerances and reasoning (CUT_TOL): prefill logits f32 summed
# in another order, decode logits through bf16 carries (keys and values,
# Mamba conv states, RWKV token shifts), where one value rounded to the
# other side of a bf16 unit moves a logit by ~1e-2.
FAMILY_TOL = {"prefill": 1e-3, "decode": 5e-2}
EOS = 1


def stub_inputs(cfg, rng, dev) -> dict:
    """The stub embeddings ``cfg``'s family reads, (1, n, d) standard
    normal f32 from ``rng``, by batch key."""
    from repro_torch.models.transformer import STUB_INPUTS

    key = STUB_INPUTS.get(cfg.family)
    if key is None:
        return {}
    n = cfg.encoder_seq if key == "audio_embeds" else cfg.num_image_tokens
    return {key: torch.from_numpy(rng.standard_normal(
        (1, n, cfg.d_model), np.float32)).to(dev)}


def move_constants(model, seed):
    """Draws the leaves that start at constants (the cross-attention
    ``gate``, RWKV's ``u`` and ``w0``, Mamba's ``A_log`` and ``dt_bias``)
    from ``seed``, as the CPU tests do, so the cross path, the bonus term
    and the decays move the logits the comparison reads."""
    gen = torch.Generator(model.device).manual_seed(seed)
    draws = {"gate": (0.3, 1.2), "w0": (-3.0, -0.5), "A_log": (-1.0, 1.0),
             "dt_bias": (-1.0, 1.0)}
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in draws:
                lo, hi = draws[leaf]
                p.uniform_(lo, hi, generator=gen)
            elif leaf == "u":
                p.normal_(0.0, 0.5, generator=gen)


def direct_path(model, requests, cache_len, card, stubs, label):
    """(b), (c): each request through ``Model.prefill`` with its stub
    embeddings, then greedy ``decode_step`` under the batcher's stop rules
    (max new tokens, EOS, the cache's end), every launch count zeroed just
    before and read just after."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import neighbor_min as nm

    dev, vocab = model.device, model.cfg.vocab_size
    timed = TimedModel(model)
    nm.reset_launch_counts()
    fa.reset_launch_counts()
    sync(dev)
    t0 = time.perf_counter()
    steps = 0
    for req, stub in zip(requests, stubs):
        tokens = torch.as_tensor(req.prompt[None, :], dtype=torch.long,
                                 device=dev)
        logits, caches = timed.prefill(tokens, cache_len, **stub)
        out, pos = [int(logits[0, :vocab].argmax())], len(req.prompt)
        while len(out) < req.max_new_tokens and out[-1] != EOS \
                and pos < cache_len - 1:
            logits, caches = timed.decode_step(
                torch.tensor([out[-1]], device=dev), caches, pos)
            out.append(int(logits[0, :vocab].argmax()))
            pos, steps = pos + 1, steps + 1
        req.out_tokens, req.done = out, True
        del caches
    sync(dev)
    wall = time.perf_counter() - t0
    launches = {**nm.launches, **fa.launches}
    record = {
        "requests": len(requests), "cache_len": cache_len,
        "prompt_lengths": [len(r.prompt) for r in requests],
        "new_tokens": [len(r.out_tokens) for r in requests],
        "wall_s": wall, "prefill_s": timed.prefill_s,
        "decode_s": timed.decode_s, "prefill_calls": timed.prefill_calls,
        "prefill_tokens": timed.prefill_tokens,
        "decode_tokens": timed.decode_tokens,
        "prefill_tokens_per_s": timed.prefill_tokens / timed.prefill_s,
        "decode_tokens_per_s": timed.decode_tokens / max(timed.decode_s,
                                                         1e-9),
        "prefills": len(requests), "decode_steps": steps,
        "emitted_tokens": sum(len(r.out_tokens) for r in requests),
        "launches": launches,
        "b4_instance_launches": b4_instance_launches(fa)}
    print(f"  {label} {len(requests)} requests served in {wall:.3f} s wall:"
          f" prefill "
          f"{timed.prefill_tokens} tokens in {timed.prefill_s:.3f} s = "
          f"{record['prefill_tokens_per_s']:.1f} tokens/s; decode "
          f"{timed.decode_tokens} tokens in {timed.decode_s:.3f} s = "
          f"{record['decode_tokens_per_s']:.1f} tokens/s  [{card}]")
    return record


def rwkv_evaluators(model, prompt, card):
    """(f) ``rwkv_chunked`` against ``rwkv_scan`` on the first layer's
    projections of ``prompt``: the largest difference of outputs and of
    final states, and each one's wall (the second of two calls, each
    ended by a synchronise). A measurement for the roadmap; serving keeps
    the launcher's scan."""
    from repro_torch.models import rwkv
    from repro_torch.models.common import rms_norm

    cfg, dev = model.cfg, model.device
    p = model.blocks[0]
    h, n = rwkv.rwkv_dims(cfg)
    with torch.no_grad():
        x = model.embed[torch.as_tensor(prompt[None, :], dtype=torch.long,
                                        device=dev)]
        z = rms_norm(x, p.ln1, cfg.norm_eps)
        r, k, v, _, logw, _ = rwkv._projections(
            p.tm, z, torch.zeros_like(z[:, :1]))
        t = z.shape[1]
        args = [a.reshape(1, t, h, n) for a in (r, k, v, logw)] + [
            p.tm.u.reshape(h, n), torch.zeros((1, h, n, n), device=dev)]
        out, walls = {}, {}
        for name, fn in (("scan", rwkv.rwkv_scan),
                         ("chunked", rwkv.rwkv_chunked)):
            for _ in range(2):
                sync(dev)
                t0 = time.perf_counter()
                out[name] = fn(*args)
                sync(dev)
                walls[name] = time.perf_counter() - t0
    rec = {"tokens": t,
           "max_abs_diff_out": float((out["scan"][0] - out["chunked"][0])
                                     .abs().max()),
           "max_abs_diff_state": float((out["scan"][1] - out["chunked"][1])
                                       .abs().max()),
           "max_abs_out": float(out["scan"][0].abs().max()),
           "scan_s": walls["scan"], "chunked_s": walls["chunked"]}
    if not (np.isfinite(rec["max_abs_diff_out"])
            and rec["max_abs_diff_out"] <= 1e-3 * max(1.0, rec["max_abs_out"])):
        raise AssertionError(f"(f) rwkv_chunked and rwkv_scan differ by "
                             f"{rec['max_abs_diff_out']}")
    print(f"  (f) {cfg.name} layer 0, {t} tokens: rwkv_chunked against "
          f"rwkv_scan max |diff| {rec['max_abs_diff_out']:.3g} (outputs up "
          f"to {rec['max_abs_out']:.3g}), states {rec['max_abs_diff_state']:.3g}"
          f"; wall scan {rec['scan_s'] * 1e3:.2f} ms, chunked "
          f"{rec['chunked_s'] * 1e3:.2f} ms  [{card}]")
    return rec


def _family_cfg(arch):
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if arch == "llama-3.2-vision-90b":
        cfg = dataclasses.replace(cfg, num_layers=VLM_SERVED_LAYERS)
    if arch == "rwkv6-1.6b":
        cfg = dataclasses.replace(cfg, num_layers=RWKV_SERVED_LAYERS)
    return cfg


def family_served(arch, dev, card, seed):
    """(a)/(b)/(c) for one family: built at its published widths (the VLM
    cut to :data:`VLM_SERVED_LAYERS`), served, B4's launches checked per
    instance; for rwkv6 also (f). Returns the record and the longest
    prompt."""
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    cfg = _family_cfg(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, dtype=torch.float32,
                        generator=torch.Generator(dev).manual_seed(seed),
                        rc=serve.run_config(cfg))
    sync(dev)
    build_s = time.perf_counter() - t0
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    print(f"  {arch} ({cfg.family}): {cfg.num_layers} layers, d "
          f"{cfg.d_model}, heads {cfg.num_heads}/{cfg.num_kv_heads} of "
          f"{cfg.head_dim}, vocabulary {cfg.vocab_size}, {model.rc}: "
          f"{weight_bytes} bytes of f32 weights drawn on the card in "
          f"{build_s:.2f} s")
    reqs = serving_requests(np.random.default_rng([seed, 12]),
                            cfg.vocab_size, SERVE_CACHE_LEN)
    if arch in FAMILY_SERVED:
        rec = serving_path(model, reqs, SERVE_CACHE_LEN, card, label="(a)")
    else:
        srng = np.random.default_rng([seed, 12, 1])
        stubs = [stub_inputs(cfg, srng, dev) for _ in reqs]
        rec = direct_path(model, reqs, SERVE_CACHE_LEN, card, stubs,
                          "(b)" if cfg.family == "encdec" else "(c)")
        del stubs
    if not all(r.done and r.out_tokens for r in reqs):
        raise AssertionError(f"{arch}: not every request was served")
    want = {k: n * rec["prefills"] for k, n in b4_per_prefill(cfg).items()}
    if dev.type == "cuda" and rec["b4_instance_launches"] != want:
        raise AssertionError(f"{arch}: B4 launched "
                             f"{rec['b4_instance_launches']}, not {want}")
    peak = torch.cuda.max_memory_allocated()
    rec.update(arch=arch, layers=cfg.num_layers, build_s=build_s,
               weight_bytes=weight_bytes, peak_bytes=peak,
               b4_per_prefill=b4_per_prefill(cfg))
    print(f"      prefills {rec['prefills']}, decode steps "
          f"{rec['decode_steps']}; B4 launched "
          f"{rec['b4_instance_launches']} ({b4_per_prefill(cfg)} a prefill);"
          f" peak {peak} bytes allocated  [{card}]")
    longest = max(reqs, key=lambda r: len(r.prompt))
    if cfg.family == "ssm":
        rec["evaluators"] = rwkv_evaluators(model, longest.prompt, card)
    del model
    torch.cuda.empty_cache()
    return rec, len(longest.prompt)


def family_against_cpu(arch, dev, seed):
    """(d) The family's cut (:data:`FAMILY_CUT_LAYERS`) drawn on the card
    with its constant leaves drawn from the seed, against its copy on the
    CPU: a short prompt and a long one, each with CUT_DECODE teacher-forced
    decode steps."""
    from repro_torch.launch import serve
    from repro_torch.models import build_model

    cfg = _family_cfg(arch)
    if FAMILY_CUT_LAYERS[arch]:
        cfg = dataclasses.replace(cfg, num_layers=FAMILY_CUT_LAYERS[arch])
    cut = build_model(cfg, device=dev, dtype=torch.float32,
                      generator=torch.Generator(dev).manual_seed(seed),
                      rc=serve.run_config(cfg))
    move_constants(cut, seed + 1)
    crng = np.random.default_rng([seed, 12, 2])
    long = FAMILY_CUT_LONG.get(arch, CUT_LONG)
    prompts = [crng.integers(2, cfg.vocab_size, n).astype(np.int32)
               for n in (int(crng.integers(4, 24)), long)]
    stubs = stub_inputs(cfg, crng, torch.device("cpu"))
    rows = check_cut_against_cpu(cut, prompts, long + CUT_DECODE + 1,
                                 FAMILY_TOL, stubs=stubs, label="(d)")
    del cut
    torch.cuda.empty_cache()
    return {"layers": cfg.num_layers, "rows": rows}


def family_b4_rows(served, abench, rng, ptxas):
    """(e) B4 at each new instance's longest served prefill, against its
    plain version, timed with its bound, SDPA's time and ptxas's
    registers and spills; the ``kernels`` rows, each with its instance's
    launches on its family's path."""
    from repro_torch.configs import get_config

    rows = []
    zamba, whisper = get_config("zamba2-2.7b"), get_config("whisper-base")
    vlm = get_config("llama-3.2-vision-90b")
    s_z, s_w, s_v = (served[a]["longest_prompt"] for a in (
        "zamba2-2.7b", "whisper-base", "llama-3.2-vision-90b"))
    enc = whisper.encoder_seq
    for arch, cfg, (sq, sk), causal, what in (
            ("zamba2-2.7b", zamba, (s_z, s_z), True, "shared attention"),
            ("whisper-base", whisper, (enc, enc), False, "encoder"),
            ("whisper-base", whisper, (s_w, enc), False, "cross-attention"),
            ("llama-3.2-vision-90b", vlm, (s_v, s_v), True, "self layers"),
            ("llama-3.2-vision-90b", vlm, (s_v, vlm.num_image_tokens), False,
             "cross layers")):
        shape = (1, cfg.num_heads, cfg.num_kv_heads, sq, sk, cfg.head_dim,
                 causal, "float32")
        row = abench.run(shape, rng)
        print_b4_row(row)
        regs = _b4_ptxas(ptxas, cfg.head_dim)
        if regs is not None:
            print(f"      {regs['function']}: {regs['registers']} registers,"
                  f" stack / spill store / spill load {regs['stack']} / "
                  f"{regs['spill_stores']} / {regs['spill_loads']} B")
        key = b4_key("float32", cfg.head_dim, causal)
        rows.append({
            "name": "flash_attention", "route": "cuda", "source": B4_SOURCE,
            "replaces": B4_REPLACES,
            "launches": served[arch]["b4_instance_launches"].get(key, 0),
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "shape": row["shape"], "call_ms": row["call_ms"],
            "bounds": row["bounds"],
            "variant": f"fa_forward_kernel<float32, {cfg.head_dim}>, "
                       f"{'causal' if causal else 'non-causal'}, {arch} "
                       f"{what} ({cfg.num_heads}/{cfg.num_kv_heads} heads); "
                       f"launches: the {key} instance on its path",
            "ptxas": regs})
    return rows


def families_phase(dev, card, seed, abench, rng, ptxas):
    """Phase 12: (a)-(c) and (f) each family served, (d) each cut against
    the CPU, (e) B4 at the new instances."""
    t0 = time.perf_counter()
    out = {"served": {}, "cpu_check": {}}
    for arch in FAMILY_SERVED + FAMILY_DIRECT:
        rec, longest = family_served(arch, dev, card, seed)
        rec["longest_prompt"] = longest
        out["served"][arch] = rec
    for arch in FAMILY_SERVED + FAMILY_DIRECT:
        out["cpu_check"][arch] = family_against_cpu(arch, dev, seed)
    out["kernels"] = family_b4_rows(out["served"], abench, rng, ptxas)
    out["phase_s"] = time.perf_counter() - t0
    print(f"  (12) {out['phase_s']:.1f} s in all  [{card}]")
    return out


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
DEDUP_DOCS = 5_000
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


# Requests of phase 5's trace served untuned and tuned, A B B A, in
# phase 9 (a prefix: the smoke's time is short).
AUTOTUNE_ABBA_REQUESTS = 256


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
            # Phase 5's trace (its first AUTOTUNE_ABBA_REQUESTS), untuned
            # and tuned, A B B A.
            walls: dict = {"untuned": [], "tuned": []}
            results: dict = {}
            abba = rows[:AUTOTUNE_ABBA_REQUESTS]
            for name in ("untuned", "tuned", "tuned", "untuned"):
                at.set_tuning_cache(second if name == "tuned" else untuned)
                out, _, wall = serve_pass(abba, graphs, lams, dev,
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
    rates = {name: [len(abba) / w for w in ws] for name, ws in walls.items()}
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
    print(f"  (9c) phase 5's trace ({len(abba)} requests), sync/cost, A B B "
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
TRAIN_STEPS = 6
TRAIN_SEQ = 1024
TRAIN_BATCH = 8
TRAIN_FAIL_AT = 3
TRAIN_TRACED_STEPS = 1
TRAIN_TIMED_STEPS = 2
# (c) against the CPU: the CPU tests' tolerances (tests/test_torch_train.py):
# the loss to 1e-5, grad_norm to 1e-3 with compression (a value near a
# half quantum may round either way).
TRAIN_CPU_SEQ = 64
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
            whole = train.run(ckpt_dir=None, resume=False, fail_at=None,
                              **common)
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

        # (b) Fail at step 3, resume: the same losses bit for bit.
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


# Phase 13: olmoe-1b-7b at its published widths and full depth on a
# (data, model) device mesh over torch.distributed, served through the
# ContinuousBatcher on the same 8 requests as phase 11 ([seed, 11]), with
# 'sort' (every rank routes every token as one device would, each runs its
# experts, one all-reduce) and 'ep_local' (moe_ep_local: a dispatch local
# to each data shard, its own capacity). (a) one NCCL rank on a (1, 1)
# mesh, under deterministic algorithms (the experts' combine adds with
# atomics otherwise, and two unsharded runs then differ by ~2e-4): 'sort'
# against phase 11's unsharded logits, served so too (bit for bit, or
# within SHARD_EQUAL_TOL); (b) two ranks on the one card on (1, 2), in a gloo
# group (NCCL refuses two ranks on one device; gloo carries the CUDA
# tensors through host memory), each holding its half, against (a) impl
# for impl: prefill logits within 1e-4 (f32 weights, the row-parallel sums
# in another order), decode within phase 11's decode limit, 5e-2
# (CUT_TOL): the caches are bf16, a half-width product or a split sum
# rounds a key or value to the other side of a bf16 unit, and over 16
# layers that moved a decode logit by up to 0.0248 (PERF.md §6), more
# than 1e-2; greedy tokens equal where (a)'s top-2 margin
# exceeds twice the limit; routing as phase 11 holds it, with
# SHARD_ROUTER_TOL; (c) B4 at the local-head instance.
SHARD_ARCH = "olmoe-1b-7b"
SHARD_IMPLS = ("sort", "ep_local")


def _shard_impls(cfg):
    """The MoE dispatches phase 13 serves ``cfg`` with: both for MoE, the
    default for a dense config (which reads no MoE field)."""
    return SHARD_IMPLS if cfg.family == "moe" else ("sort",)


def _local_heads(cfg, ranks):
    """(q, kv) heads of a rank's B4 calls on (1, ``ranks``) where both
    head counts divide over the ranks, whole where neither does (attention
    replicated), else None (the kv heads follow the q heads' groups)."""
    h, kh = cfg.num_heads, cfg.num_kv_heads
    if h % ranks == 0 and kh % ranks == 0:
        return h // ranks, kh // ranks
    return (h, kh) if h % ranks else None
SHARD_MODEL = 2
SHARD_TOL = {"prefill": 1e-4, "decode": 5e-2}
# Router logits of (b) against (a): prefill as phase 11's; decode over 16
# layers, where each layer's bf16 cache roundings carry into the next
# router's input (phase 11's 1e-2 covers two layers).
SHARD_ROUTER_TOL = {"prefill": 1e-4, "decode": 5e-2}
SHARD_EQUAL_TOL = 1e-6


class CallLog(TimedModel):
    """A :class:`TimedModel` that also keeps, for each request by uid, the
    logits of its prefill and of each decode step (host copies), the
    router calls of each (with ``log``, a :class:`RouterLog`) and the
    collectives each call issued (``models.parallel.counts``)."""

    def __init__(self, model, requests, log=None):
        super().__init__(model)
        self.uid_of = {tuple(int(t) for t in r.prompt): r.uid
                       for r in requests}
        self.owner: dict = {}
        self.logits: dict = {}
        self.router: dict = {}
        self.collectives: dict = {"prefill": [], "decode": []}
        self.log = log

    def _keep(self, uid, kind, logits, before):
        from repro_torch.models import parallel

        self.logits.setdefault(uid, []).append(logits[0].detach().cpu())
        if self.log is not None:
            self.router.setdefault(uid, []).append([
                {k: v.cpu() if torch.is_tensor(v) else v
                 for k, v in c.items()} for c in self.log.take()])
        after = parallel.snapshot()
        self.collectives[kind].append({
            k: {f: after[k][f] - before[k][f] for f in after[k]}
            for k in after})

    def prefill(self, tokens, cache_len, **stubs):
        from repro_torch.models import parallel

        before = parallel.snapshot()
        logits, caches = super().prefill(tokens, cache_len, **stubs)
        uid = self.uid_of[tuple(tokens[0].tolist())]
        self.owner[id(caches)] = uid
        self._keep(uid, "prefill", logits, before)
        return logits, caches

    def decode_step(self, tok, caches, pos):
        from repro_torch.models import parallel

        before = parallel.snapshot()
        logits, caches = super().decode_step(tok, caches, pos)
        self._keep(self.owner[id(caches)], "decode", logits, before)
        return logits, caches

    def per_call(self) -> dict:
        """Mean collective calls and bytes by kind, per prefill and per
        decode step."""
        out = {}
        for kind, rows in self.collectives.items():
            n = max(1, len(rows))
            out[kind] = {k: {f: sum(r[k][f] for r in rows) / n
                             for f in ("calls", "bytes")}
                         for k in (rows[0] if rows else {})}
        return out


class _HeadLog:
    """While active, B4's calls through ``models.attention`` by (q heads,
    kv heads, head dim, causal)."""

    def __enter__(self):
        from repro_torch.models import attention

        self.seen: dict = {}
        self._inner = inner = attention.flash_attention

        def b4(q, k, v, causal):
            key = (q.shape[1], k.shape[1], q.shape[-1], bool(causal))
            self.seen[key] = self.seen.get(key, 0) + 1
            return inner(q, k, v, causal=causal)

        attention.flash_attention = b4
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention

        attention.flash_attention = self._inner


def _shard_model(cfg, dev, seed, impl, axes):
    """olmoe on the mesh ``axes`` of the initialised group, drawn as
    phase 11 draws it, with ``impl``."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.sharding import resolve_plan
    from repro_torch.models.transformer import RunConfig

    mesh = make_mesh(axes)
    plan = resolve_plan(cfg, None, axes)
    return build_model(cfg, device=dev, dtype=torch.float32,
                       generator=torch.Generator(dev).manual_seed(seed),
                       plan=plan, mesh=mesh,
                       rc=RunConfig(moe_impl=impl, mesh=mesh))


def _shard_serve(model, reqs, card, label):
    """Serve ``reqs`` with routing and per-call records; B4 checked at
    olmoe's (f32, 128) instance, once a layer and prefill."""
    from repro_torch.models import mlp, parallel

    cap = mlp.ep_local_capacity if model.rc.moe_impl == "ep_local" else None
    cuda = model.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(model.device)
    parallel.reset_counts()
    with RouterLog(model.rc.moe_capacity, logits=True,
                   capacity=cap) as log:
        calls = CallLog(model, reqs, log)
        rec = serving_path(model, reqs, SERVE_CACHE_LEN, card, timed=calls,
                           label=label)
    cfg = model.cfg
    want = {b4_key("float32", cfg.head_dim): cfg.num_layers * rec["prefills"]}
    if cuda and rec["b4_instance_launches"] != want:
        raise AssertionError(f"{label} B4 launched "
                             f"{rec['b4_instance_launches']}, not {want}")
    rec["peak_bytes"] = (torch.cuda.max_memory_allocated(model.device)
                         if cuda else None)
    rec["weight_bytes"] = sum(p.numel() * p.element_size()
                              for p in model.parameters())
    rec["collectives_per_call"] = calls.per_call()
    rec["collectives"] = parallel.snapshot()
    rec["dropped_per_prefill"] = [
        sum(int(c["dropped"]) for c in steps[0])
        for _, steps in sorted(calls.router.items())]
    for kind, row in rec["collectives_per_call"].items():
        print(f"      per {kind} call: " + ", ".join(
            f"{k} {v['calls']:.1f} calls / {v['bytes']:.0f} bytes"
            for k, v in row.items()))
    print(f"      weights {rec['weight_bytes']} bytes on this rank, peak "
          f"{rec['peak_bytes']} bytes allocated; dropped assignments per "
          f"prefill {rec['dropped_per_prefill']}")
    return rec, calls


def _shard_routing(a_calls, b_calls, k, row, tol, where):
    """One call's routing in (b) against (a), layer by layer, as
    :func:`_routing_agrees` holds it, except that each failure is added
    to ``row["violations"]`` (so one run reports them all) and each
    layer's router error is kept. Returns False where the experts differ
    at an unclear decision: the two contexts part there."""
    if len(a_calls) != len(b_calls):
        row["violations"].append(f"{where}: {len(b_calls)} router calls, "
                                 f"not {len(a_calls)}")
        return False
    kind = "prefill" if a_calls and a_calls[0]["tokens"] > 1 else "decode"
    errs = row["router_err_by_layer"][kind]
    for layer, (c, g) in enumerate(zip(a_calls, b_calls)):
        err = float((g["logits"] - c["logits"]).abs().max())
        if len(errs) <= layer:
            errs.append(0.0)
        errs[layer] = max(errs[layer], err)
        row[f"router_err_{kind}"] = max(row[f"router_err_{kind}"], err)
        if not err <= tol:
            row["violations"].append(f"{where} layer {layer}: router logits "
                                     f"{err:.3g} apart (tolerance {tol})")
        top = c["logits"].sort(dim=-1, descending=True).values
        clear = top[:, k - 1] - top[:, k] > 2 * tol
        same = (c["experts"].sort(dim=-1).values
                == g["experts"].sort(dim=-1).values).all(dim=-1)
        if bool((clear & ~same).any()):
            row["violations"].append(f"{where} layer {layer}: a clear "
                                     f"routing decision differs")
        row["decisions"] += int(clear.numel())
        row["unclear"] += int((~clear).sum())
        row["dropped_one_rank"] += int(c["dropped"])
        row["dropped_two_ranks"] += int(g["dropped"])
        if bool(clear.all()) and int(c["dropped"]) != int(g["dropped"]):
            row["violations"].append(f"{where} layer {layer}: "
                                     f"{int(g['dropped'])} dropped, "
                                     f"{int(c['dropped'])} on one rank")
        if not bool(same.all()):
            return False
    return True


def _compare_served(a, b, cfg, label):
    """(b) against (a), request by request: logits within SHARD_TOL, the
    greedy token where (a)'s margin is clear, routing within
    SHARD_ROUTER_TOL (:func:`_shard_routing`). A request whose experts or
    token differ at an unclear decision is compared up to there. Every
    failure lands in ``row["violations"]``."""
    vocab = cfg.vocab_size
    row = {"prefill_err": 0.0, "decode_err": 0.0, "router_err_prefill": 0.0,
           "router_err_decode": 0.0, "decisions": 0, "unclear": 0,
           "dropped_one_rank": 0, "dropped_two_ranks": 0, "parted": {},
           "steps": 0, "violations": [],
           "router_err_by_layer": {"prefill": [], "decode": []}}
    for uid, steps in sorted(a.logits.items()):
        for step, (la, lb) in enumerate(zip(steps, b.logits[uid])):
            kind = "prefill" if step == 0 else "decode"
            where = f"{label} request {uid} step {step}"
            if not _shard_routing(a.router[uid][step], b.router[uid][step],
                                  cfg.experts_per_tok, row,
                                  SHARD_ROUTER_TOL[kind], where):
                row["parted"][uid] = step
                break
            err = float((la - lb).abs().max())
            if not err <= SHARD_TOL[kind]:
                row["violations"].append(f"{where}: logits {err:.3g} apart "
                                         f"(tolerance {SHARD_TOL[kind]})")
            row[f"{kind}_err"] = max(row[f"{kind}_err"], err)
            row["steps"] += 1
            top2 = torch.topk(la[:vocab], 2).values
            tok_a, tok_b = int(la[:vocab].argmax()), int(lb[:vocab].argmax())
            if tok_a != tok_b:
                if float(top2[0] - top2[1]) > 2 * SHARD_TOL[kind]:
                    row["violations"].append(f"{where}: greedy token "
                                             f"differs at a clear margin")
                row["parted"][uid] = step
                break
    return row


def _fresh(reqs):
    """``reqs`` made unserved again, to serve once more."""
    for r in reqs:
        r.out_tokens.clear()
        r.done = False
    return reqs


def _shard_rank(rank, world, store, out_dir, seed, card, cfg, dev_type,
                backend):
    """(13b) one rank of ``world`` in a ``backend`` group, on card
    ``rank`` modulo the cards there are (``dev_type`` 'cuda'): serve
    ``cfg`` with each impl and save the records for the parent."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # The ranks share the host's cores: each spinning thread pool of its
    # own would starve the other's.
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    dev = torch.device(dev_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        reqs = serving_requests(np.random.default_rng([seed, 11]),
                                cfg.vocab_size, SERVE_CACHE_LEN)
        for impl in _shard_impls(cfg):
            t0 = time.perf_counter()
            model = _shard_model(cfg, dev, seed, impl,
                                 {"data": 1, "model": world})
            sync(dev)
            build_s = time.perf_counter() - t0
            # Rank 0 prints for both.
            with (nullcontext() if rank == 0 else
                  contextlib.redirect_stdout(io.StringIO())), \
                    _HeadLog() as log:
                rec, calls = _shard_serve(model, _fresh(reqs), card,
                                          f"(13b) {impl}")
            heads = {key[:2] for key in log.seen}
            tokens = {r.uid: list(r.out_tokens) for r in reqs}
            every = [None] * world
            dist.all_gather_object(every, tokens)
            if any(t != every[0] for t in every):
                raise AssertionError(f"(13b) rank {rank}: greedy tokens "
                                     f"differ from rank 0's")
            want = {_local_heads(cfg, world)}
            if None not in want and heads != want:
                raise AssertionError(f"(13b) B4 ran on {heads} (q, kv) "
                                     f"heads, not {want}")
            rec.update(build_s=build_s, heads=sorted(heads))
            torch.save({"rec": rec, "logits": calls.logits,
                        "router": calls.router},
                       os.path.join(out_dir, f"{impl}_{rank}.pt"))
            del model, calls
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def shard_serving(dev, card, seed, cfg, unsharded=None, ranks=SHARD_MODEL,
                  backend="gloo"):
    """(13a) and (13b) for ``cfg``: (a) one rank, ``sort`` against
    ``unsharded`` (logits by request, served under deterministic
    algorithms; served here first when None), then ``ep_local``; (b)
    ``ranks`` spawned ranks in a ``backend`` group on a (data 1, model
    ``ranks``) mesh, each impl against (a)'s. Returns the record."""
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch.launch.train import deterministic
    from repro_torch.models import build_model

    reqs = serving_requests(np.random.default_rng([seed, 11]),
                            cfg.vocab_size, SERVE_CACHE_LEN)
    out: dict = {"one_rank": {}, "sharded": {}, "against_one_rank": {},
                 "ranks": ranks, "backend": backend}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_shard_"))
    one: dict = {}
    if unsharded is None:
        with deterministic(dev):
            model = build_model(
                cfg, device=dev, dtype=torch.float32,
                generator=torch.Generator(dev).manual_seed(seed))
            calls = CallLog(model, _fresh(reqs))
            out["unsharded"] = serving_path(model, reqs, SERVE_CACHE_LEN,
                                            card, timed=calls,
                                            label="(13a) unsharded")
        unsharded = calls.logits
        del model, calls
    # (a) One rank (NCCL on the card), mesh (data 1, model 1).
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.FileStore(str(tmp / "store1"), 1),
                            rank=0, world_size=1)
    try:
        print(f"  (13a) {cfg.name}, one rank, backend "
              f"{dist.get_backend()}, mesh (data 1, model 1), "
              f"deterministic algorithms")
        for impl in _shard_impls(cfg):
            model = _shard_model(cfg, dev, seed, impl,
                                 {"data": 1, "model": 1})
            with deterministic(dev):
                rec, calls = _shard_serve(model, _fresh(reqs), card,
                                          f"(13a) {impl}")
            if impl == "sort":
                diff = max(float((x - y).abs().max())
                           for uid, steps in calls.logits.items()
                           for x, y in zip(steps, unsharded[uid]))
                same = all(torch.equal(x, y)
                           for uid, steps in calls.logits.items()
                           for x, y in zip(steps, unsharded[uid]))
                if not (diff <= SHARD_EQUAL_TOL and all(
                        len(calls.logits[u]) == len(unsharded[u])
                        for u in unsharded)):
                    raise AssertionError(f"(13a) sort on (1, 1) is {diff} "
                                         f"from the unsharded logits")
                rec.update(bit_equal=same, max_diff_unsharded=diff)
                print(f"      'sort' against the unsharded logits: "
                      f"{'bit for bit' if same else f'{diff:.3g} apart'}")
            out["one_rank"][impl] = rec
            one[impl] = calls
            calls.model = None
            del model
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    # (b) The sharded ranks, mesh (data 1, model ranks).
    where = ("one card, backend gloo (CUDA tensors through host memory; "
             "NCCL refuses two ranks on one device); the walls below are "
             "processes sharing one card, not a multi-card figure"
             if backend == "gloo" else f"one card each, backend {backend}")
    print(f"  (13b) {cfg.name}, {ranks} ranks on {where}; mesh (data 1, "
          f"model {ranks})")
    t0 = time.perf_counter()
    mp.spawn(_shard_rank, args=(ranks, str(tmp / "store2"), str(tmp), seed,
                                card, cfg, dev.type, backend),
             nprocs=ranks, join=True)
    out["spawn_s"] = time.perf_counter() - t0
    for impl in _shard_impls(cfg):
        by_rank = [torch.load(tmp / f"{impl}_{r}.pt") for r in range(ranks)]
        for other in by_rank[1:]:
            if any(not torch.equal(x, y) for uid, s in
                   by_rank[0]["logits"].items()
                   for x, y in zip(s, other["logits"][uid])):
                raise AssertionError(f"(13b) {impl}: the ranks' logits "
                                     "differ")
        b = types.SimpleNamespace(logits=by_rank[0]["logits"],
                                  router=by_rank[0]["router"])
        row = _compare_served(one[impl], b, cfg, f"(13b) {impl}")
        rec = by_rank[0]["rec"]
        rec["weight_bytes_by_rank"] = [r["rec"]["weight_bytes"]
                                       for r in by_rank]
        rec["peak_bytes_by_rank"] = [r["rec"]["peak_bytes"]
                                     for r in by_rank]
        out["sharded"][impl] = rec
        out["against_one_rank"][impl] = row
        by_layer = {k: [f"{e:.2g}" for e in v]
                    for k, v in row["router_err_by_layer"].items()}
        print(f"      router logits apart by layer: {by_layer}")
        print(f"  (13b) {impl}: weights by rank "
              f"{rec['weight_bytes_by_rank']} bytes, peaks "
              f"{rec['peak_bytes_by_rank']}; built in {rec['build_s']:.2f} "
              f"s; B4 {rec['b4_instance_launches']} on (q, kv) heads "
              f"{rec['heads']}; against one rank: prefill logits "
              f"{row['prefill_err']:.3g} apart (tol {SHARD_TOL['prefill']}),"
              f" decode {row['decode_err']:.3g} (tol "
              f"{SHARD_TOL['decode']}) over {row['steps']} calls; router "
              f"{row['router_err_prefill']:.3g} / "
              f"{row['router_err_decode']:.3g}, {row['unclear']} of "
              f"{row['decisions']} decisions unclear, dropped "
              f"{row['dropped_two_ranks']} / {row['dropped_one_rank']} on "
              f"one rank; parted {row['parted']}  [{card}]")
    bad = [v for impl in _shard_impls(cfg)
           for v in out["against_one_rank"][impl]["violations"]]
    if bad:
        raise AssertionError(f"(13b) {len(bad)} checks failed: {bad[:20]}")
    drops = {impl: out["sharded"][impl]["dropped_per_prefill"]
             for impl in _shard_impls(cfg)}
    out["dropped_per_prefill"] = drops
    out["longest_prompt"] = max(len(r.prompt) for r in reqs)
    print(f"  (13b) dropped assignments per prefill: " + ", ".join(
        f"{impl!r} {d}" for impl, d in drops.items()))
    return out


def shard_phase(dev, card, seed, abench, rng, ptxas, unsharded):
    """Phase 13 (module comment above); ``unsharded`` holds phase 11's
    olmoe logits by request. Returns the record and the ``kernels``
    row."""
    from repro_torch.configs import get_config

    t_phase = time.perf_counter()
    cfg = get_config(SHARD_ARCH)
    out = shard_serving(dev, card, seed, cfg, unsharded)

    # (c) B4 at the local-head instance, the longest served prompt.
    s_max = out["longest_prompt"]
    shape = (1, cfg.num_heads // SHARD_MODEL,
             cfg.num_kv_heads // SHARD_MODEL, s_max, s_max, cfg.head_dim,
             True, "float32")
    row = abench.run(shape, rng)
    print_b4_row(row)
    regs = _b4_ptxas(ptxas, cfg.head_dim)
    if regs is not None:
        print(f"      {regs['function']}: {regs['registers']} registers, "
              f"stack / spill store / spill load {regs['stack']} / "
              f"{regs['spill_stores']} / {regs['spill_loads']} B")
    launches = {impl: out["sharded"][impl]["launches"]["flash_attention"]
                for impl in _shard_impls(cfg)}
    kernel = {
        "name": "flash_attention", "route": "cuda", "source": B4_SOURCE,
        "replaces": B4_REPLACES, "launches": launches["sort"],
        "launches_by_impl": launches,
        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"], "library_ms": row["library_ms"],
        "shape": row["shape"], "call_ms": row["call_ms"],
        "bounds": row["bounds"],
        "variant": f"fa_forward_kernel<float32, {cfg.head_dim}>, "
                   f"{SHARD_ARCH} prefill on model {SHARD_MODEL}: "
                   f"{shape[1]}/{shape[2]} local heads a rank",
        "ptxas": regs}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  (13) {out['phase_s']:.1f} s in all  [{card}]")
    return out, kernel


# Phase 14: training every family and the sharded train step. (f)
# rwkv6-1.6b, zamba2-2.7b and whisper-base through launch.train.run at
# their published widths and full depth (weights drawn on the card from
# --seed, AdamW, the dedup stage on: B3 launched, B4 not), FAMILY_TRAIN
# sequences x tokens a step: the most that fits the card beside AdamW
# (rwkv6 at 8 x 1,024 and zamba2 at 2 x 1,024 ran out of memory; whisper
# at phase 10's 8 x 1,024), FAMILY_TRAIN_STEPS steps; then a fail at
# FAMILY_TRAIN_FAIL_AT and a resume equal bit for bit to an uninterrupted
# run, at FAMILY_RESTART's depth; then the four families' smoke configs, 2
# steps on the card against the CPU from the same state (phase 10's 1e-5
# loss, 1e-3 grad_norm, relative). (g) smollm-135m at full width, phase
# 10's 8 x 1,024 tokens and optimizer, SHARD_TRAIN_STEPS steps: the
# unsharded step and one NCCL rank on (1, 1) (every collective a counted
# pass-through; the same operations, so bit for bit equal), then two gloo
# ranks of the one card on (2, 1) (ZeRO rows over data, data-parallel,
# gradients reduce-scattered), its checkpoint saved from the shards, and
# on (1, 2) (the SwiGLU and the vocabulary split, attention replicated: 9
# heads on 2), its params and moments read at STATE_SAMPLES seeded positions
# a leaf: losses within 1e-5 and grad_norm within 1e-3 of (1, 1)'s
# (relative, phase 10's), the (2, 1) checkpoint against the arrays a
# (1, 1) save writes and the (1, 2) positions against (1, 1)'s, within the
# bounds below; the (2, 1) checkpoint restored into an unsharded model.
# (h) olmoe-1b-7b at its published widths cut to MOE_TRAIN_LAYERS of 16
# layers, 'sort' on the expert-parallel plan, MOE_TRAIN_STEPS steps of 8 x
# 1,024 tokens on (1, 1) and on (1, 2) (two gloo ranks, 32 experts each):
# losses and grad_norm as (g), params and first moments at STATE_SAMPLES
# seeded positions a leaf (MOE_MOMENT_TOL); the first step's router
# logits within SHARD_ROUTER_TOL's prefill bound, the experts equal at
# every clear decision of (1, 1)'s and the drops equal where all are
# clear.
FAMILY_TRAIN = {"rwkv6-1.6b": (4, 1024), "zamba2-2.7b": (2, 512),
                "whisper-base": (8, 1024)}
FAMILY_TRAIN_STEPS = 2
FAMILY_TRAIN_FAIL_AT = 1
# The families that restart, and at what depth (config fields replaced):
# a checkpoint holds 12 bytes a weight (weights and two f32 moments), and
# writing, hashing, reading and checking one took ~9.5 s a GB on an NVIDIA
# H100 80GB HBM3 host. whisper-base restarts at full depth (1.3 GB).
# rwkv6-1.6b and zamba2-2.7b restarted at one layer and one group of two
# Mamba2 layers and the shared block until phase 15 came (3.9 and 4.2 GB,
# 40.3 and 44.1 s of the smoke, my chip call 3, PR 25; their embedding and
# head are most of it, so no depth cuts them further); their fail and
# resume are held bit for bit on the CPU (tests/test_torch_train_families).
FAMILY_RESTART = {"whisper-base": {}}
FAMILY_SMOKE_ARCHS = ("rwkv6-1.6b", "zamba2-2.7b", "whisper-base",
                      "llama-3.2-vision-90b")
FAMILY_SMOKE_SHAPE = (2, 64)
SHARD_TRAIN_ARCH = "smollm-135m"
SHARD_TRAIN_STEPS = 2           # 3 until phase 15 came (PR 25)
MOE_TRAIN_ARCH = "olmoe-1b-7b"
MOE_TRAIN_LAYERS = 2
MOE_TRAIN_STEPS = 2
MOE_TRAIN_SHAPE = (8, 1024)
STATE_SAMPLES = 65536
TRAIN_OC = dict(lr=1e-3, warmup_steps=5, total_steps=20)   # phase 10's
# A sharded step sums its gradients in another order than one rank's, so
# a gradient whose true value is near zero may change sign; Adam's update
# of that weight is then ~±lr (its first update is the gradient's sign),
# so a weight may move by up to 2·lr a step, lr summed over the steps. All
# other elements stay within 1e-4 of their leaf's largest value; at most
# SHARD_PARAM_SHARE of a leaf's elements may lie past that (the CPU
# tests' bounds, tests/test_torch_train.py). A moment follows its
# gradient: within 1e-3 of its leaf's largest value.
SHARD_PARAM_SHARE = 1e-3
SHARD_MOMENT_TOL = 1e-3
# (h): a token whose routing parts at an unclear top-k decision (the two
# runs' router logits ~1e-6 apart) takes other experts, which moves the
# gradient of every leaf its activations reach: on an NVIDIA H100 80GB
# HBM3 (700 W) the final norm's first moment moved by 0.6 % of its largest
# value, so the moments are held to 2 % and the params to the Adam bound.
MOE_MOMENT_TOL = 2e-2


@contextlib.contextmanager
def _launcher_depth(fields):
    """While active, ``launch.train`` builds its configs with ``fields``
    replaced (a depth cut at the published widths)."""
    from repro_torch.launch import train

    inner = train.get_config
    if fields:
        train.get_config = lambda arch: dataclasses.replace(inner(arch),
                                                            **fields)
    try:
        yield
    finally:
        train.get_config = inner


def family_training(arch, dev, card, seed):
    """(f) One family through ``launch.train.run`` at full width and
    depth; then, for a family of FAMILY_RESTART, fail and resume at its
    depth there, against an uninterrupted run at that depth. Returns the
    record."""
    import shutil
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa, mis_pivot
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.train.fault import SimulatedFailure

    b, s = FAMILY_TRAIN[arch]
    n_weights = sum(p.numel() for p in build_model(
        get_config(arch), device="meta").parameters())
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ftrain_"))
    common = dict(arch=arch, smoke=False, seq_len=s, global_batch=b,
                  steps=FAMILY_TRAIN_STEPS, dedup=True, seed=seed,
                  log_every=100, device=dev)
    k = FAMILY_TRAIN_FAIL_AT
    fields = FAMILY_RESTART.get(arch)
    try:
        mis_pivot.reset_launch_counts()
        fa.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            whole = train.run(ckpt_dir=None, resume=False, fail_at=None,
                              **common)
        sync(dev)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        b3 = mis_pivot.launches["mis_pivot"]
        b4 = fa.launches["flash_attention"]
        losses = whole["losses"]
        if not (len(losses) == FAMILY_TRAIN_STEPS
                and np.isfinite(losses).all()):
            raise AssertionError(f"(14f) {arch} losses {losses}")
        if dev.type == "cuda" and (b3 < 1 or b4 != 0):
            raise AssertionError(f"(14f) {arch}: B3 launched {b3} times, B4 "
                                 f"{b4} (want >= 1 and 0)")
        torch.cuda.empty_cache()
        restart_s = ckpt_bytes = None
        if fields is not None:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()), \
                    _launcher_depth(fields):
                want = losses if not fields else train.run(
                    ckpt_dir=None, resume=False, fail_at=None,
                    **common)["losses"]
                try:
                    train.run(ckpt_dir=str(tmp), resume=False, fail_at=k,
                              ckpt_every=k, **common)
                except SimulatedFailure:
                    pass
                else:
                    raise AssertionError(f"(14f) {arch}: --fail-at raised "
                                         "nothing")
                ckpt_bytes = sum(f.stat().st_size for f in tmp.rglob("*")
                                 if f.is_file())
                torch.cuda.empty_cache()
                resumed = train.run(ckpt_dir=str(tmp), resume=True,
                                    fail_at=None, ckpt_every=k, **common)
            restart_s = time.perf_counter() - t0
            if resumed["losses"] != want[k:]:
                raise AssertionError(f"(14f) {arch}: resumed losses "
                                     f"{resumed['losses']} differ from "
                                     f"{want[k:]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    # The first step also warms the card's kernels up; the others time it.
    step_ms = float(np.median(whole["step_s"][1:])) * 1e3
    depth = (None if fields is None else "full depth" if not fields
             else ", ".join(f"{k} {v}" for k, v in fields.items()))
    rec = dict(batch=b, seq=s, steps=FAMILY_TRAIN_STEPS, wall_s=wall,
               losses=losses, step_s=whole["step_s"], median_step_ms=step_ms,
               tokens_per_s=b * s / step_ms * 1e3, peak_bytes=peak,
               weights=n_weights, state_bytes=16 * n_weights,
               b3_launches_dedup=b3, b4_launches=b4,
               restart_bitwise=None if fields is None else True,
               restart_depth=depth, restart_s=restart_s,
               checkpoint_bytes=ckpt_bytes)
    restart = ("no restart on the card" if fields is None else
               f"at {depth}, fail at {k} + resume bit for bit ({ckpt_bytes} "
               f"checkpoint bytes, {restart_s:.1f} s)")
    print(f"  (14f) {arch} full width and depth ({n_weights} weights, "
          f"{16 * n_weights / 2**30:.1f} GiB with AdamW), {b} x {s} tokens, "
          f"{FAMILY_TRAIN_STEPS} steps: wall {wall:.2f} s, median step "
          f"{step_ms:.2f} ms ({rec['tokens_per_s']:.1f} tokens/s), peak "
          f"{peak / 2**30:.2f} GiB, loss {losses[0]:.4f} -> {losses[-1]:.4f};"
          f" B3 {b3}, B4 {b4}; {restart}  [{card}]")
    return rec


def _carry_state(dst, src):
    """Copy the train state ``src`` into ``dst``'s tensors (any devices);
    returns ``dst`` with ``src``'s step."""
    with torch.no_grad():
        for n, t in dst.params.items():
            t.copy_(src.params[n])
        for part in ("mu", "nu"):
            for n, t in getattr(dst.opt, part).items():
                t.copy_(getattr(src.opt, part)[n])
    return dst._replace(opt=dst.opt._replace(step=src.opt.step))


def family_smoke_against_cpu(dev, card, seed):
    """(f) Each family's smoke config, the launcher's smoke settings, two
    steps on the card and on the CPU, each from the CPU's state, with
    stub embeddings drawn from the seed."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch import train
    from repro_torch.models import build_model
    from repro_torch.train import optimizer, train_step

    b, s = FAMILY_SMOKE_SHAPE
    out = {}
    for arch in FAMILY_SMOKE_ARCHS:
        cfg = get_smoke(arch)
        rc = train.run_config(cfg, True, s)
        oc = optimizer.OptConfig(**TRAIN_OC)
        sides = {}
        for side, d in (("cpu", torch.device("cpu")), ("card", dev)):
            model = build_model(cfg, device=d, rc=rc,
                                generator=torch.Generator().manual_seed(seed))
            sides[side] = [train_step.init_train_state(model, oc),
                           train_step.make_train_step(model, oc)]
        rng = np.random.default_rng([seed, 14, FAMILY_SMOKE_ARCHS.index(
            arch)])
        rows = []
        for i in range(2):
            sides["card"][0] = _carry_state(sides["card"][0],
                                            sides["cpu"][0])
            batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
                     "labels": rng.integers(0, cfg.vocab_size, (b, s))}
            batch = {k: torch.from_numpy(v.astype(np.int32))
                     for k, v in batch.items()}
            for key, stub in stub_inputs(cfg, rng,
                                         torch.device("cpu")).items():
                batch[key] = stub.expand(b, *stub.shape[1:]).contiguous()
            sides["cpu"][0], want = sides["cpu"][1](sides["cpu"][0], batch)
            with train.deterministic(dev):
                sides["card"][0], got = sides["card"][1](
                    sides["card"][0], {k: v.to(dev) for k, v in batch.items()})
            row = {k: (float(got[k]), float(want[k]))
                   for k in ("loss", "grad_norm", "lr")}
            for k, tol in (("loss", TRAIN_LOSS_TOL),
                           ("grad_norm", TRAIN_GNORM_TOL)):
                g, w = row[k]
                if not abs(g - w) <= tol * abs(w):
                    raise AssertionError(f"(14f) {arch} smoke step {i} {k}: "
                                         f"card {g}, CPU {w} (tolerance "
                                         f"{tol} relative)")
            if row["lr"][0] != row["lr"][1]:
                raise AssertionError(f"(14f) {arch} smoke step {i} lr "
                                     f"{row['lr']}")
            rows.append(row)
        out[arch] = rows
        print(f"  (14f) {arch} smoke, 2 steps against the CPU: loss "
              + ", ".join(f"{r['loss'][0]:.6f} / {r['loss'][1]:.6f}"
                          for r in rows) + "; grad_norm "
              + ", ".join(f"{r['grad_norm'][0]:.5f} / {r['grad_norm'][1]:.5f}"
                          for r in rows) + f"  [{card}]")
    return out


def _smollm_batches(cfg, seed, n):
    from repro_torch.launch import train

    pipe = train.build_pipeline(cfg, TRAIN_SEQ, TRAIN_BATCH, dedup=False,
                                seed=seed, device="cpu")
    return [{k: torch.from_numpy(v) for k, v in pipe.batch_at(i).items()}
            for i in range(n)]


def _moe_batches(cfg, seed, n):
    b, s = MOE_TRAIN_SHAPE
    rng = np.random.default_rng([seed, 14, 8])
    return [{k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)
                                              ).astype(np.int32))
             for k in ("tokens", "labels")} for _ in range(n)]


def _moe_cfg(smoke, arch=MOE_TRAIN_ARCH):
    from repro_torch.configs import get_config, get_smoke

    cfg = (get_smoke if smoke else get_config)(arch)
    return dataclasses.replace(cfg, num_layers=min(cfg.num_layers,
                                                   MOE_TRAIN_LAYERS))


def _samples(state, seed, layout=None, specs=None) -> dict:
    """Each parameter's and first moment's values at STATE_SAMPLES positions
    of the whole leaf drawn from ``seed`` and the leaf's order (the same on
    every side and mesh), on the host. On a mesh (``layout``, the leaves'
    ``specs``) each rank reads the positions inside its block, zeros
    elsewhere, summed over the leaf's split axes: the whole leaves are
    never gathered."""
    from repro_torch.models.sharding import entry_axes
    from repro_torch.train.optimizer import sharded_axes

    out = {}
    for i, (name, t) in enumerate(state.params.items()):
        spec = specs[name] if layout is not None else ()
        spans = [layout.span(entry_axes(spec[d])) if d < len(spec) else 1
                 for d in range(t.dim())] if layout is not None else \
            [1] * t.dim()
        whole = [n * k for n, k in zip(t.shape, spans)]
        numel = int(np.prod(whole))
        flat = np.random.default_rng([seed, 14, 9, i]).integers(
            0, numel, min(numel, STATE_SAMPLES))
        pos = np.unravel_index(flat, whole)
        inside = np.ones(flat.shape, bool)
        local = []
        for d, (n, k) in enumerate(zip(t.shape, spans)):
            first = (layout.index(entry_axes(spec[d])) * n
                     if layout is not None and d < len(spec) else 0)
            inside &= (pos[d] >= first) & (pos[d] < first + n)
            local.append(np.clip(pos[d] - first, 0, n - 1))
        keep = torch.from_numpy(inside)
        for part, src in (("params", t), ("mu", state.opt.mu[name])):
            idx = tuple(torch.from_numpy(a).to(src.device) for a in local)
            vals = torch.where(keep.to(src.device), src.detach()[idx],
                               torch.zeros((), dtype=src.dtype,
                                           device=src.device))
            ax = sharded_axes(layout, spec) if layout is not None else ()
            if ax:
                vals = layout.all_reduce(vals, ax)
            out[f"{part}:{name}"] = vals.cpu()
    return out


def _train_on_mesh(cfg, dev, seed, axes, batches, rc_fields=None,
                   ckpt=None, log=None, gather=None, constants=False):
    """Train ``cfg`` ``len(batches)`` steps from weights drawn on ``dev``
    from ``seed``, on the mesh ``axes`` of the
    initialised group (None: unsharded), under deterministic algorithms.
    Returns the record: losses, grad_norms, lrs, step walls, the last
    step's collective calls and bytes by kind, the rank's state bytes,
    the peak; ``ckpt``: the final state saved there (from the shards);
    ``gather``: 'state' keeps the final state, 'samples' its
    :func:`_samples`; ``log`` (a RouterLog) keeps the first step's router
    calls; ``constants``: the leaves that start at constants drawn from
    the seed (:func:`move_constants`)."""
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model, parallel
    from repro_torch.models.sharding import resolve_plan
    from repro_torch.models.transformer import RunConfig
    from repro_torch.train import optimizer, train_step
    from repro_torch.train.checkpoint import save_checkpoint

    kw = {}
    if axes is not None:
        mesh = make_mesh(axes)
        kw = dict(plan=resolve_plan(cfg, None, axes), mesh=mesh)
    rc = RunConfig(attn_impl="chunked",
                   loss_chunk=min(256, batches[0]["tokens"].shape[1]),
                   **(rc_fields or {}))
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device=dev, rc=rc,
                        generator=torch.Generator(dev).manual_seed(seed),
                        **kw)
    if constants:
        move_constants(model, seed + 1)
    oc = optimizer.OptConfig(**TRAIN_OC)
    state = train_step.init_train_state(model, oc)
    step_fn = train_step.make_train_step(model, oc)
    rec = {"losses": [], "grad_norms": [], "lrs": [], "step_s": []}
    with train.deterministic(dev):
        for i, batch in enumerate(batches):
            batch = {k: v.to(dev) for k, v in batch.items()}
            parallel.reset_counts()
            with (log if log is not None and i == 0 else nullcontext()):
                t0 = time.perf_counter()
                state, m = step_fn(state, batch)
                rec["losses"].append(float(m["loss"]))
                rec["step_s"].append(time.perf_counter() - t0)
            rec["grad_norms"].append(float(m["grad_norm"]))
            rec["lrs"].append(float(m["lr"]))
            rec["collectives"] = parallel.snapshot()
    rec["state_bytes"] = sum(t.numel() * t.element_size() for part in (
        state.params, state.opt.mu, state.opt.nu) for t in part.values())
    rec["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else None
    if ckpt is not None:
        save_checkpoint(ckpt, len(batches), state, layout=model.layout)
    if gather == "state":
        rec["state"] = state
    elif gather == "samples":
        rec["samples"] = _samples(state, seed, model.layout,
                                  model.param_specs())
    if log is not None:
        rec["router"] = [{k: v.detach().cpu() if torch.is_tensor(v) else v
                          for k, v in c.items()} for c in log.take()]
    return rec


def _collective_line(rec) -> str:
    return ", ".join(f"{k} {v['calls']} ({v['bytes']} B)"
                     for k, v in rec["collectives"].items())


def _train_meshes(ranks):
    """(14g)'s meshes of ``ranks`` ranks, (data, model): ZeRO and data
    parallel, then tensor parallel."""
    return ((ranks, 1), (1, ranks))


def _train_rank(rank, world, store, out_dir, seed, cfg, mcfg, dev_type,
                backend):
    """(14g)/(14h) one rank of ``world`` in a ``backend`` group, on card
    ``rank`` modulo the cards there are, on the parent's batches: ``cfg``
    (smollm) on each mesh of :func:`_train_meshes`, the first saving its
    checkpoint from the shards, the second reading its state at
    :func:`_samples`' positions; ``mcfg`` (the olmoe cut) on (1, world).
    Records for the parent."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    dev = torch.device(dev_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        batches, mbatches = torch.load(os.path.join(out_dir, "batches.pt"))
        out = {}
        (d0, m0), (d1, m1) = _train_meshes(world)
        if cfg is not None:
            out[f"{d0}x{m0}"] = _train_on_mesh(
                cfg, dev, seed, {"data": d0, "model": m0}, batches,
                ckpt=os.path.join(out_dir, f"ckpt_{d0}x{m0}"))
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            out[f"{d1}x{m1}"] = _train_on_mesh(
                cfg, dev, seed, {"data": d1, "model": m1}, batches,
                gather="samples")
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        if mcfg is not None:
            out["moe"] = _train_on_mesh(
                mcfg, dev, seed, {"data": 1, "model": world}, mbatches,
                rc_fields={"moe_impl": "sort"},
                log=RouterLog(1.25, logits=True), gather="samples")
        torch.save(out, os.path.join(out_dir, f"train_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _within(a, b, bound, scale, share):
    """(max difference, share of elements past 1e-4 of ``scale``); raises
    where the max passes ``bound`` or the share ``share``."""
    diff = (a.float() - b.float()).abs()
    worst = float(diff.max()) if diff.numel() else 0.0
    past = float((diff > 1e-4 * max(scale, 1e-3)).float().mean())
    if not (worst <= bound + 1e-6 * max(scale, 1e-3) and past <= share):
        raise AssertionError(f"max difference {worst} (bound {bound}), "
                             f"{past} of the elements past 1e-4 of {scale}")
    return worst, past


def _compare_leaves(pairs, lr_sum, what):
    """Each (part, key, got, want) of a sharded run against (1, 1): params
    within 2·lr_sum and at most SHARD_PARAM_SHARE of a leaf past 1e-4 of
    its largest value, moments within SHARD_MOMENT_TOL of it. Returns the
    largest differences by part."""
    worst = {"params": 0.0, "mu": 0.0, "nu": 0.0}
    for part, key, got, want in pairs:
        scale = float(want.abs().max())
        bound = (2.0 * lr_sum * 1.001 if part == "params"
                 else SHARD_MOMENT_TOL * max(scale, 1e-3))
        try:
            w, _ = _within(got, want, bound, scale, SHARD_PARAM_SHARE)
        except AssertionError as e:
            raise AssertionError(f"{what}: {key}: {e}") from None
        worst[part] = max(worst[part], w)
    return worst


def _compare_arrays(got, want, lr_sum, what):
    """A sharded run's checkpoint arrays against the arrays (1, 1)'s state
    saves as, leaf by leaf (:func:`_compare_leaves`); the step equal."""
    prefix = {".params": "params", ".opt/.mu": "mu", ".opt/.nu": "nu"}
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}: the checkpoints' keys differ")
    pairs = []
    for key, w in want.items():
        part = next((v for p, v in prefix.items()
                     if key.startswith(p + "/")), None)
        if part is None:
            if not np.array_equal(got[key], w):
                raise AssertionError(f"{what}: {key} differs")
            continue
        pairs.append((part, key, torch.from_numpy(got[key]),
                      torch.from_numpy(w)))
    return _compare_leaves(pairs, lr_sum, what)


def _against(rec, want, what, loss_tol=TRAIN_LOSS_TOL,
             gnorm_tol=TRAIN_GNORM_TOL):
    for k, tol in (("losses", loss_tol), ("grad_norms", gnorm_tol)):
        for i, (g, w) in enumerate(zip(rec[k], want[k])):
            if not abs(g - w) <= tol * abs(w):
                raise AssertionError(f"{what} step {i} {k}: {g} against "
                                     f"{w} (tolerance {tol} relative)")
    if rec["lrs"] != want["lrs"]:
        raise AssertionError(f"{what} lr {rec['lrs']} against {want['lrs']}")
    return {"loss_err": max(abs(g - w) for g, w in zip(rec["losses"],
                                                         want["losses"])),
            "grad_norm_err": max(abs(g - w) for g, w in zip(
                rec["grad_norms"], want["grad_norms"]))}


def _print_mesh(label, rec, tokens, card, extra=""):
    step_ms = float(np.median(rec["step_s"])) * 1e3
    rec["median_step_ms"] = step_ms
    rec["tokens_per_s"] = tokens / step_ms * 1e3
    print(f"  {label}: median step {step_ms:.2f} ms "
          f"({rec['tokens_per_s']:.1f} tokens/s), losses "
          f"{[round(x, 6) for x in rec['losses']]}, state "
          f"{rec['state_bytes']} B a rank, peak {rec['peak_bytes']} B; a "
          f"step's collectives: {_collective_line(rec)}{extra}  [{card}]")


def _moe_against(moe, moe_one, mcfg):
    """(14h) the sharded olmoe against (1, 1): losses and grad_norm
    (:func:`_against`); params within 2·lr summed (the bound any two Adam
    runs keep) and moments within MOE_MOMENT_TOL at the sampled positions,
    with the share of each leaf's samples past 1e-4 of its largest value
    reported (a token whose routing parts at an unclear top-k decision
    takes other experts, and its gradients move every leaf they reach);
    the first step's router logits within SHARD_ROUTER_TOL's prefill
    bound, the experts equal at every clear decision and the drops equal
    where all are clear, the tokens that part counted."""
    moe.update(_against(moe, moe_one, "(14h) (1, N)"))
    lr_moe = sum(moe_one["lrs"])
    worst = {"params": 0.0, "mu": 0.0}
    share = {}
    for key, want in moe_one["samples"].items():
        part = key.split(":")[0]
        scale = float(want.abs().max())
        bound = (2.0 * lr_moe * 1.001 if part == "params"
                 else MOE_MOMENT_TOL * max(scale, 1e-3))
        try:
            w, past = _within(moe["samples"][key], want, bound, scale, 1.0)
        except AssertionError as e:
            raise AssertionError(f"(14h) {key}: {e}") from None
        worst[part] = max(worst[part], w)
        share[key] = past
    routing = {"router_err_prefill": 0.0, "router_err_decode": 0.0,
               "decisions": 0, "unclear": 0, "dropped_cpu": 0,
               "dropped_card": 0}
    _routing_agrees(moe_one["router"], moe["router"], mcfg.experts_per_tok,
                    routing, SHARD_ROUTER_TOL["prefill"])
    parted = sum(int((~(a["experts"].sort(dim=-1).values
                        == b["experts"].sort(dim=-1).values).all(dim=-1)
                      ).sum())
                 for a, b in zip(moe_one["router"], moe["router"]))
    moe["samples_err"] = worst
    moe["share_past"] = {k: v for k, v in share.items() if v > 0}
    moe["routing"] = {"router_err": routing["router_err_prefill"],
                      "decisions": routing["decisions"],
                      "unclear": routing["unclear"], "parted": parted,
                      "dropped_one_rank": routing["dropped_cpu"],
                      "dropped_two_ranks": routing["dropped_card"]}
    for r in (moe, moe_one):
        del r["samples"], r["router"]


def shard_training(dev, card, seed, smoke=False, ranks=2, backend="gloo",
                   arch=SHARD_TRAIN_ARCH, moe_arch=MOE_TRAIN_ARCH):
    """(14g) and (14h): one rank and the unsharded model in this process,
    then ``ranks`` spawned ranks in a ``backend`` group (gloo: all on the
    one card; NCCL: one a card): ``arch`` (a dense config, None: none) as
    (14g), ``moe_arch`` (an MoE config, None: none) cut as (14h). Returns
    the record."""
    import shutil
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.models import build_model
    from repro_torch.train import checkpoint, optimizer, train_step

    cfg = mcfg = None
    batches = mbatches = None
    if arch is not None:
        cfg = (get_smoke if smoke else get_config)(arch)
        batches = _smollm_batches(cfg, seed, SHARD_TRAIN_STEPS)
        tokens = batches[0]["tokens"].numel()
    if moe_arch is not None:
        mcfg = _moe_cfg(smoke, moe_arch)
        mbatches = _moe_batches(mcfg, seed, MOE_TRAIN_STEPS)
    out: dict = {"ranks": ranks, "backend": backend}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_strain_"))
    try:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.FileStore(str(tmp / "store1"), 1),
                                rank=0, world_size=1)
        try:
            if cfg is not None:
                print(f"  (14g) {cfg.name}, {TRAIN_BATCH} x {TRAIN_SEQ} "
                      f"tokens, {SHARD_TRAIN_STEPS} steps; unsharded and one "
                      f"rank "
                      f"(backend {dist.get_backend()}, mesh (1, 1)), "
                      f"deterministic algorithms")
                plain = _train_on_mesh(cfg, dev, seed, None, batches,
                                       gather="state")
                _print_mesh("(14g) unsharded", plain, tokens, card)
                one = _train_on_mesh(cfg, dev, seed, {"data": 1, "model": 1},
                                     batches, gather="state")
                a, b = one.pop("state"), plain.pop("state")
                same = (one["losses"] == plain["losses"]
                        and one["grad_norms"] == plain["grad_norms"]
                        and all(torch.equal(t, b.params[n])
                                for n, t in a.params.items())
                        and all(torch.equal(t, getattr(b.opt, part)[n])
                                for part in ("mu", "nu")
                                for n, t in getattr(a.opt, part).items()))
                if not same:
                    raise AssertionError("(14g) (1, 1) is not bit for bit the "
                                         "unsharded step")
                # What a (1, 1) save writes, and (1, 1)'s sampled positions.
                want_arrays = checkpoint._arrays(a)
                one["samples"] = _samples(a, seed)
                del a, b
                _print_mesh("(14g) (1, 1)", one, tokens, card,
                            "; bit for bit the unsharded step (losses, "
                            "grad_norm, params, moments)")
                out["unsharded"], out["1x1"] = plain, one
                torch.cuda.empty_cache()
            if mcfg is not None:
                moe_one = _train_on_mesh(
                    mcfg, dev, seed, {"data": 1, "model": 1}, mbatches,
                    rc_fields={"moe_impl": "sort"},
                    log=RouterLog(1.25, logits=True), gather="samples")
                _print_mesh(f"(14h) {mcfg.name} at {mcfg.num_layers} layers, "
                            f"{MOE_TRAIN_SHAPE[0]} x {MOE_TRAIN_SHAPE[1]} "
                            f"tokens, 'sort', (1, 1)", moe_one,
                            mbatches[0]["tokens"]
                            .numel(), card)
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()

        where = ("one card, backend gloo (CUDA tensors through host memory; "
                 "NCCL refuses two ranks on one device); the walls are "
                 "processes sharing one card, not a multi-card figure"
                 if backend == "gloo" else f"one card each, backend {backend}")
        print(f"  (14g) {ranks} ranks on {where}")
        torch.save((batches, mbatches), tmp / "batches.pt")
        t0 = time.perf_counter()
        mp.spawn(_train_rank, args=(ranks, str(tmp / "store2"), str(tmp),
                                    seed, cfg, mcfg, dev.type, backend),
                 nprocs=ranks, join=True)
        out["spawn_s"] = time.perf_counter() - t0
        recs = [torch.load(tmp / f"train_{r}.pt") for r in range(ranks)]
        if cfg is not None:
            lr_sum = sum(one["lrs"])
            (d0, m0), (d1, m1) = _train_meshes(ranks)
            for data, model in ((d0, m0), (d1, m1)):
                tag = f"{data}x{model}"
                for r in recs[1:]:
                    if r[tag]["losses"] != recs[0][tag]["losses"]:
                        raise AssertionError(f"(14g) {tag}: the ranks' losses "
                                             "differ")
                rec = recs[0][tag]
                rec["state_bytes_by_rank"] = [r[tag]["state_bytes"]
                                              for r in recs]
                rec["peak_bytes_by_rank"] = [r[tag]["peak_bytes"]
                                             for r in recs]
                rec.update(_against(rec, one, f"(14g) {tag}"))
                if (data, model) == (d0, m0):
                    with np.load(tmp / f"ckpt_{tag}" / f"step_"
                                 f"{SHARD_TRAIN_STEPS:08d}"
                                 / "arrays.npz") as f:
                        saved = {k: f[k] for k in f.files}
                    rec["state_err"] = _compare_arrays(
                        saved, want_arrays, lr_sum, f"(14g) {tag} checkpoint")
                else:
                    rec["state_err"] = _compare_leaves(
                        ((key.split(":")[0], key, rec["samples"][key], w)
                         for key, w in one["samples"].items()), lr_sum,
                        f"(14g) {tag} at {STATE_SAMPLES} positions a leaf")
                    del rec["samples"]
                out[tag] = rec
                _print_mesh(f"(14g) ({data}, {model})", rec, tokens, card,
                            f"; against (1, 1): loss {rec['loss_err']:.3g}, "
                            f"grad_norm {rec['grad_norm_err']:.3g}, "
                            + ("checkpoint from the shards (params, mu, nu) "
                               if model == 1 else
                               f"params, mu at {STATE_SAMPLES} positions a "
                               "leaf ") + f"{rec['state_err']}; "
                            f"state by rank {rec['state_bytes_by_rank']}")
            del one["samples"], want_arrays
            # The (N, 1) checkpoint into the unsharded model.
            model = build_model(cfg, device=dev,
                                generator=torch.Generator(dev).manual_seed(
                                    seed + 1))
            state = train_step.init_train_state(
                model, optimizer.OptConfig(**TRAIN_OC))
            tag = f"{d0}x{m0}"
            state, manifest = checkpoint.restore_checkpoint(
                tmp / f"ckpt_{tag}", state)
            back = checkpoint._arrays(state)
            if sorted(back) != sorted(saved) or any(
                    back[k].tobytes() != saved[k].tobytes() for k in saved):
                raise AssertionError(f"(14g) the {tag} checkpoint did not "
                                     "restore into the unsharded model")
            print(f"  (14g) the ({d0}, {m0}) checkpoint restores into the "
                  f"unsharded model, every leaf byte for byte")
            del model, state, back, saved
            torch.cuda.empty_cache()

        if mcfg is not None:
            moe = recs[0]["moe"]
            for r in recs[1:]:
                if r["moe"]["losses"] != moe["losses"]:
                    raise AssertionError("(14h) the ranks' losses differ")
            moe["state_bytes_by_rank"] = [r["moe"]["state_bytes"]
                                          for r in recs]
            moe["peak_bytes_by_rank"] = [r["moe"]["peak_bytes"] for r in recs]
            _moe_against(moe, moe_one, mcfg)
            out["moe_1x1"], out[f"moe_1x{ranks}"] = moe_one, moe
            _print_mesh(f"(14h) (1, {ranks})", moe,
                        mbatches[0]["tokens"].numel(), card,
                        f"; against (1, 1): loss {moe['loss_err']:.3g}, "
                        f"grad_norm {moe['grad_norm_err']:.3g}, params / mu "
                        f"at {STATE_SAMPLES} positions a leaf "
                        f"{moe['samples_err']}, "
                        f"share past 1e-4 {moe['share_past']}; first step's "
                        f"routing {moe['routing']}; state by rank "
                        f"{moe['state_bytes_by_rank']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def train_families_phase(dev, card, seed):
    """Phase 14 (module comment above). Returns the record."""
    t_phase = time.perf_counter()
    out = {"families": {}, "walls_s": {}}
    for arch in FAMILY_TRAIN:
        t0 = time.perf_counter()
        out["families"][arch] = family_training(arch, dev, card, seed)
        out["walls_s"][arch] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["smoke_against_cpu"] = family_smoke_against_cpu(dev, card, seed)
    out["walls_s"]["smoke_against_cpu"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["sharded"] = shard_training(dev, card, seed)
    out["walls_s"]["sharded"] = time.perf_counter() - t0
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  (14) walls: " + ", ".join(f"{k} {v:.1f} s"
                                       for k, v in out["walls_s"].items()))
    print(f"  (14) {out['phase_s']:.1f} s in all  [{card}]")
    return out


# Phase 15: the four other families on a mesh (ROADMAP 18d-2), at their
# published widths, f32 weights drawn on the card from --seed, under
# deterministic algorithms. (a) Serving, cut to SHARD_FAMILY_CUTS: the
# unsharded model, then one NCCL rank on (1, 1) (bit for bit: logits and
# recurrent states), then SHARD_FAMILY_MODEL gloo ranks of the one card on
# (1, 2) in lockstep (each holds its blocks and raises if its greedy
# tokens differ from rank 0's), each through Model.prefill / decode_step on
# SHARD_FAMILY_REQUESTS requests with stub embeddings drawn from the seed:
# prefill logits within SHARD_FAMILY_TOL's 1e-4 of (1, 1)'s, decode 5e-2
# (phase 13's: bf16 caches), greedy tokens equal where (1, 1)'s top-2
# margin exceeds twice the limit, the WKV and SSD states after prefill
# within 1e-4 of their largest value; B4 launched a prefill at each
# local-head instance and no other. (b) Training, cut to
# SHARD_FAMILY_TRAIN_CUTS, SHARD_FAMILY_TRAIN_STEPS steps of
# SHARD_FAMILY_TRAIN_SHAPE tokens (the launcher's full-size RunConfig):
# unsharded and (1, 1) bit for bit, then (1, 2) on the gloo ranks, and
# (2, 1) on NCCL only: losses 1e-5 and grad_norm 1e-3 of (1, 1)'s
# (relative), params and first moments at STATE_SAMPLES seeded positions
# within phase 14 (g)'s bounds; SHARD_FAMILY_CKPT's (2, 1) checkpoint
# saved from the shards against a (1, 1) save's arrays and restored into
# the unsharded model. On (2, 1) the ZeRO gathers and gloo's stand-in
# reduce-scatter carry every weight and gradient through the host twice a
# step (on an NVIDIA H100 80GB HBM3, 700 W: rwkv6's one layer 4.98 s a
# step, zamba2 5.36 s, whisper 2.83 s and its checkpoint ~12 s), so no
# family trains there on gloo, to leave the smoke room for phase 16: the
# CPU tests hold every family on (2, 1) with its checkpoint, phase 14 (g)
# holds smollm-135m's on the card, and scripts/shard_train.py runs (N, 1)
# on NCCL, where a checkpoint is written and read at ~9.5 s a GB, so only
# whisper's (1.3 GB) is. (c) B4 at each local-head instance, the
# longest served prompt, against its plain version with its bound, SDPA's
# time and ptxas's registers and spills.
SHARD_FAMILY_ARCHS = ("rwkv6-1.6b", "zamba2-2.7b", "whisper-base",
                      "llama-3.2-vision-90b")
SHARD_FAMILY_CUTS = {"rwkv6-1.6b": {"num_layers": 4},
                     "zamba2-2.7b": {"num_layers": 6, "attn_every": 6},
                     "whisper-base": {},
                     "llama-3.2-vision-90b": {"num_layers": 5,
                                              "cross_attn_every": 5}}
# Training's depth: one RWKV layer, one group of two Mamba2 layers and the
# shared block (phase 14's restart depth), whisper whole, the VLM one
# gated cross layer (2.96 B weights with its embedding and head, 47 GB
# with AdamW; one self and one cross layer, 3.8 B, ran out of the card's
# memory in AdamW's update).
SHARD_FAMILY_TRAIN_CUTS = {"rwkv6-1.6b": {"num_layers": 1},
                           "zamba2-2.7b": {"num_layers": 2, "attn_every": 2},
                           "whisper-base": {},
                           "llama-3.2-vision-90b": {"num_layers": 1,
                                                    "cross_attn_every": 1}}
SHARD_FAMILY_MODEL = 2
SHARD_FAMILY_REQUESTS = 2        # pairs: a 4-23 and a 512-1,000 token prompt
SHARD_FAMILY_LONG = (512, 1001)
SHARD_FAMILY_NEW = 8
SHARD_FAMILY_TOL = {"prefill": 1e-4, "decode": 5e-2, "state": 1e-4}
SHARD_FAMILY_TRAIN_SHAPE = (2, 128)
SHARD_FAMILY_TRAIN_STEPS = 2
SHARD_FAMILY_CKPT = "whisper-base"
# Whose unsharded and (1, 1) train states do not fit the card together:
# compared at the sampled positions.
SHARD_FAMILY_SAMPLED = ("llama-3.2-vision-90b",)
RECURRENT_STATES = ("state", "ssm")


def _shard_family_cfg(arch, cuts):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), **cuts[arch])


def _shard_family_requests(cfg, seed):
    """SHARD_FAMILY_REQUESTS pairs of a short and a long prompt, each
    asking for SHARD_FAMILY_NEW tokens, and each one's stub embeddings
    (host tensors), drawn from the seed."""
    from repro_torch.serve.batching import Request

    rng = np.random.default_rng([seed, 15])
    reqs, stubs = [], []
    for uid in range(2 * SHARD_FAMILY_REQUESTS):
        lo, hi = (4, 24) if uid % 2 == 0 else SHARD_FAMILY_LONG
        reqs.append(Request(uid=uid, prompt=rng.integers(
            2, cfg.vocab_size, int(rng.integers(lo, hi))).astype(np.int32),
            max_new_tokens=SHARD_FAMILY_NEW))
        stubs.append(stub_inputs(cfg, rng, torch.device("cpu")))
    return reqs, stubs


def _shard_family_model(cfg, dev, seed, axes, dtype=torch.float32):
    """``cfg`` drawn on ``dev`` from ``seed`` in ``dtype`` with its
    constant leaves moved (:func:`move_constants`), on the mesh ``axes`` of
    the initialised group (None: unsharded). The blocks of a sharded build
    are those of the unsharded one: every rank draws each leaf whole."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.sharding import resolve_plan
    from repro_torch.models.transformer import RunConfig

    kw, rc = {}, RunConfig()
    if axes is not None:
        mesh = make_mesh(axes)
        kw = dict(plan=resolve_plan(cfg, None, axes), mesh=mesh)
        rc = RunConfig(mesh=mesh)
    model = build_model(cfg, device=dev, dtype=dtype, rc=rc,
                        generator=torch.Generator(dev).manual_seed(seed),
                        **kw)
    move_constants(model, seed + 1)
    return model


def _shard_family_serve(model, reqs, stubs, card, label):
    """Each request through ``Model.prefill`` and SHARD_FAMILY_NEW - 1
    greedy ``decode_step`` s: every call's logits (host), the recurrent
    states after each prefill (gathered), the greedy tokens, collective
    calls and bytes a call by kind, B4's launches a prefill by instance
    and by (q, kv) heads, walls, tokens/s, weight bytes and peak."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import parallel

    dev, cfg, vocab = model.device, model.cfg, model.cfg.vocab_size
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    timed = TimedModel(model)
    specs = model.cache_specs()
    out = {"logits": {}, "states": {}, "tokens": {}, "b4": [], "heads": [],
           "collectives": {"prefill": [], "decode": []}}

    def call(kind, fn, *args, **kw):
        before = parallel.snapshot()
        res = fn(*args, **kw)
        after = parallel.snapshot()
        out["collectives"][kind].append({
            k: {f: after[k][f] - before[k][f] for f in ("calls", "bytes")}
            for k in after})
        return res

    parallel.reset_counts()
    sync(dev)
    t0 = time.perf_counter()
    for req, stub in zip(reqs, stubs):
        tokens = torch.as_tensor(req.prompt[None, :], dtype=torch.long,
                                 device=dev)
        stub = {k: v.to(dev) for k, v in stub.items()}
        fa.reset_launch_counts()
        with _HeadLog() as heads:
            logits, caches = call("prefill", timed.prefill, tokens,
                                  SERVE_CACHE_LEN, **stub)
        out["b4"].append(b4_instance_launches(fa))
        out["heads"].append(dict(heads.seen))
        # Copies: decode writes the caches in place.
        out["states"][req.uid] = {
            k: (model.layout.gather_spec(caches[k], specs[k])
                if model.layout is not None else caches[k]).to(
                    "cpu", torch.float32, copy=True)
            for k in RECURRENT_STATES if k in caches}
        rows = [logits[0].detach().cpu()]
        toks, pos = [int(logits[0, :vocab].argmax())], len(req.prompt)
        while len(toks) < req.max_new_tokens:
            logits, caches = call("decode", timed.decode_step,
                                  torch.tensor([toks[-1]], device=dev),
                                  caches, pos)
            rows.append(logits[0].detach().cpu())
            toks.append(int(logits[0, :vocab].argmax()))
            pos += 1
        out["logits"][req.uid], out["tokens"][req.uid] = rows, toks
        del caches
    sync(dev)
    out["wall_s"] = time.perf_counter() - t0
    out["prefill_tokens_per_s"] = timed.prefill_tokens / timed.prefill_s
    out["decode_tokens_per_s"] = timed.decode_tokens / max(timed.decode_s,
                                                           1e-9)
    out["weight_bytes"] = sum(p.numel() * p.element_size()
                              for p in model.parameters())
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(dev) if cuda
                         else None)
    per = {}
    for kind, rows in out["collectives"].items():
        n = max(1, len(rows))
        per[kind] = {k: {f: sum(r[k][f] for r in rows) / n
                         for f in ("calls", "bytes")} for k in parallel.KINDS}
    out["collectives_per_call"] = per
    want = b4_per_prefill(cfg, str(model.embed.dtype).removeprefix("torch."))
    if cuda and any(b != want for b in out["b4"]):
        raise AssertionError(f"{label} {cfg.name}: B4 launched "
                             f"{out['b4']} a prefill, not {want}")
    print(f"  {label} {cfg.name}: {len(reqs)} requests in "
          f"{out['wall_s']:.3f} s: prefill "
          f"{out['prefill_tokens_per_s']:.1f} tokens/s, decode "
          f"{out['decode_tokens_per_s']:.1f} tokens/s; weights "
          f"{out['weight_bytes']} bytes, peak {out['peak_bytes']}; B4 a "
          f"prefill {out['b4'][0]} on (q, kv, D, causal) heads "
          f"{out['heads'][0]}  [{card}]")
    for kind, row in per.items():
        print(f"      per {kind} call: " + ", ".join(
            f"{k} {v['calls']:.1f} calls / {v['bytes']:.0f} bytes"
            for k, v in row.items()))
    return out


def _shard_family_against(a, b, cfg, label):
    """(b) the sharded run against (a), request by request: logits,
    greedy tokens where (a)'s margin is clear (a request that parts at an
    unclear decision is compared up to there), recurrent states. Every
    failure lands in ``row["violations"]``."""
    vocab, tol = cfg.vocab_size, SHARD_FAMILY_TOL
    row = {"prefill_err": 0.0, "decode_err": 0.0, "state_err": 0.0,
           "steps": 0, "parted": {}, "violations": []}
    for uid, steps in sorted(a["logits"].items()):
        for name, sa in a["states"][uid].items():
            sb = b["states"][uid][name]
            err = float((sa - sb).abs().max())
            scale = max(1.0, float(sa.abs().max()))
            row["state_err"] = max(row["state_err"], err / scale)
            if not err <= tol["state"] * scale:
                row["violations"].append(
                    f"{label} request {uid} {name}: {err:.3g} apart (scale "
                    f"{scale:.3g})")
        for step, (la, lb) in enumerate(zip(steps, b["logits"][uid])):
            kind = "prefill" if step == 0 else "decode"
            err = float((la - lb).abs().max())
            if not err <= tol[kind]:
                row["violations"].append(f"{label} request {uid} step "
                                         f"{step}: logits {err:.3g} apart")
            row[f"{kind}_err"] = max(row[f"{kind}_err"], err)
            row["steps"] += 1
            ta, tb = int(la[:vocab].argmax()), int(lb[:vocab].argmax())
            if ta != tb:
                top2 = torch.topk(la[:vocab], 2).values
                if float(top2[0] - top2[1]) > 2 * tol[kind]:
                    row["violations"].append(f"{label} request {uid} step "
                                             f"{step}: greedy token differs "
                                             f"at a clear margin")
                row["parted"][uid] = step
                break
    return row


def _family_train_shape(ranks):
    """SHARD_FAMILY_TRAIN_SHAPE with its rows raised to a multiple of
    ``ranks`` (a batch divides over (ranks, 1)) and its tokens kept: the
    VLM's one rank has no room for more activations beside AdamW."""
    b, s = SHARD_FAMILY_TRAIN_SHAPE
    rows = math.lcm(b, ranks)
    return rows, s * b // rows


def _family_batches(cfg, seed, n, ranks):
    """``n`` training batches of :func:`_family_train_shape` with the
    family's stub embeddings, drawn from the seed (host tensors)."""
    b, s = _family_train_shape(ranks)
    rng = np.random.default_rng([seed, 15, 2])
    out = []
    for _ in range(n):
        batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))
                                     .astype(np.int32))
                 for k in ("tokens", "labels")}
        for key, stub in stub_inputs(cfg, rng, torch.device("cpu")).items():
            batch[key] = torch.cat([stub] + [torch.from_numpy(
                rng.standard_normal(stub.shape, np.float32))
                for _ in range(b - 1)])
        out.append(batch)
    return out


def _family_train_fields(cfg):
    """The training launcher's full-size fields of ``cfg``'s family
    (``launch.train.run_config``) that ``_train_on_mesh`` does not set."""
    from repro_torch.launch import train

    rc = train.run_config(cfg, False, SHARD_FAMILY_TRAIN_SHAPE[1])
    return {f: getattr(rc, f) for f in ("rwkv_impl", "ssd_chunk")
            if f in rc.FAMILY_FIELDS.get(cfg.family, ())}


def _family_train_meshes(arch, ranks, backend):
    """(1, ranks), and (ranks, 1) on NCCL (one card a rank: the ZeRO
    collectives do not pass through the host; module comment above)."""
    data = backend == "nccl"
    return ((1, ranks),) + (((ranks, 1),) if data else ())


def _family_rank(rank, world, store, out_dir, seed, card, dev_type, backend,
                 smoke, archs, serve, train):
    """(15a)/(15b) one rank of ``world`` in a ``backend`` group, on card
    ``rank`` modulo the cards there are: each of ``archs`` served on
    (1, world) (rank 0 prints), then trained on each mesh of
    :func:`_family_train_meshes`; records for the parent."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    dev = torch.device(dev_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if smoke:
        _smoke_configs()
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    from repro_torch.launch.train import deterministic
    try:
        for arch in archs if serve else ():
            cfg = _shard_family_cfg(arch, SHARD_FAMILY_CUTS)
            reqs, stubs = _shard_family_requests(cfg, seed)
            t0 = time.perf_counter()
            model = _shard_family_model(cfg, dev, seed,
                                        {"data": 1, "model": world})
            sync(dev)
            build_s = time.perf_counter() - t0
            with (nullcontext() if rank == 0 else
                  contextlib.redirect_stdout(io.StringIO())), \
                    deterministic(dev):
                rec = _shard_family_serve(model, reqs, stubs, card,
                                          f"(15a) (1, {world})")
            every = [None] * world
            dist.all_gather_object(every, rec["tokens"])
            if any(t != every[0] for t in every):
                raise AssertionError(f"(15a) {arch} rank {rank}: greedy "
                                     f"tokens differ from rank 0's")
            rec["build_s"] = build_s
            torch.save(rec, os.path.join(out_dir, f"serve_{arch}_{rank}.pt"))
            del model, rec
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        for arch in archs if train else ():
            tcfg = _shard_family_cfg(arch, SHARD_FAMILY_TRAIN_CUTS)
            batches = _family_batches(tcfg, seed, SHARD_FAMILY_TRAIN_STEPS,
                                      world)
            for data, nmodel in _family_train_meshes(arch, world, backend):
                tag = f"{data}x{nmodel}"
                rec = _train_on_mesh(
                    tcfg, dev, seed, {"data": data, "model": nmodel},
                    batches, rc_fields=_family_train_fields(tcfg),
                    gather="samples", constants=True,
                    ckpt=(os.path.join(out_dir, f"ckpt_{arch}_{tag}")
                          if nmodel == 1 and arch == SHARD_FAMILY_CKPT
                          else None))
                torch.save(rec, os.path.join(out_dir,
                                             f"train_{arch}_{tag}_{rank}.pt"))
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def _smoke_configs():
    """Every config at its smoke size (a rehearsal on the CPU)."""
    from repro_torch import configs

    configs.get_config = configs.get_smoke


def shard_families(dev, card, seed, ranks=SHARD_FAMILY_MODEL,
                   backend="gloo", smoke=False, archs=SHARD_FAMILY_ARCHS,
                   serve=True, train=True):
    """(15a) and (15b) for ``archs`` (``serve``, ``train``): the unsharded
    model and one rank on (1, 1) in this process, then ``ranks`` spawned
    ranks (gloo: all on the one card; NCCL: one a card), each family
    served on (1, ranks) and trained on the meshes of
    :func:`_family_train_meshes`. Returns the record."""
    import shutil
    import tempfile

    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch.launch.train import deterministic
    from repro_torch.models import build_model
    from repro_torch.train import checkpoint, optimizer, train_step

    out: dict = {"ranks": ranks, "backend": backend, "served": {},
                 "trained": {}}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_sfam_"))
    one_serve, one_train = {}, {}
    try:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.FileStore(str(tmp / "store1"), 1),
                                rank=0, world_size=1)
        try:
            for arch in archs if serve else ():
                cfg = _shard_family_cfg(arch, SHARD_FAMILY_CUTS)
                reqs, stubs = _shard_family_requests(cfg, seed)
                rec = {}
                for tag, axes in (("unsharded", None),
                                  ("1x1", {"data": 1, "model": 1})):
                    model = _shard_family_model(cfg, dev, seed, axes)
                    with deterministic(dev):
                        rec[tag] = _shard_family_serve(
                            model, reqs, stubs, card,
                            f"(15a) {'(1, 1)' if axes else 'unsharded'}")
                    del model
                    torch.cuda.empty_cache()
                a, b = rec["unsharded"], rec["1x1"]
                same = all(torch.equal(x, y) for uid, s in a["logits"].items()
                           for x, y in zip(s, b["logits"][uid])) and all(
                    torch.equal(t, b["states"][uid][k])
                    for uid, st in a["states"].items() for k, t in st.items())
                if not same:
                    raise AssertionError(f"(15a) {arch}: (1, 1) is not bit "
                                         "for bit the unsharded model")
                print(f"  (15a) {arch}: (1, 1) bit for bit the unsharded "
                      f"model (logits and recurrent states)")
                one_serve[arch] = b
                out["served"][arch] = {
                    "layers": cfg.num_layers,
                    "prompts": [len(r.prompt) for r in reqs],
                    **{t: {k: r[k] for k in (
                        "wall_s", "prefill_tokens_per_s",
                        "decode_tokens_per_s", "weight_bytes", "peak_bytes",
                        "collectives_per_call")} for t, r in rec.items()},
                    "b4_per_prefill": b["b4"][0],
                    "heads_1x1": sorted(b["heads"][0].items())}
                del rec, a
            for arch in archs if train else ():
                tcfg = _shard_family_cfg(arch, SHARD_FAMILY_TRAIN_CUTS)
                batches = _family_batches(tcfg, seed,
                                          SHARD_FAMILY_TRAIN_STEPS, ranks)
                fields = _family_train_fields(tcfg)
                tokens = batches[0]["tokens"].numel()
                big = arch in SHARD_FAMILY_SAMPLED
                plain = _train_on_mesh(tcfg, dev, seed, None, batches,
                                       rc_fields=fields, constants=True,
                                       gather="samples" if big else "state")
                one = _train_on_mesh(tcfg, dev, seed,
                                     {"data": 1, "model": 1}, batches,
                                     rc_fields=fields, gather="state",
                                     constants=True)
                sa = one.pop("state")
                one["samples"] = _samples(sa, seed)
                same = (one["losses"] == plain["losses"]
                        and one["grad_norms"] == plain["grad_norms"])
                if big:
                    same = same and all(torch.equal(t, plain["samples"][k])
                                        for k, t in one["samples"].items())
                    del plain["samples"]
                else:
                    sb = plain.pop("state")
                    same = same and all(
                        torch.equal(t, sb.params[n])
                        for n, t in sa.params.items()) and all(
                        torch.equal(t, getattr(sb.opt, part)[n])
                        for part in ("mu", "nu")
                        for n, t in getattr(sa.opt, part).items())
                    if arch == SHARD_FAMILY_CKPT and (ranks, 1) in \
                            _family_train_meshes(arch, ranks, backend):
                        one["arrays"] = checkpoint._arrays(sa)
                    del sb
                del sa
                if not same:
                    raise AssertionError(f"(15b) {arch}: (1, 1) is not bit "
                                         "for bit the unsharded step")
                for tag, r in (("unsharded", plain), ("(1, 1)", one)):
                    _print_mesh(f"(15b) {arch} {tcfg.num_layers} layers, "
                                f"{tag}", r, tokens, card,
                                ("; bit for bit the unsharded step" + (
                                    f" (at {STATE_SAMPLES} positions a leaf)"
                                    if big else "")) if r is one else "")
                one_train[arch] = one
                out["trained"][arch] = {"layers": tcfg.num_layers,
                                        "unsharded": plain}
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()

        where = ("one card, backend gloo (CUDA tensors through host memory; "
                 "NCCL refuses two ranks on one device); the walls are "
                 "processes sharing one card, not a multi-card figure"
                 if backend == "gloo" else f"one card each, backend {backend}")
        print(f"  (15) {ranks} ranks on {where}")
        t0 = time.perf_counter()
        mp.spawn(_family_rank, args=(ranks, str(tmp / "store2"), str(tmp),
                                     seed, card, dev.type, backend, smoke,
                                     archs, serve, train),
                 nprocs=ranks, join=True)
        out["spawn_s"] = time.perf_counter() - t0
        bad = []
        for arch in archs if serve else ():
            cfg = _shard_family_cfg(arch, SHARD_FAMILY_CUTS)
            recs = [torch.load(tmp / f"serve_{arch}_{r}.pt")
                    for r in range(ranks)]
            for other in recs[1:]:
                if any(not torch.equal(x, y) for uid, s in
                       recs[0]["logits"].items()
                       for x, y in zip(s, other["logits"][uid])):
                    raise AssertionError(f"(15a) {arch}: the ranks' logits "
                                         "differ")
            b = recs[0]
            want_heads = {(cfg.num_heads // ranks, cfg.num_kv_heads // ranks,
                           cfg.head_dim, c)
                          for (_, _, _, c) in b["heads"][0]}
            if dev.type == "cuda" and any(set(h) != want_heads
                                          for r in recs for h in r["heads"]):
                raise AssertionError(f"(15a) {arch}: B4 ran on "
                                     f"{recs[0]['heads']}, not {want_heads}")
            row = _shard_family_against(one_serve[arch], b, cfg,
                                        f"(15a) {arch}")
            bad += row["violations"]
            served = out["served"][arch]
            served[f"1x{ranks}"] = {k: b[k] for k in (
                "wall_s", "prefill_tokens_per_s", "decode_tokens_per_s",
                "collectives_per_call", "build_s")}
            served[f"1x{ranks}"].update(
                weight_bytes_by_rank=[r["weight_bytes"] for r in recs],
                peak_bytes_by_rank=[r["peak_bytes"] for r in recs],
                b4_per_prefill=b["b4"][0],
                heads=sorted(b["heads"][0].items()))
            served["against_1x1"] = {k: row[k] for k in (
                "prefill_err", "decode_err", "state_err", "steps", "parted")}
            served["longest_prompt"] = max(served["prompts"])
            print(f"  (15a) {arch} on (1, {ranks}): weights by rank "
                  f"{served[f'1x{ranks}']['weight_bytes_by_rank']}, peaks "
                  f"{served[f'1x{ranks}']['peak_bytes_by_rank']}; B4 a "
                  f"prefill {b['b4'][0]} on heads {b['heads'][0]}; against "
                  f"(1, 1): prefill logits {row['prefill_err']:.3g} (tol "
                  f"{SHARD_FAMILY_TOL['prefill']}), decode "
                  f"{row['decode_err']:.3g} (tol "
                  f"{SHARD_FAMILY_TOL['decode']}), states "
                  f"{row['state_err']:.3g} (tol {SHARD_FAMILY_TOL['state']}"
                  f", relative) over {row['steps']} calls; parted "
                  f"{row['parted']}  [{card}]")
        for arch in archs if train else ():
            tcfg = _shard_family_cfg(arch, SHARD_FAMILY_TRAIN_CUTS)
            one = one_train[arch]
            lr_sum = sum(one["lrs"])
            tokens = math.prod(_family_train_shape(ranks))
            trained = out["trained"][arch]
            for data, nmodel in _family_train_meshes(arch, ranks, backend):
                tag = f"{data}x{nmodel}"
                recs = [torch.load(tmp / f"train_{arch}_{tag}_{r}.pt")
                        for r in range(ranks)]
                for r in recs[1:]:
                    if r["losses"] != recs[0]["losses"]:
                        raise AssertionError(f"(15b) {arch} {tag}: the "
                                             "ranks' losses differ")
                rec = recs[0]
                rec["state_bytes_by_rank"] = [r["state_bytes"] for r in recs]
                rec["peak_bytes_by_rank"] = [r["peak_bytes"] for r in recs]
                rec.update(_against(rec, one, f"(15b) {arch} {tag}"))
                rec["samples_err"] = _compare_leaves(
                    ((key.split(":")[0], key, rec["samples"][key], w)
                     for key, w in one["samples"].items()), lr_sum,
                    f"(15b) {arch} {tag} at {STATE_SAMPLES} positions a leaf")
                del rec["samples"]
                extra = ""
                if nmodel == 1 and arch == SHARD_FAMILY_CKPT:
                    step = f"step_{SHARD_FAMILY_TRAIN_STEPS:08d}"
                    ckpt = tmp / f"ckpt_{arch}_{tag}"
                    with np.load(ckpt / step / "arrays.npz") as f:
                        saved = {k: f[k] for k in f.files}
                    rec["checkpoint_err"] = _compare_arrays(
                        saved, one.pop("arrays"), lr_sum,
                        f"(15b) {arch} {tag} checkpoint")
                    model = build_model(tcfg, device=dev,
                                        generator=torch.Generator(dev)
                                        .manual_seed(seed + 1))
                    state = train_step.init_train_state(
                        model, optimizer.OptConfig(**TRAIN_OC))
                    state, _ = checkpoint.restore_checkpoint(ckpt, state)
                    back = checkpoint._arrays(state)
                    if sorted(back) != sorted(saved) or any(
                            back[k].tobytes() != saved[k].tobytes()
                            for k in saved):
                        raise AssertionError(f"(15b) {arch}: the {tag} "
                                             "checkpoint did not restore "
                                             "into the unsharded model")
                    del model, state, back, saved
                    torch.cuda.empty_cache()
                    extra = (f"; its checkpoint from the shards "
                             f"{rec['checkpoint_err']}, restored into the "
                             f"unsharded model byte for byte")
                trained[tag] = rec
                _print_mesh(f"(15b) {arch} ({data}, {nmodel})", rec, tokens,
                            card, f"; against (1, 1): loss "
                            f"{rec['loss_err']:.3g}, grad_norm "
                            f"{rec['grad_norm_err']:.3g}, params / moments at "
                            f"{STATE_SAMPLES} positions a leaf "
                            f"{rec['samples_err']}; state by rank "
                            f"{rec['state_bytes_by_rank']}{extra}")
            del one["samples"]
            trained["1x1"] = one
        if bad:
            raise AssertionError(f"(15a) {len(bad)} checks failed: "
                                 f"{bad[:20]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _full_depth_rank(rank, world, store, out_dir, seed, card, dev_type,
                     backend, arch, dtype, smoke):
    """One rank of :func:`serve_full_depth`."""
    import torch.distributed as dist
    from repro_torch.configs import get_config, get_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    dev = torch.device(dev_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        cfg = (get_smoke if smoke else get_config)(arch)
        dt = getattr(torch, dtype)
        reqs, stubs = _shard_family_requests(cfg, seed)
        stubs = [{k: v.to(dt) for k, v in st.items()} for st in stubs]
        t0 = time.perf_counter()
        model = _shard_family_model(cfg, dev, seed,
                                    {"data": 1, "model": world}, dt)
        sync(dev)
        build_s = time.perf_counter() - t0
        with (nullcontext() if rank == 0 else
              contextlib.redirect_stdout(io.StringIO())):
            rec = _shard_family_serve(model, reqs, stubs, card,
                                      f"(1, {world}) full depth, {dtype}")
        every = [None] * world
        dist.all_gather_object(every, rec["tokens"])
        if any(t != every[0] for t in every):
            raise AssertionError(f"{arch} rank {rank}: greedy tokens differ "
                                 f"from rank 0's")
        if not all(bool(torch.isfinite(x).all())
                   for rows in rec["logits"].values() for x in rows):
            raise AssertionError(f"{arch}: non-finite logits")
        rec.update(build_s=build_s, layers=cfg.num_layers)
        del rec["logits"], rec["states"]
        torch.save(rec, os.path.join(out_dir, f"full_{rank}.pt"))
    finally:
        dist.destroy_process_group()


def serve_full_depth(dev, card, seed, arch, ranks, backend, dtype,
                     smoke=False):
    """``arch`` at its published widths and full depth in ``dtype``
    weights on (1, ``ranks``), one rank a card: the requests of (15a)
    served in lockstep (greedy tokens equal on every rank, logits finite,
    B4 at the local-head instances a prefill). No rank holds the whole
    model, so nothing is compared with one. Returns the record."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_full_"))
    try:
        t0 = time.perf_counter()
        mp.spawn(_full_depth_rank, args=(ranks, str(tmp / "store"), str(tmp),
                                         seed, card, dev.type, backend, arch,
                                         dtype, smoke),
                 nprocs=ranks, join=True)
        recs = [torch.load(tmp / f"full_{r}.pt") for r in range(ranks)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec = recs[0]
    rec.update(spawn_s=time.perf_counter() - t0,
               weight_bytes_by_rank=[r["weight_bytes"] for r in recs],
               peak_bytes_by_rank=[r["peak_bytes"] for r in recs],
               heads=[sorted(h.items()) for h in rec["heads"][:1]])
    print(f"  {arch} full depth ({rec['layers']} layers), {dtype}, on (1, "
          f"{ranks}): weights by rank {rec['weight_bytes_by_rank']}, peaks "
          f"{rec['peak_bytes_by_rank']}, built in {rec['build_s']:.1f} s; "
          f"tokens {rec['tokens']}  [{card}]")
    return rec


def shard_family_b4_rows(out, abench, rng, ptxas, ranks):
    """(15c) B4 at each local-head instance of (15a), the longest served
    prompt, against its plain version, timed with its bound, SDPA's time
    and ptxas's registers and spills; the ``kernels`` rows, each with its
    launches a rank on its family's path (every prefill of (15a))."""
    rows = []
    for arch in SHARD_FAMILY_ARCHS[1:]:
        cfg = _shard_family_cfg(arch, SHARD_FAMILY_CUTS)
        served = out["served"][arch]
        s = served["longest_prompt"]
        n_prefills = len(served["prompts"])
        shapes = [("shared block" if cfg.family == "hybrid"
                   else "self-attention", (s, s), True)]
        if cfg.family == "encdec":
            enc = cfg.encoder_seq
            shapes += [("encoder", (enc, enc), False),
                       ("cross-attention", (s, enc), False)]
        if cfg.family == "vlm":
            shapes.append(("cross layers", (s, cfg.num_image_tokens), False))
        for what, (sq, sk), causal in shapes:
            shape = (1, cfg.num_heads // ranks, cfg.num_kv_heads // ranks,
                     sq, sk, cfg.head_dim, causal, "float32")
            row = abench.run(shape, rng)
            print_b4_row(row)
            regs = _b4_ptxas(ptxas, cfg.head_dim)
            if regs is not None:
                print(f"      {regs['function']}: {regs['registers']} "
                      f"registers, stack / spill store / spill load "
                      f"{regs['stack']} / {regs['spill_stores']} / "
                      f"{regs['spill_loads']} B")
            key = b4_key("float32", cfg.head_dim, causal)
            a_prefill = served[f"1x{ranks}"]["b4_per_prefill"].get(key, 0)
            rows.append({
                "name": "flash_attention", "route": "cuda",
                "source": B4_SOURCE, "replaces": B4_REPLACES,
                "launches": a_prefill * n_prefills,
                "launches_a_prefill_a_rank": a_prefill,
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "shape": row["shape"], "call_ms": row["call_ms"],
                "bounds": row["bounds"],
                "variant": f"fa_forward_kernel<float32, {cfg.head_dim}>, "
                           f"{'causal' if causal else 'non-causal'}, {arch} "
                           f"{what} on model {ranks}: {shape[1]}/{shape[2]} "
                           f"local heads a rank; launches: the {key} "
                           f"instance on a rank's path, every prefill",
                "ptxas": regs})
    return rows


def shard_families_phase(dev, card, seed, abench, rng, ptxas):
    """Phase 15 (module comment above). Returns the record."""
    t_phase = time.perf_counter()
    out = shard_families(dev, card, seed)
    out["kernels"] = shard_family_b4_rows(out, abench, rng, ptxas,
                                          SHARD_FAMILY_MODEL)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  (15) {out['phase_s']:.1f} s in all  [{card}]")
    return out


# Phase 16: the dry run and the roofline held to the card (ROADMAP 18e,
# 18f). (a) launch.dryrun.count_train_step, the meta step on a stand-in
# mesh, at phase 14's settings: smollm-135m at 8 x 1,024 tokens, f32,
# phase 10's optimizer, phase 14's RunConfig, on (1, 1), (2, 1) and (1, 2),
# and olmoe-1b-7b cut to MOE_TRAIN_LAYERS with 'sort' on (1, 1) and (1, 2),
# each for rank 0: its collective calls and bytes by kind and its state
# bytes must equal what phase 14 (g)/(h) measured on rank 0 in this run
# (one step's counts; the live counter counts a rank's input tensor on
# NCCL and gloo alike, so the gloo meshes follow the same rule). (b) The
# ported roofline of every prefill phases 6, 11 and 12 timed (batch 1, the
# prompt's length, bf16 caches of SERVE_CACHE_LEN, the served depth) and
# of every training step phases 10 and 14 timed (their batch and length,
# f32 AdamW state), at the f32 peak outside the tensor cores (TF32 is off
# in this run): t_compute, t_memory and the measured time over the larger.
# (c) launch.dryrun.run_cell in this process for DRYRUN_CELLS, one grid
# cell of each family on the single-pod stand-in mesh: status ok, the
# reference's keys, B4's meta launches a rank. At most DRYRUN_PHASE_S.
DRYRUN_CELLS = (("qwen3-8b", "decode_32k"), ("olmoe-1b-7b", "decode_32k"),
                ("rwkv6-1.6b", "decode_32k"), ("zamba2-2.7b", "decode_32k"),
                ("whisper-base", "prefill_32k"),
                ("llama-3.2-vision-90b", "decode_32k"))
DRYRUN_PHASE_S = 40.0


def _dryrun_counts(sharded) -> dict:
    """(16a) The meta step's counts against phase 14's measured ones."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import count_train_step
    from repro_torch.models.transformer import RunConfig
    from repro_torch.train.optimizer import OptConfig

    cases = [(SHARD_TRAIN_ARCH, get_config(SHARD_TRAIN_ARCH), tag, {},
              (TRAIN_BATCH, TRAIN_SEQ)) for tag in ("1x1", "2x1", "1x2")]
    cases += [(MOE_TRAIN_ARCH, _moe_cfg(False), tag, {"moe_impl": "sort"},
               MOE_TRAIN_SHAPE) for tag in ("moe_1x1", "moe_1x2")]
    out = {}
    for arch, cfg, tag, fields, (b, s) in cases:
        data, model = (int(n) for n in tag.removeprefix("moe_").split("x"))
        want = sharded[tag]
        got = count_train_step(
            cfg, {"data": data, "model": model}, b, s,
            rc=RunConfig(attn_impl="chunked", loss_chunk=min(256, s),
                         **fields), oc=OptConfig(**TRAIN_OC))
        counted = {k: {"calls": got["collectives"]["counts"][k],
                       "bytes": got["collectives"]["bytes"][k]}
                   for k in got["collectives"]["counts"]}
        measured = {k: dict(v) for k, v in want["collectives"].items()}
        same = (counted == measured
                and got["state_bytes"] == want["state_bytes"])
        out[tag] = {"arch": arch, "counted": counted, "measured": measured,
                    "state_bytes": got["state_bytes"],
                    "measured_state_bytes": want["state_bytes"],
                    "meta_step_s": got["meta_step_s"], "equal": same}
        print(f"  (16a) {arch} ({data}, {model}) {b} x {s}: counted "
              + ", ".join(f"{k} {v['calls']} ({v['bytes']} B)"
                          for k, v in counted.items())
              + f"; state {got['state_bytes']} B a rank; "
              f"{'equal to' if same else 'NOT equal to'} phase 14's "
              f"(meta step {got['meta_step_s']:.2f} s)")
        if not same:
            raise AssertionError(f"(16a) the dry run's count for {arch} "
                                 f"({data}, {model}) is not phase 14's: "
                                 f"{counted} / {got['state_bytes']} against "
                                 f"{measured} / {want['state_bytes']}")
    return out


def _bound_of(cfg, shape, param_bytes, cache_bytes=0, opt_bytes=0):
    """The ported roofline of one step on one card at the f32 peak
    outside the tensor cores (no collectives)."""
    from repro_torch.kernels.measure import NON_TENSOR_OPS_PER_S
    from repro_torch.launch import roofline as rl

    return rl.Roofline(
        chips=1, flops=rl.step_flops(cfg, shape),
        bytes_hbm=rl.hbm_bytes(cfg, shape, param_bytes, cache_bytes,
                               opt_bytes),
        coll_bytes=0.0, hlo_flops_raw=None, hlo_bytes_raw=None,
        model_flops_=rl.model_flops(cfg, shape),
        peak_flops=NON_TENSOR_OPS_PER_S)


def _roofline_row(label, walls_s, roofs) -> dict:
    t_c = sum(r.t_compute for r in roofs)
    t_m = sum(r.t_memory for r in roofs)
    bound = sum(max(r.t_compute, r.t_memory) for r in roofs)
    wall = sum(walls_s)
    row = {"label": label, "calls": len(roofs), "measured_s": wall,
           "t_compute_s": t_c, "t_memory_s": t_m, "bound_s": bound,
           "over_bound": wall / bound}
    print(f"  (16b) {label}: {len(roofs)} calls, measured {wall:.4f} s, "
          f"t_compute {t_c:.4f} s, t_memory {t_m:.4f} s: "
          f"{row['over_bound']:.2f}x the bound")
    return row


def _roofline_ratios(serve_rec, train_rec, lm, fam, fam_train) -> list:
    """(16b) Measured over the ported roofline for the prefills and the
    training steps phases 6, 10, 11, 12 and 14 timed."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.models import build_model
    from repro_torch.models.model import tree_bytes

    def sizes(cfg):
        model = build_model(cfg, device="meta", dtype=torch.float32)
        return (tree_bytes(model.abstract_params().whole),
                tree_bytes(model.abstract_caches(1, SERVE_CACHE_LEN).whole))

    def prefills(label, cfg, rec):
        pbytes, cbytes = sizes(cfg)
        calls = rec["prefill_calls"]
        return _roofline_row(label, [sec for _, sec in calls], [_bound_of(
            cfg, ShapeConfig("prefill", "prefill", n, 1), pbytes, cbytes)
            for n, _ in calls])

    def step(label, cfg, b, s, ms):
        pbytes, _ = sizes(cfg)
        return _roofline_row(label, [ms / 1e3], [_bound_of(
            cfg, ShapeConfig("train", "train", s, b), pbytes,
            opt_bytes=2 * pbytes)])

    rows = [prefills("phase 6 smollm-135m prefills",
                     get_config("smollm-135m"), serve_rec)]
    rows += [prefills(f"phase 11 {arch} prefills", get_config(arch), rec)
             for arch, rec in lm["configs"].items()]
    rows += [prefills(f"phase 12 {arch} prefills ({rec['layers']} layers)",
                      _family_cfg(arch), rec)
             for arch, rec in fam["served"].items()]
    smollm = get_config(SHARD_TRAIN_ARCH)
    rows.append(step("phase 10 smollm-135m step", smollm, TRAIN_BATCH,
                     TRAIN_SEQ, train_rec["median_step_ms"]))
    rows += [step(f"phase 14 (f) {arch} step", get_config(arch), rec["batch"],
                  rec["seq"], rec["median_step_ms"])
             for arch, rec in fam_train["families"].items()]
    sharded = fam_train["sharded"]
    for tag in ("unsharded", "1x1"):
        rows.append(step(f"phase 14 (g) smollm-135m {tag} step", smollm,
                         TRAIN_BATCH, TRAIN_SEQ,
                         sharded[tag]["median_step_ms"]))
    rows.append(step(f"phase 14 (h) olmoe-1b-7b {MOE_TRAIN_LAYERS} layers "
                     "(1, 1) step", _moe_cfg(False), *MOE_TRAIN_SHAPE,
                     sharded["moe_1x1"]["median_step_ms"]))
    return rows


def _dryrun_cells() -> list:
    """(16c) One grid cell of each family through run_cell."""
    from repro_torch.launch.dryrun import run_cell

    out = []
    for arch, shape in DRYRUN_CELLS:
        res = run_cell(arch, shape)
        if res["status"] != "ok":
            raise AssertionError(f"(16c) {arch} x {shape}: {res}")
        r, m = res["roofline"], res["memory"]
        row = {"arch": arch, "shape": shape,
               "per_device_total": m["per_device_total"],
               "collective_calls": res["collectives"]["counts"],
               "b4_launches": res["b4_launches"],
               "bottleneck": r["bottleneck"],
               **{k: r[k] for k in ("t_compute_s", "t_memory_s",
                                    "t_collective_s")},
               "meta_step_s": res["meta_step_s"]}
        out.append(row)
        print(f"  (16c) {arch} x {shape} on 16 x 16 (a model at H100 "
              f"datasheet rates): {m['per_device_total'] / 2**30:.2f} GiB a "
              f"rank, {r['bottleneck']}-bound (compute "
              f"{r['t_compute_s']:.4g} s, memory {r['t_memory_s']:.4g} s, "
              f"collective {r['t_collective_s']:.4g} s), B4 "
              f"{res['b4_launches']} a rank, collectives "
              f"{res['collectives']['counts']}")
    return out


def dryrun_phase(card, serve_rec, train_rec, lm, fam, fam_train) -> dict:
    """Phase 16 (module comment above). Returns the record."""
    t_phase = time.perf_counter()
    out = {"counts": _dryrun_counts(fam_train["sharded"])}
    out["roofline"] = _roofline_ratios(serve_rec, train_rec, lm, fam,
                                       fam_train)
    out["cells"] = _dryrun_cells()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  (16) {out['phase_s']:.1f} s in all  [{card}]")
    if out["phase_s"] > DRYRUN_PHASE_S:
        raise AssertionError(f"(16) took {out['phase_s']:.1f} s, more than "
                             f"{DRYRUN_PHASE_S} s")
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
    t_main = time.perf_counter()

    def stamp(phase):
        at = time.perf_counter() - t_main
        record.setdefault("stamps_s", {})[phase] = at
        print(f"[{at:.1f} s] phase {phase}", flush=True)

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

    stamp(3)
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

    stamp(4)
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

    stamp(5)
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

    stamp(6)
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
    # B4's bf16 instances at head dims 80 and 160, which no model serves:
    # each row carries its own instance's launches on the LM path, which
    # are 0. The f32 instances are on stablelm-12b's path (160) and
    # zamba2-2.7b's (80), and phases 11 and 12 give their rows there.
    b4_inst = serve_rec["b4_instance_launches"]
    for row in record["b4_shapes"]:
        if row["shape"][5] in (80, 160) and row["shape"][7] == "bfloat16":
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
    stamp(7)
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
    stamp(8)
    # 8. The near-duplicate dedup path.
    dedup_rec = dedup_phase(dev, card, args.seed)
    record["dedup"] = dedup_rec
    stamp(9)
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
    stamp(10)
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
    stamp(11)
    # 11. The other dense configs and MoE at full width; each B4 row with
    # its launches on that config's path.
    lm = lm_configs_phase(dev, card, args.seed, abench, rng,
                          record["ptxas"].get("flash_attention", []))
    served = lm["configs"][SHARD_ARCH].pop("served_logits")
    record["lm_configs"] = lm
    kernels.extend(lm["kernels"])
    stamp(12)
    # 12. The other model families; each new B4 row with its instance's
    # launches on that family's path.
    fam = families_phase(dev, card, args.seed, abench, rng,
                         record["ptxas"].get("flash_attention", []))
    record["families"] = fam
    kernels.extend(fam["kernels"])
    stamp(13)
    # 13. Sharded serving of olmoe-1b-7b on (data, model) meshes; B4's row
    # at the local-head instance with its launches on a rank's path.
    shard, shard_kernel = shard_phase(
        dev, card, args.seed, abench, rng,
        record["ptxas"].get("flash_attention", []), served)
    record["sharding"] = shard
    kernels.append(shard_kernel)
    stamp(14)
    # 14. Training every family, and the sharded train step; B3's row
    # gains its launches in each family's dedup stage.
    fam_train = train_families_phase(dev, card, args.seed)
    record["train_families"] = fam_train
    for row in kernels:
        if row["name"] == "mis_pivot":
            row["launches_family_train_dedup"] = {
                arch: rec["b3_launches_dedup"]
                for arch, rec in fam_train["families"].items()}
    stamp(15)
    # 15. The four other families served and trained on a mesh; B4's rows
    # at each local-head instance with its launches on a rank's path.
    shard_fam = shard_families_phase(
        dev, card, args.seed, abench, rng,
        record["ptxas"].get("flash_attention", []))
    record["shard_families"] = shard_fam
    kernels.extend(shard_fam["kernels"])
    stamp(16)
    # 16. The dry run and the roofline held to this run's phases.
    dry = dryrun_phase(card, serve_rec, train_rec, lm, fam, fam_train)
    record["dryrun"] = dry
    record["kernels"] = kernels
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        # numpy scalars (sizes, counts) as plain numbers
        args.out.write_text(json.dumps(record, indent=1, default=lambda o:
                                       o.item() if hasattr(o, "item")
                                       else str(o)))

    stamp(17)
    # 17. Summary.
    sharded = fam_train["sharded"]
    print(json.dumps({"dryrun": {
        "phase_s": dry["phase_s"],
        "counts_equal": {tag: rec["equal"]
                         for tag, rec in dry["counts"].items()},
        "over_bound": {row["label"]: row["over_bound"]
                       for row in dry["roofline"]},
        "cells": dry["cells"]}}))
    print(json.dumps({"train_families": {
        "phase_s": fam_train["phase_s"],
        **{arch: {k: rec[k] for k in (
            "batch", "seq", "median_step_ms", "tokens_per_s", "peak_bytes",
            "state_bytes", "losses", "b3_launches_dedup", "b4_launches",
            "restart_bitwise")}
           for arch, rec in fam_train["families"].items()},
        "smoke_against_cpu": fam_train["smoke_against_cpu"],
        "sharded": {tag: {k: rec[k] for k in (
            "median_step_ms", "tokens_per_s", "losses", "grad_norms",
            "state_bytes", "peak_bytes", "collectives", "state_bytes_by_rank",
            "peak_bytes_by_rank", "loss_err", "grad_norm_err",
            "checkpoint_err", "samples_err", "routing") if k in rec}
            for tag, rec in sharded.items() if isinstance(rec, dict)},
        "spawn_s": sharded["spawn_s"]}}))
    print(json.dumps({"sharding": {
        "phase_s": shard["phase_s"], "spawn_s": shard["spawn_s"],
        "dropped_per_prefill": shard["dropped_per_prefill"],
        **{f"one_rank_{impl}": {k: rec[k] for k in (
            "wall_s", "prefill_tokens_per_s", "decode_tokens_per_s",
            "peak_bytes", "weight_bytes", "collectives_per_call",
            "bit_equal", "max_diff_unsharded") if k in rec}
           for impl, rec in shard["one_rank"].items()},
        **{f"two_ranks_{impl}": {
            **{k: rec[k] for k in (
                "wall_s", "prefill_tokens_per_s", "decode_tokens_per_s",
                "peak_bytes_by_rank", "weight_bytes_by_rank",
                "collectives_per_call", "b4_instance_launches", "heads")},
            **{k: shard["against_one_rank"][impl][k] for k in (
                "prefill_err", "decode_err", "router_err_prefill",
                "router_err_decode", "unclear", "decisions", "parted")}}
           for impl, rec in shard["sharded"].items()},
        "families": {
            "phase_s": shard_fam["phase_s"], "spawn_s": shard_fam["spawn_s"],
            "served": shard_fam["served"],
            "trained": {arch: {tag: {k: rec[k] for k in (
                "median_step_ms", "tokens_per_s", "losses", "grad_norms",
                "state_bytes", "peak_bytes", "collectives",
                "state_bytes_by_rank", "peak_bytes_by_rank", "loss_err",
                "grad_norm_err", "samples_err", "checkpoint_err")
                if k in rec} for tag, rec in recs.items()
                if isinstance(rec, dict)}
                for arch, recs in shard_fam["trained"].items()}}}},
        default=lambda o: o.item() if hasattr(o, "item") else str(o)))
    print(json.dumps({"families": {
        arch: {**{k: rec[k] for k in (
            "layers", "build_s", "weight_bytes", "peak_bytes", "wall_s",
            "prefill_tokens_per_s", "decode_tokens_per_s", "prefills",
            "decode_steps", "b4_instance_launches", "longest_prompt")},
            "cpu_prefill_err": max(r["errs"][0] for r in
                                   fam["cpu_check"][arch]["rows"]),
            "cpu_decode_err": max(max(r["errs"][1:], default=0.0) for r in
                                  fam["cpu_check"][arch]["rows"]),
            **({"evaluators": rec["evaluators"]} if "evaluators" in rec
               else {})}
        for arch, rec in fam["served"].items()},
        "phase_s": fam["phase_s"]}))
    print(json.dumps({"lm_configs": {
        arch: {k: rec[k] for k in (
            "build_s", "weight_bytes", "peak_bytes", "wall_s",
            "prefill_tokens_per_s", "decode_tokens_per_s", "prefills",
            "decode_steps", "launches", "dropped_per_prefill")
            if k in rec} for arch, rec in lm["configs"].items()}}))
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
