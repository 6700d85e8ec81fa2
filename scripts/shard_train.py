#!/usr/bin/env python3
"""Sharded training across cards: smollm-135m on (N, 1) and (1, N) meshes
and olmoe-1b-7b (2 layers) on (1, N), or the architectures ``--arch``
names, N NCCL ranks, one a card, against one rank on one card.

Run from the root of a checkout on a machine with N CUDA cards:

    python3 scripts/shard_train.py [--arch ARCH ...] [--ranks 4] [--seed 0]
                                   [--out out.json]

or rehearse it on the CPU at smoke size, in N gloo processes:

    python3 scripts/shard_train.py --device cpu --smoke [--arch ARCH ...]

``--arch`` (repeatable) takes every registered architecture: a dense one
takes smollm-135m's place below, an MoE one olmoe-1b-7b's (cut to 2
layers); rwkv6-1.6b, zamba2-2.7b, whisper-base and the VLM run phase 15's
training half (``shard_families``, its cuts, 2 steps of 2 x 128 tokens):
unsharded and (1, 1) bit for bit on card 0, then (1, N) and (N, 1), each
held to (1, 1) as phase 15 holds it, whisper's (N, 1) checkpoint saved
from the shards and restored into the unsharded model. Without ``--arch``
it runs smollm-135m and olmoe-1b-7b as follows.

It is phases (14g) and (14h) of ``chip_smoke.py`` (``shard_training``)
with the sharded ranks on cards of their own: the unsharded smollm step
and one rank on a (1, 1) mesh (bit for bit equal to it), and olmoe's cut
on (1, 1), on card 0, under deterministic algorithms; then the N ranks
train smollm on (N, 1) (ZeRO over data, data-parallel) and (1, N) (the
SwiGLU and the vocabulary tensor-parallel), olmoe on (1, N) (expert
parallel), each held to one rank as phase 14 holds it (losses 1e-5 and
grad_norm 1e-3 relative, checkpoints saved from the shards, the first
step's routing). It prints step ms, tokens/s, the collective calls and
bytes a step by kind, the state bytes a rank, and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--arch", action="append", default=None,
                        help="an architecture to train (repeatable)")
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--smoke", action="store_true",
                        help="the smoke configs (a rehearsal on the CPU)")
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()
    from repro_torch.configs import ARCH_NAMES, get_config
    from repro_torch.launch.train import set_cublas_workspace

    archs = args.arch or [cs.SHARD_TRAIN_ARCH, cs.MOE_TRAIN_ARCH]
    for arch in archs:
        if arch not in ARCH_NAMES:
            parser.error(f"--arch {arch!r} is not one of {ARCH_NAMES}")
    by_family = {}
    for arch in archs:
        by_family.setdefault(get_config(arch).family, []).append(arch)
    if any(len(v) > 1 for f, v in by_family.items()
           if f in ("dense", "moe")):
        parser.error("one dense and one MoE --arch at most")
    families = tuple(a for a in archs if a in cs.SHARD_FAMILY_ARCHS)

    dev = torch.device(args.device)
    if dev.type == "cuda":
        set_cublas_workspace()
        if torch.cuda.device_count() < args.ranks:
            print(f"shard_train: {args.ranks} ranks need as many cards, "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        card = cs.card_line()
        backend = "nccl"
    else:
        card, backend = "cpu", "gloo"
        # The CPU's multithreaded index and scatter gradients add in a
        # varying order; one thread keeps (1, 1) bit for bit the unsharded
        # step, as deterministic algorithms keep it on the card.
        torch.set_num_threads(1)
        for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
            setattr(torch.cuda, name, lambda *a, **k: None)
        torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card}, {torch.cuda.device_count()} cards; torch "
          f"{torch.__version__}")
    t0 = time.perf_counter()
    out: dict = {"ranks": args.ranks, "backend": backend}
    dense, moe = by_family.get("dense"), by_family.get("moe")
    if dense or moe:
        out = cs.shard_training(dev, card, args.seed, smoke=args.smoke,
                                ranks=args.ranks, backend=backend,
                                arch=dense[0] if dense else None,
                                moe_arch=moe[0] if moe else None)
    if families:
        if args.smoke:
            cs._smoke_configs()
        fam = cs.shard_families(dev, card, args.seed, ranks=args.ranks,
                                backend=backend, smoke=args.smoke,
                                archs=families, serve=False)
        out["families_spawn_s"] = fam["spawn_s"]
        for arch, rec in fam["trained"].items():
            for tag, r in rec.items():
                if isinstance(r, dict):
                    out[f"{arch}_{tag}"] = r
    out["wall_s"] = time.perf_counter() - t0
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1, default=str))
    keys = ("median_step_ms", "tokens_per_s", "losses", "grad_norms",
            "state_bytes", "state_bytes_by_rank", "peak_bytes",
            "peak_bytes_by_rank", "collectives", "loss_err",
            "grad_norm_err", "checkpoint_err", "samples_err", "routing")
    print(card)
    print(json.dumps({"card": card, "ranks": args.ranks, "backend": backend,
                      "wall_s": out["wall_s"], "spawn_s": out.get("spawn_s"),
                      **{tag: {k: rec[k] for k in keys if k in rec}
                         for tag, rec in out.items()
                         if isinstance(rec, dict)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
