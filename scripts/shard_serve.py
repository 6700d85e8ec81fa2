#!/usr/bin/env python3
"""Sharded serving across cards: a (data 1, model N) mesh of N NCCL ranks,
one a card, against one rank on one card.

Run from the root of a checkout on a machine with N CUDA cards:

    python3 scripts/shard_serve.py [--arch ARCH ...] [--ranks 4] [--seed 0]
                                   [--out out.json]
    python3 scripts/shard_serve.py --arch llama-3.2-vision-90b --full-depth \\
                                   --dtype bfloat16 [--ranks 4]

or rehearse it on the CPU at smoke size, in N gloo processes:

    python3 scripts/shard_serve.py --device cpu --smoke [--arch ARCH ...]

``--arch`` (repeatable; default olmoe-1b-7b) takes every registered
architecture. A dense or MoE one runs phase 13 of ``chip_smoke.py``
(``shard_serving``) with the sharded ranks on cards of their own: the
unsharded model and one rank on a (1, 1) mesh (``sort``, bit for bit equal
to it, and for MoE ``ep_local``) serve phase 11's 8 requests under
deterministic algorithms on card 0; then the N ranks serve them, each held
to one rank as phase 13 holds it (prefill logits within 1e-4, decode
within 5e-2, routing, drops). rwkv6-1.6b, zamba2-2.7b, whisper-base and
the VLM run phase 15's serving half (``shard_families``) at its cuts:
unsharded and (1, 1) bit for bit on card 0, then the N ranks in lockstep,
held to (1, 1) (prefill logits 1e-4, decode 5e-2, the WKV and SSD states
1e-4 of their largest value, B4 at the local-head instances).
``--full-depth`` serves each ``--arch`` of those four at its published
depth in ``--dtype`` weights on (1, N) only (``serve_full_depth``: no card
holds the whole model, so the ranks are held to each other). It prints the
collective calls and bytes per prefill and decode step, the bytes a rank
holds, tokens/s, and the card's name and power limit.
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
                        help="an architecture to serve (repeatable)")
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--smoke", action="store_true",
                        help="the smoke configs (a rehearsal on the CPU)")
    parser.add_argument("--full-depth", action="store_true",
                        help="the families at their published depth, on "
                        "(1, N) only")
    parser.add_argument("--dtype", default="float32",
                        choices=("float32", "bfloat16"),
                        help="the weights' dtype with --full-depth")
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()
    from repro_torch.configs import ARCH_NAMES, get_config, get_smoke
    from repro_torch.launch.train import set_cublas_workspace

    archs = args.arch or [cs.SHARD_ARCH]
    for arch in archs:
        if arch not in ARCH_NAMES:
            parser.error(f"--arch {arch!r} is not one of {ARCH_NAMES}")
    get = get_smoke if args.smoke else get_config
    families = [a for a in archs if a in cs.SHARD_FAMILY_ARCHS]
    others = [a for a in archs if a not in cs.SHARD_FAMILY_ARCHS]
    if args.full_depth and others:
        parser.error("--full-depth takes the four families of phase 15")
    dev = torch.device(args.device)
    if dev.type == "cuda":
        set_cublas_workspace()
        if torch.cuda.device_count() < args.ranks:
            print(f"shard_serve: {args.ranks} ranks need as many cards, "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        from repro_torch.kernels import _build
        _build.build(_build.sources())
        card = cs.card_line()
        backend = "nccl"
    else:
        card, backend = "cpu", "gloo"
        for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
            setattr(torch.cuda, name, lambda *a, **k: None)
        torch.cuda.max_memory_allocated = lambda *a, **k: None
    if args.smoke:
        cs._smoke_configs()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card}, {torch.cuda.device_count()} cards; torch "
          f"{torch.__version__}")
    t0 = time.perf_counter()
    out: dict = {"card": card, "ranks": args.ranks, "backend": backend}
    summary: dict = {}
    for arch in others:
        rec = cs.shard_serving(dev, card, args.seed, get(arch),
                               ranks=args.ranks, backend=backend)
        out[arch] = rec
        summary[arch] = {
            **{f"{mesh}_{impl}": {k: r.get(k) for k in (
                "wall_s", "prefill_tokens_per_s", "decode_tokens_per_s",
                "weight_bytes", "weight_bytes_by_rank", "peak_bytes",
                "peak_bytes_by_rank", "collectives_per_call",
                "b4_instance_launches", "heads")}
               for mesh in ("one_rank", "sharded")
               for impl, r in rec[mesh].items()},
            "against_one_rank": {
                impl: {k: row[k] for k in (
                    "prefill_err", "decode_err", "router_err_prefill",
                    "router_err_decode", "unclear", "decisions", "parted")}
                for impl, row in rec["against_one_rank"].items()}}
    if families and args.full_depth:
        for arch in families:
            rec = cs.serve_full_depth(dev, card, args.seed, arch, args.ranks,
                                      backend, args.dtype, smoke=args.smoke)
            out[f"{arch}_full_depth"] = rec
            summary[f"{arch}_full_depth"] = {k: rec[k] for k in (
                "layers", "build_s", "wall_s", "prefill_tokens_per_s",
                "decode_tokens_per_s", "weight_bytes_by_rank",
                "peak_bytes_by_rank", "collectives_per_call", "b4", "heads",
                "spawn_s")}
            summary[f"{arch}_full_depth"]["b4"] = rec["b4"][0]
    elif families:
        rec = cs.shard_families(dev, card, args.seed, ranks=args.ranks,
                                backend=backend, smoke=args.smoke,
                                archs=tuple(families), train=False)
        out["families"] = rec
        summary.update(rec["served"])
        summary["spawn_s"] = rec["spawn_s"]
    out["wall_s"] = time.perf_counter() - t0
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1, default=str))
    print(card)
    print(json.dumps({"card": card, "ranks": args.ranks, "backend": backend,
                      "wall_s": out["wall_s"], **summary}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
