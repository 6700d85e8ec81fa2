#!/usr/bin/env python3
"""Sharded serving across cards: olmoe-1b-7b on a (data 1, model N) mesh
of N NCCL ranks, one a card, against one rank on one card.

Run from the root of a checkout on a machine with N CUDA cards:

    python3 scripts/shard_serve.py [--ranks 4] [--seed 0] [--out out.json]

or rehearse it on the CPU at smoke size, in N gloo processes:

    python3 scripts/shard_serve.py --device cpu --smoke

It is phase 13 of ``chip_smoke.py`` (``shard_serving``) with the
sharded ranks on cards of their own: the unsharded model and one rank on a
(1, 1) mesh (``sort``, bit for bit equal to it, and ``ep_local``) serve
phase 11's 8 requests under deterministic algorithms on card 0; then the N
ranks serve them with each impl, and each is held to one rank as phase 13
holds it (prefill logits within 1e-4, decode within 5e-2, routing, drops).
It prints the collective calls and bytes per prefill and decode step, the
bytes a rank holds, tokens/s, and the card's name and power limit.
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
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--smoke", action="store_true",
                        help="the smoke config (a rehearsal on the CPU)")
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.launch.train import set_cublas_workspace

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
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = (get_smoke if args.smoke else get_config)(cs.SHARD_ARCH)
    print(f"card: {card}, {torch.cuda.device_count()} cards; torch "
          f"{torch.__version__}")
    t0 = time.perf_counter()
    out = cs.shard_serving(dev, card, args.seed, cfg, ranks=args.ranks,
                           backend=backend)
    out["wall_s"] = time.perf_counter() - t0
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1,
                                       default=lambda o: o.item()))
    print(json.dumps({"card": card, "ranks": args.ranks, "backend": backend,
                      "wall_s": out["wall_s"], **{
                          f"{mesh}_{impl}": {k: rec.get(k) for k in (
                              "wall_s", "prefill_tokens_per_s",
                              "decode_tokens_per_s", "weight_bytes",
                              "weight_bytes_by_rank", "peak_bytes",
                              "peak_bytes_by_rank", "collectives_per_call",
                              "b4_instance_launches", "heads")}
                          for mesh in ("one_rank", "sharded")
                          for impl, rec in out[mesh].items()},
                      "against_one_rank": {
                          impl: {k: row[k] for k in (
                              "prefill_err", "decode_err",
                              "router_err_prefill", "router_err_decode",
                              "unclear", "decisions", "parted")}
                          for impl, row in out["against_one_rank"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
