"""Serving driver: continuous batching over prefill/decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        [--smoke] [--device cpu] --requests 6 --max-new 12

The port of ``repro/launch/serve.py``: the same request distribution from
``np.random.default_rng(seed)`` (prompts of 4–23 tokens, 2 to
``max_new - 1`` new tokens each), f32 weights drawn from a
``torch.Generator`` seeded with ``seed``. On the card every prefill runs
kernel B4 once per layer.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import get_config, get_smoke
from ..models import build_model
from ..serve.batching import ContinuousBatcher, Request
from ..util import DeviceLike


def run(arch: str, smoke: bool, n_requests: int, max_new: int,
        max_slots: int = 4, cache_len: int = 160, seed: int = 0,
        device: DeviceLike = None):
    cfg = get_smoke(arch) if smoke else get_config(arch)
    model = build_model(cfg, device=device, dtype=torch.float32,
                        generator=torch.Generator().manual_seed(seed))

    rng = np.random.default_rng(seed)
    batcher = ContinuousBatcher(model, max_slots=max_slots,
                                cache_len=cache_len)
    reqs = []
    for i in range(n_requests):
        ln = int(rng.integers(4, 24))
        prompt = rng.integers(2, cfg.vocab_size, ln).astype(np.int32)
        r = Request(uid=i, prompt=prompt,
                    max_new_tokens=int(rng.integers(2, max_new)))
        reqs.append(r)
        batcher.admit(r)
    batcher.run()
    st = batcher.stats
    print(f"served {n_requests} requests: prefills={st.prefills} "
          f"decode_steps={st.decode_steps} tokens={st.emitted_tokens} "
          f"wasted_slot_steps={st.wasted_slot_steps}")
    for r in reqs:
        if not (r.done and r.out_tokens):
            raise RuntimeError(f"request {r.uid} unserved")
    return reqs, st


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    run(args.arch, smoke=args.smoke, n_requests=args.requests,
        max_new=args.max_new, max_slots=args.slots, seed=args.seed,
        device=args.device)


if __name__ == "__main__":
    main()
