"""Serving driver: continuous batching over prefill/decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \\
        [--smoke] [--device cpu] --requests 6 --max-new 12

The port of ``repro/launch/serve.py``: the same request distribution from
``np.random.default_rng(seed)`` (prompts of 4–23 tokens, 2 to
``max_new - 1`` new tokens each), f32 weights drawn from a
``torch.Generator`` on the serving device seeded with ``seed`` (so a
full-width model is drawn on the card, not the host), and the reference
launcher's run settings where the family reads them (:func:`run_config`:
the exact RWKV scan for ssm, SSD chunks of 16 for hybrid). ``--arch`` is
any registered architecture (``repro_torch.configs.ALL_ARCH_NAMES``: the
reference's and granite-4.0-h-small, which runs at ``--smoke`` size here,
its 129 GB of f32 weights being more than a card holds), but
whisper-base and llama-3.2-vision-90b are refused before anything is
built: the batcher prefills tokens only, and those families read stub
frame or patch embeddings (``audio_embeds``, ``image_embeds``) in every
prefill, so the reference's launcher fails at its first prefill with a
``KeyError`` for them. Serve them through ``Model.prefill`` with the
embeddings and ``Model.decode_step``. On the card every prefill runs
kernel B4 at each attention layer.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import ALL_ARCH_NAMES, get_config, get_smoke
from ..configs.base import ModelConfig
from ..models import build_model
from ..models.transformer import STUB_INPUTS, RunConfig
from ..serve.batching import ContinuousBatcher, Request
from ..util import DeviceLike, resolve_device


def run_config(cfg: ModelConfig) -> RunConfig:
    """The reference launcher's settings (``rwkv_impl="scan"``,
    ``ssd_chunk=16``), each passed only to the family that reads it."""
    return RunConfig(**{"ssm": {"rwkv_impl": "scan"},
                        "hybrid": {"ssd_chunk": 16}}.get(cfg.family, {}))


def check_servable(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a family whose prefill reads a stub input
    the batcher does not carry (encdec, vlm)."""
    key = STUB_INPUTS.get(cfg.family)
    if key is not None:
        raise ValueError(
            f"{cfg.name}: the {cfg.family} family's prefill reads "
            f"{key!r}, which ContinuousBatcher does not carry (it prefills "
            f"tokens only; the reference's launcher fails there with "
            f"KeyError: {key!r}); call Model.prefill with {key}= and "
            f"Model.decode_step instead")


def run(arch: str, smoke: bool, n_requests: int, max_new: int,
        max_slots: int = 4, cache_len: int = 160, seed: int = 0,
        device: DeviceLike = None):
    cfg = get_smoke(arch) if smoke else get_config(arch)
    check_servable(cfg)
    dev = resolve_device(device)
    model = build_model(cfg, device=dev, dtype=torch.float32,
                        generator=torch.Generator(dev).manual_seed(seed),
                        rc=run_config(cfg))

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
    ap.add_argument("--arch", default="smollm-135m", choices=ALL_ARCH_NAMES)
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
