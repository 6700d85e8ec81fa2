"""Model facade: the weights as an ``nn.Module`` with the entry points
``loss`` (training), ``prefill`` and ``decode_step`` (serving).

The port of ``repro/models/model.py``. The reference's ``Model`` holds a
config, a sharding plan and a ``RunConfig`` and takes the params on every
call; here the module owns its weights and its ``RunConfig``, so the calls
take none. The dry-run specs wait for ROADMAP A18.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..configs.base import ModelConfig
from ..util import DeviceLike, resolve_device
from . import decoding, transformer
from .transformer import RunConfig


class Model(transformer.Transformer):
    """A dense model's weights, its ``RunConfig`` and its entry points."""

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator],
                 dtype: torch.dtype, device: torch.device,
                 rc: Optional[RunConfig] = None):
        super().__init__(cfg, generator, dtype, device)
        self.rc = rc or RunConfig()
        self.rc.check(cfg.family)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return transformer.forward(self, self.cfg, self.rc, tokens)

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token loss of ``{"tokens", "labels"}`` (B, S)."""
        return transformer.loss_fn(self, self.cfg, self.rc, batch)

    def prefill(self, tokens: torch.Tensor, cache_len: Optional[int] = None,
                cache_dtype: torch.dtype = torch.bfloat16):
        return decoding.prefill(self, self.cfg, tokens, cache_len=cache_len,
                                cache_dtype=cache_dtype)

    def decode_step(self, token: torch.Tensor,
                    caches: Dict[str, torch.Tensor], pos: int):
        return decoding.decode_step(self, self.cfg, token, caches, pos)


def build_model(cfg: ModelConfig, device: DeviceLike = None,
                dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None,
                rc: Optional[RunConfig] = None) -> Model:
    """A model with weights drawn from ``generator`` (a fresh CPU generator
    seeded 0 when None) and placed on ``device``, running with ``rc``
    (``RunConfig()`` when None: chunked attention in ``forward`` and
    ``loss``; serving always takes kernel B4).

    ``device=None`` means CUDA and raises without it; ``"cpu"`` runs the
    plain path; ``"meta"`` builds the shapes and allocates nothing.
    """
    meta = device is not None and torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator().manual_seed(0)
    return Model(cfg, generator, dtype, dev, rc)


__all__ = ["Model", "build_model"]
