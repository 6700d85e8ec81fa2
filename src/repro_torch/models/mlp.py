"""SwiGLU MLP block.

The port of ``repro/models/mlp.py``'s dense path (``init_mlp``, ``mlp``).
Mixture-of-experts waits for ROADMAP A18 (MoE).
"""

from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from .common import dense_init, linear, weight


class MLP(nn.Module):
    """Weights of one SwiGLU block: wi, wg (d, ff) and wo (ff, d)."""

    def __init__(self, cfg: ModelConfig, generator, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.wi = weight(dense_init((d, f), generator, dtype, device))
        self.wg = weight(dense_init((d, f), generator, dtype, device))
        self.wo = weight(dense_init((f, d), generator, dtype, device))


def init_mlp(cfg: ModelConfig, generator, dtype, device) -> MLP:
    return MLP(cfg, generator, dtype, device)


def mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.silu(linear(x, p.wg)) * linear(x, p.wi)
    return linear(h, p.wo)


__all__ = ["MLP", "init_mlp", "mlp"]
