"""Dense-family model assembly: weights, blocks, forward, head.

The port of ``repro/models/transformer.py``'s dense family. The reference
stacks each weight over a leading layer axis and scans it; here every
layer is a :class:`Block` module in a ``ModuleList`` and the loop is a
Python loop, which eager PyTorch runs without compiling. The reference's
``RunConfig`` is not ported: each of its fields picks an implementation or
a training option (attention and MoE impls, remat, loss chunking, the RWKV
and SSD impls, a mesh) that the dense serving path does not have.
Other families raise ``NotImplementedError`` (ROADMAP A18).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..configs.base import ModelConfig, check_family
from .attention import Attention, attention
from .common import dense_init, rms_norm, weight
from .mlp import MLP, mlp


def _norm(cfg: ModelConfig, dtype, device) -> nn.Parameter:
    return weight(torch.ones(cfg.d_model, dtype=dtype, device=device))


class Block(nn.Module):
    """Weights of one dense block: ln1, attention, ln2, SwiGLU."""

    def __init__(self, cfg: ModelConfig, generator, dtype, device):
        super().__init__()
        self.ln1 = _norm(cfg, dtype, device)
        self.attn = Attention(cfg, generator, dtype, device)
        self.ln2 = _norm(cfg, dtype, device)
        self.mlp = MLP(cfg, generator, dtype, device)


class Transformer(nn.Module):
    """All weights of a dense model, initialised from ``generator``.

    ``embed`` (Vpad, d), ``ln_f`` (d,), ``lm_head`` (d, Vpad) unless the
    embeddings are tied, and ``blocks``, one :class:`Block` per layer.
    """

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator],
                 dtype: torch.dtype, device: torch.device):
        super().__init__()
        check_family(cfg.family)
        self.cfg = cfg
        v, d = cfg.padded_vocab, cfg.d_model
        self.embed = weight(dense_init((v, d), generator, dtype, device,
                                       in_axis_size=d))
        self.ln_f = _norm(cfg, dtype, device)
        if not cfg.tie_embeddings:
            self.lm_head = weight(dense_init((d, v), generator, dtype,
                                             device))
        self.blocks = nn.ModuleList(
            Block(cfg, generator, dtype, device)
            for _ in range(cfg.num_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _dense_block(p: Block, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    x = x + attention(p.attn, cfg, rms_norm(x, p.ln1, cfg.norm_eps),
                      positions).out
    return x + mlp(p.mlp, rms_norm(x, p.ln2, cfg.norm_eps))


def forward(params: Transformer, cfg: ModelConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward to final hidden states (B, S, D)."""
    x = params.embed[tokens]
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=x.device)
    for p in params.blocks:
        x = _dense_block(p, cfg, x, positions)
    return rms_norm(x, params.ln_f, cfg.norm_eps)


def lm_head(params: Transformer, cfg: ModelConfig) -> torch.Tensor:
    """The (d, Vpad) output projection: ``embed.T`` when tied."""
    if cfg.tie_embeddings:
        return params.embed.T
    return params.lm_head


__all__ = ["Block", "Transformer", "forward", "lm_head"]
