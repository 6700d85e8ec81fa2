"""Prefill and single-token decode for the dense family.

The port of ``repro/models/decoding.py``'s dense branch. Caches are a dict
``{"k", "v"}`` of ``(L, B, S, KH, hd)`` tensors, bf16 by default as in the
reference. :func:`prefill` writes the prompt's keys and values (after
RoPE) into fresh zero caches, every layer's attention through kernel B4
whatever the model's ``RunConfig`` says; :func:`decode_step` writes one
position of every layer's cache in place, where the reference threads the
caches through its layer scan and returns new ones. Both run under
``torch.no_grad()``: serving takes no gradient, so weights made trainable
by training serve through B4 as well. Other families raise
``NotImplementedError`` (ROADMAP A18).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..configs.base import ModelConfig, check_family
from .attention import attention, decode_attention
from .common import rms_norm
from .mlp import mlp
from .transformer import Transformer, lm_head


def init_caches(cfg: ModelConfig, batch: int, seq_len: int,
                dtype: torch.dtype = torch.bfloat16,
                device=None) -> Dict[str, torch.Tensor]:
    """Empty (zero) caches sized for ``seq_len`` decode."""
    check_family(cfg.family)
    shape = (cfg.num_layers, batch, seq_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _logits(params: Transformer, cfg: ModelConfig,
            x: torch.Tensor) -> torch.Tensor:
    """f32 logits (B, Vpad) of the last position of x (B, S, D)."""
    last = rms_norm(x[:, -1], params.ln_f, cfg.norm_eps)
    return torch.matmul(last.float(), lm_head(params, cfg).float())


@torch.no_grad()
def prefill(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor,
            cache_len: Optional[int] = None,
            cache_dtype: torch.dtype = torch.bfloat16):
    """Run the prompt tokens (B, S); returns (last-token logits (B, Vpad)
    in f32, caches padded with zeros to ``cache_len``)."""
    b, s = tokens.shape
    cache_len = cache_len or s
    x = params.embed[tokens]
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    caches = init_caches(cfg, b, cache_len, cache_dtype, x.device)
    for layer, p in enumerate(params.blocks):
        out = attention(p.attn, cfg, rms_norm(x, p.ln1, cfg.norm_eps),
                        positions, impl="pallas", return_kv=True)
        x = x + out.out
        x = x + mlp(p.mlp, rms_norm(x, p.ln2, cfg.norm_eps))
        caches["k"][layer, :, :s] = out.k.to(cache_dtype)
        caches["v"][layer, :, :s] = out.v.to(cache_dtype)
    return _logits(params, cfg, x), caches


@torch.no_grad()
def decode_step(params: Transformer, cfg: ModelConfig, token: torch.Tensor,
                caches: Dict[str, torch.Tensor], pos: int):
    """token (B,); pos an int. Returns (logits (B, Vpad) in f32, caches).

    The caches are updated in place at ``pos`` and returned as given.
    """
    x = params.embed[token[:, None]]                     # (B, 1, D)
    for layer, p in enumerate(params.blocks):
        out = decode_attention(p.attn, cfg, rms_norm(x, p.ln1, cfg.norm_eps),
                               pos, caches["k"][layer], caches["v"][layer])
        x = x + out.out
        x = x + mlp(p.mlp, rms_norm(x, p.ln2, cfg.norm_eps))
    return _logits(params, cfg, x), caches


__all__ = ["init_caches", "prefill", "decode_step"]
