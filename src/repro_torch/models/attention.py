"""GQA attention for prefill (kernel B4) and decode (KV cache).

The port of ``repro/models/attention.py``. Full-sequence attention always
goes through the B4 wrapper :func:`repro_torch.kernels.flash_attention.
flash_attention` (the CUDA kernel on the card, its plain version on the
CPU); the reference's ``naive`` and ``chunked`` alternatives to the kernel
are not ported, so there is no ``impl`` knob. Cross-attention (``kv_x``)
and the non-causal encoder path belong to families not ported yet (ROADMAP
A18).

Decode attends a one-token query against a padded cache with a position
mask. Unlike the reference, which returns updated caches functionally,
:func:`decode_attention` writes the new key and value into the caches it
is given, in place.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..kernels.flash_attention import flash_attention
from ..kernels.ref import NEG_INF
from .common import apply_rope, dense_init, head_rms_norm, linear, weight


class Attention(nn.Module):
    """Weights of one attention layer: wq (d, H·hd), wk/wv (d, KH·hd),
    wo (H·hd, d), and the qk-norm scales where the config has them."""

    def __init__(self, cfg: ModelConfig, generator, dtype, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        nq, nkv = cfg.num_heads * hd, cfg.num_kv_heads * hd
        self.wq = weight(dense_init((d, nq), generator, dtype, device))
        self.wk = weight(dense_init((d, nkv), generator, dtype, device))
        self.wv = weight(dense_init((d, nkv), generator, dtype, device))
        self.wo = weight(dense_init((nq, d), generator, dtype, device))
        if cfg.qk_norm:
            self.q_norm = weight(torch.ones(hd, dtype=dtype, device=device))
            self.k_norm = weight(torch.ones(hd, dtype=dtype, device=device))


def init_attention(cfg: ModelConfig, generator, dtype, device) -> Attention:
    return Attention(cfg, generator, dtype, device)


class AttnOutput(NamedTuple):
    out: torch.Tensor
    k: Optional[torch.Tensor]  # projected K (B,S,KH,hd) for cache building
    v: Optional[torch.Tensor]


def _project(p: Attention, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor):
    """q (B,S,H,hd) and k, v (B,S,KH,hd), normed and rotated."""
    b, s, _ = x.shape
    hd, h, kh = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    q = linear(x, p.wq).reshape(b, s, h, hd)
    k = linear(x, p.wk).reshape(b, s, kh, hd)
    v = linear(x, p.wv).reshape(b, s, kh, hd)
    if cfg.qk_norm:
        q = head_rms_norm(q, p.q_norm, cfg.norm_eps)
        k = head_rms_norm(k, p.k_norm, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention(p: Attention, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, *,
              return_kv: bool = False) -> AttnOutput:
    """Causal self-attention over the full sequence. x (B,S,D).

    Query head ``h`` reads KV head ``h // (H // KH)``, the grouped layout
    ``(B,S,KH,G,hd)`` of the reference flattened; the kernel takes heads
    before the sequence, so q, k and v are transposed to ``(B,·,S,hd)``.
    """
    b, s, _ = x.shape
    q, k, v = _project(p, cfg, x, positions)
    o = flash_attention(q.transpose(1, 2).contiguous(),
                        k.transpose(1, 2).contiguous(),
                        v.transpose(1, 2).contiguous(), causal=True)
    o = o.transpose(1, 2).reshape(b, s, cfg.num_heads * cfg.head_dim)
    return AttnOutput(out=linear(o, p.wo), k=k if return_kv else None,
                      v=v if return_kv else None)


def decode_attention(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                     pos: int, cache_k: torch.Tensor,
                     cache_v: torch.Tensor) -> AttnOutput:
    """One-token decode. x (B,1,D); cache_k/v (B,S,KH,hd); pos an int.

    Writes the new key and value at ``pos`` of ``cache_k``/``cache_v`` in
    place and attends keys ``<= pos``. The casts are the reference's: the
    scaled query goes to the cache dtype before the score product and the
    probabilities before the value product, and both products accumulate
    in f32 (operands widened to f32, which holds bf16 products exactly).
    """
    b = x.shape[0]
    hd, h, kh = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project(p, cfg, x, posv)
    cache_k[:, pos] = k_new[:, 0].to(cache_k.dtype)
    cache_v[:, pos] = v_new[:, 0].to(cache_v.dtype)

    qg = q.reshape(b, 1, kh, h // kh, hd)
    scale = 1.0 / (hd ** 0.5)
    s = torch.einsum("bqkgd,bskd->bkgqs",
                     (qg * scale).to(cache_k.dtype).float(), cache_k.float())
    keep = torch.arange(cache_k.shape[1], device=x.device) <= pos
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    probs = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", probs.to(cache_v.dtype).float(),
                     cache_v.float())
    o = o.to(x.dtype).reshape(b, 1, h * hd)
    return AttnOutput(out=linear(o, p.wo), k=cache_k, v=cache_v)


__all__ = ["Attention", "init_attention", "attention", "decode_attention",
           "AttnOutput"]
