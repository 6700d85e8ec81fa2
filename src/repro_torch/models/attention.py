"""GQA attention: full sequence (three impls) and decode (KV cache).

The port of ``repro/models/attention.py``. Full-sequence attention has the
reference's three implementations with one contract:

* ``impl='pallas'``: kernel B4 through :func:`repro_torch.kernels.
  flash_attention.flash_attention` (the CUDA kernel on the card, its plain
  version on the CPU). It has no backward, as the reference's kernel has
  none, so on the card it refuses inputs that require grad. Serving
  (``models/decoding.py``) always takes it.
* ``impl='chunked'``: blocked softmax in plain torch (a loop over KV blocks
  with a running max and denominator, ``q_chunk=512``, ``kv_chunk=1024``),
  each query block and each KV step under
  ``torch.utils.checkpoint.checkpoint`` as the reference puts them under
  ``jax.checkpoint``: O(S·block) memory, differentiable. Training takes
  it.
* ``impl='naive'``: the quadratic reference, for tiny smoke shapes.

The naive and chunked forms work in the reference's grouped layout
``(B, S, KH, G, hd)``: KV is never repeated to H heads. Cross-attention
(``kv_x``) and the non-causal encoder path belong to families not ported
yet (ROADMAP A18).

Decode attends a one-token query against a padded cache with a position
mask. Unlike the reference, which returns updated caches functionally,
:func:`decode_attention` writes the new key and value into the caches it
is given, in place.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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


IMPLS = ("naive", "chunked", "pallas")


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, row_offset: int = 0) -> torch.Tensor:
    """q (B,Sq,KH,G,hd), k/v (B,Sk,KH,hd): the quadratic reference."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        rows = torch.arange(sq, device=q.device)[:, None] + row_offset
        cols = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(rows >= cols, s, NEG_INF)
    probs = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.to(q.dtype)


def _kv_step(m, l, acc, qi, ki, vi, mask):
    """One KV block of the blocked softmax: (m, l, acc) updated."""
    s = torch.einsum("bqkgd,bskd->bkgqs", qi, ki)        # (B,KH,G,qc,kc)
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    pexp = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + pexp.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum("bkgqs,bskd->bkgqd",
                                                    pexp, vi)
    return m_new, l_new, acc_new


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool, row_offset: int = 0,
                      q_chunk: int = 512, kv_chunk: int = 1024
                      ) -> torch.Tensor:
    """Blocked-softmax attention in plain torch (the kernel's math).

    q (B,Sq,KH,G,hd), k/v (B,Sk,KH,hd). Sq and Sk are padded to whole
    blocks; padded keys are masked, padded query rows dropped. A row whose
    denominator is 0 divides by 1, as in the reference. Each query block
    and each KV step is checkpointed (recomputed in the backward), so the
    (q_chunk, kv_chunk) scores are never kept for the backward.
    """
    b, sq, kh, g, hd = q.shape
    sk = k.shape[1]
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, sk)
    pq, pk = (-sq) % q_chunk, (-sk) % kv_chunk
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, 0, 0, pq))
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pk))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pk))
    nq, nk = qp.shape[1] // q_chunk, kp.shape[1] // kv_chunk
    scale = 1.0 / (hd ** 0.5)
    kb = kp.reshape(b, nk, kv_chunk, kh, hd)
    vb = vp.reshape(b, nk, kv_chunk, kh, hd)
    qb = qp.reshape(b, nq, q_chunk, kh, g, hd)
    dev = q.device

    def q_block(iq: int, qblk, kb, vb):
        qi = qblk.float() * scale                         # (B,qc,KH,G,hd)
        rows = (iq * q_chunk + torch.arange(q_chunk, device=dev))[:, None] \
            + row_offset
        m = torch.full((b, kh, g, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, kh, g, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kh, g, q_chunk, hd), dtype=torch.float32,
                          device=dev)
        for ik in range(nk):
            cols = ik * kv_chunk + torch.arange(kv_chunk, device=dev)[None, :]
            mask = cols < sk                              # kv padding
            if causal:
                mask = mask & (rows >= cols)
            m, l, acc = checkpoint(_kv_step, m, l, acc, qi, kb[:, ik].float(),
                                   vb[:, ik].float(), mask,
                                   use_reentrant=False)
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        out = acc / l[..., None]                          # (B,KH,G,qc,hd)
        return out.permute(0, 3, 1, 2, 4)                 # (B,qc,KH,G,hd)

    outs = [checkpoint(q_block, iq, qb[:, iq], kb, vb, use_reentrant=False)
            for iq in range(nq)]
    out = torch.stack(outs, dim=1).reshape(b, nq * q_chunk, kh, g, hd)
    return out[:, :sq].to(q.dtype)


def _pallas_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool) -> torch.Tensor:
    """q (B,Sq,KH,G,hd), k/v (B,Sk,KH,hd) through kernel B4, which takes
    heads before the sequence: query head ``h`` of ``(B,H,S,hd)`` is group
    ``h // G`` of the grouped layout, the one B4 reads KV head ``h // G``
    for."""
    b, sq, kh, g, hd = q.shape
    o = flash_attention(q.reshape(b, sq, kh * g, hd).transpose(1, 2)
                        .contiguous(), k.transpose(1, 2).contiguous(),
                        v.transpose(1, 2).contiguous(), causal=causal)
    return o.transpose(1, 2).reshape(b, sq, kh, g, hd)


def attention(p: Attention, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, *, impl: str,
              return_kv: bool = False) -> AttnOutput:
    """Causal self-attention over the full sequence. x (B,S,D).

    ``impl`` is one of :data:`IMPLS`, and every caller names it: serving
    takes ``pallas`` (kernel B4), training its ``RunConfig.attn_impl``
    (``chunked`` by default, as in the reference).
    """
    if impl not in IMPLS:
        raise ValueError(f"attention impl {impl!r} is not one of {IMPLS}")
    b, s, _ = x.shape
    q, k, v = _project(p, cfg, x, positions)
    qg = q.reshape(b, s, cfg.num_kv_heads,
                   cfg.num_heads // cfg.num_kv_heads, cfg.head_dim)
    if impl == "naive":
        o = naive_attention(qg, k, v, causal=True)
    elif impl == "chunked":
        o = chunked_attention(qg, k, v, causal=True)
    else:
        o = _pallas_attention(qg, k, v, causal=True)
    o = o.reshape(b, s, cfg.num_heads * cfg.head_dim)
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
           "naive_attention", "chunked_attention", "AttnOutput", "IMPLS"]
