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
``(B, S, KH, G, hd)``: KV is never repeated to H heads. Each impl takes
the ``causal`` flag: whisper's encoder and every cross-attention
(``kv_x``: keys and values from another sequence, no RoPE) are
non-causal, with Sq ≠ Sk for cross-attention. A cross-attention layer
(``Attention(cross=True)``) has no qk-norm and a ``gate`` (1,), zero at
init, whose ``tanh`` scales its output.

Decode attends a one-token query against a padded cache with a position
mask. Unlike the reference, which returns updated caches functionally,
:func:`decode_attention` writes the new key and value into the caches it
is given, in place; cross-attention decode reads a cache it does not
write (``update_cache``, ``rope_on_q`` and ``mask_to_pos`` off).

On a mesh (``layout``, ``models/parallel.py``) the weights are the
rank's blocks: ``wq``, ``wk``, ``wv`` column-parallel on the rank's heads
(their d_model rows gathered over data first, ZeRO-3, whose backward
reduce-scatters their gradients), ``wo`` row-parallel, followed by one
all-reduce over the heads' axes. In the backward the input's gradient,
and that of every replicated weight only the rank's heads use (the
qk-norm scales; ``wk``, ``wv`` where the kv heads are whole), is summed
over the heads' axes (``parallel.copy_to``), so each arrives whole and
equal on every rank. Where the
q heads are sharded and the kv heads are not, the rank's q heads read the
kv group of their *global* index (:func:`_kv_for_heads`). Where neither
divides the model axis, attention is replicated. A cross layer's
``kv_x`` (whisper's encoder output, the VLM's image embeddings) must come
copied in over the heads' axes (``parallel.copy_to``) by the caller, as
``transformer.forward`` does once for every cross layer: the encoder's
gradient is then summed over its uses in the order of the unsharded
model, and all-reduced once. The VLM's ``gate`` scales the output after
the row-parallel all-reduce, so every rank computes its whole gradient
once. Its cross K/V cache holds the rank's kv heads. A decode cache whose
sequence is split over mesh axes (``seq_axes``) is written only by the
rank that holds ``pos``, and the softmax combines the ranks' partials:
the max, then the sum of exponentials, then the weighted values, each an
all-reduce over those axes; q heads sharded on one of them are gathered
first and the rank keeps its own heads after the combine.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..kernels.flash_attention import flash_attention
from ..kernels.ref import NEG_INF
from .common import (apply_rope, dense_init, head_rms_norm, linear,
                     linear_rows, weight)
from .parallel import copy_to


class Attention(nn.Module):
    """Weights of one attention layer: wq (d, H·hd), wk/wv (d, KH·hd),
    wo (H·hd, d), and the qk-norm scales where the config has them; a
    cross-attention layer has no qk-norm and a ``gate`` (1,) of zeros."""

    def __init__(self, cfg: ModelConfig, generator, dtype, device,
                 cross: bool = False):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        nq, nkv = cfg.num_heads * hd, cfg.num_kv_heads * hd
        self.wq = weight(dense_init((d, nq), generator, dtype, device),
                         ("embed", "heads"))
        self.wk = weight(dense_init((d, nkv), generator, dtype, device),
                         ("embed", "kv"))
        self.wv = weight(dense_init((d, nkv), generator, dtype, device),
                         ("embed", "kv"))
        self.wo = weight(dense_init((nq, d), generator, dtype, device),
                         ("heads", "embed"))
        if cfg.qk_norm and not cross:
            self.q_norm = weight(torch.ones(hd, dtype=dtype, device=device),
                                 (None,))
            self.k_norm = weight(torch.ones(hd, dtype=dtype, device=device),
                                 (None,))
        if cross:
            self.gate = weight(torch.zeros(1, dtype=dtype, device=device),
                               (None,))


def init_attention(cfg: ModelConfig, generator, dtype, device,
                   cross: bool = False) -> Attention:
    return Attention(cfg, generator, dtype, device, cross)


class AttnOutput(NamedTuple):
    out: torch.Tensor
    k: Optional[torch.Tensor]  # projected K (B,S,KH,hd) for cache building
    v: Optional[torch.Tensor]


def _project(p: Attention, cfg: ModelConfig, x: torch.Tensor,
             positions: Optional[torch.Tensor],
             kv_x: Optional[torch.Tensor] = None, rope: bool = True,
             layout=None):
    """q (B,S,H,hd) from x and k, v (B,Sk,KH,hd) from ``kv_x`` (x when
    None), qk-normed where the layer has the scales, and rotated when
    ``rope`` and the model is neither attention-free nor ``nope``. Where
    the config sets ``attention_multiplier``, q is scaled so that the
    scores' ``1/sqrt(hd)`` becomes it. On a mesh, H and KH are the rank's
    heads."""
    b, s, _ = x.shape
    wq, wk, wv = p.wq, p.wk, p.wv
    q_norm, k_norm = getattr(p, "q_norm", None), getattr(p, "k_norm", None)
    if layout is not None:
        wq, wk, wv = (layout.whole(w, 0) for w in (wq, wk, wv))
        heads = layout.axes("heads")
        if heads:
            # The rank's heads take part of each replicated input's uses:
            # x, the qk-norm scales and, where the kv heads are whole, wk
            # and wv. Their gradients are summed over the heads' axes.
            x = copy_to(x, layout, heads)
            if not layout.axes("kv"):
                wk, wv = copy_to(wk, layout, heads), copy_to(wv, layout,
                                                             heads)
            if q_norm is not None:
                q_norm = copy_to(q_norm, layout, heads)
                k_norm = copy_to(k_norm, layout, heads)
    src = x if kv_x is None else kv_x
    hd = cfg.head_dim
    q = linear(x, wq).reshape(b, s, -1, hd)
    k = linear(src, wk).reshape(b, src.shape[1], -1, hd)
    v = linear(src, wv).reshape(b, src.shape[1], -1, hd)
    if cfg.qk_norm and q_norm is not None:
        q = head_rms_norm(q, q_norm, cfg.norm_eps)
        k = head_rms_norm(k, k_norm, cfg.norm_eps)
    if rope and not cfg.attention_free and not cfg.nope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if cfg.attention_multiplier:
        # Every impl scales scores by 1/sqrt(hd) (B4 fixes it): the query
        # carries the rest of the configured scale.
        q = q * (cfg.attention_multiplier * hd ** 0.5)
    return q, k, v


def _kv_for_heads(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
                  layout, n_q: int):
    """The kv heads (dim 2) that the rank's ``n_q`` q heads read. Without
    a mesh, or with q and kv heads split alike (or neither), k and v as
    given. Where the q heads are split and the kv heads are whole, q head
    ``h`` of global index ``first + h`` reads kv head ``(first + h) // G``:
    a contiguous range of kv heads where each takes the same number of
    the rank's q heads, else one kv head a q head."""
    g = cfg.num_heads // cfg.num_kv_heads
    if layout is None or k.shape[2] * g == n_q:
        return k, v
    first = layout.index(layout.axes("heads")) * n_q
    idx = (first + torch.arange(n_q)) // g
    lo, n = int(idx[0]), int(idx[-1]) - int(idx[0]) + 1
    if n_q % n == 0 and torch.equal(idx, lo + torch.arange(n_q) // (n_q // n)):
        return k[:, :, lo:lo + n], v[:, :, lo:lo + n]
    idx = idx.to(k.device)
    return k[:, :, idx], v[:, :, idx]


def _out(p: Attention, o: torch.Tensor, layout) -> torch.Tensor:
    """The output projection of o (B,S,H·hd), row-parallel on a mesh
    where the heads are split, then the gate."""
    if layout is None:
        return _gated(p, linear(o, p.wo))
    heads = layout.axes("heads")
    wo = layout.whole(p.wo, 1)
    out = linear_rows(o, wo, layout, heads) if heads else linear(o, wo)
    return _gated(p, out)


def _gated(p: Attention, out: torch.Tensor) -> torch.Tensor:
    """A cross-attention layer's output times ``tanh(gate)``."""
    if hasattr(p, "gate"):
        return out * torch.tanh(p.gate.to(out.dtype))
    return out


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

    On the meta device (the dry run) it is :func:`naive_attention`: the
    blocks bound memory and cost only time there, both forms give the
    same shapes and gradient edges, and neither issues a collective.
    """
    if q.device.type == "meta":
        return naive_attention(q, k, v, causal, row_offset)
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
              positions: Optional[torch.Tensor], *, impl: str,
              kv_x: Optional[torch.Tensor] = None, causal: bool = True,
              return_kv: bool = False, layout=None) -> AttnOutput:
    """Full-sequence attention (prefill, training, encoder, cross).
    x (B,S,D); ``kv_x`` (B,Sk,D) makes it cross-attention, without RoPE
    (``positions`` may then be None).

    ``impl`` is one of :data:`IMPLS`, and every caller names it: serving
    takes ``pallas`` (kernel B4), training its ``RunConfig.attn_impl``
    (``chunked`` by default, as in the reference). Causal rows are offset
    by ``Sk - S``, as the reference offsets them. On a mesh the returned
    k and v hold the rank's kv heads.
    """
    if impl not in IMPLS:
        raise ValueError(f"attention impl {impl!r} is not one of {IMPLS}")
    b, s, _ = x.shape
    q, k, v = _project(p, cfg, x, positions, kv_x, rope=kv_x is None,
                       layout=layout)
    n_q = q.shape[2]
    ks, vs = _kv_for_heads(k, v, cfg, layout, n_q)
    qg = q.reshape(b, s, ks.shape[2], n_q // ks.shape[2], cfg.head_dim)
    row_offset = k.shape[1] - s if causal else 0
    if impl == "naive":
        o = naive_attention(qg, ks, vs, causal, row_offset)
    elif impl == "chunked":
        o = chunked_attention(qg, ks, vs, causal, row_offset)
    else:
        o = _pallas_attention(qg, ks, vs, causal)
    o = o.reshape(b, s, n_q * cfg.head_dim)
    return AttnOutput(out=_out(p, o, layout),
                      k=k if return_kv else None,
                      v=v if return_kv else None)


def decode_attention(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                     pos: int, cache_k: torch.Tensor, cache_v: torch.Tensor,
                     *, update_cache: bool = True, rope_on_q: bool = True,
                     mask_to_pos: bool = True, layout=None,
                     seq_axes: Sequence[str] = ()) -> AttnOutput:
    """One-token decode. x (B,1,D); cache_k/v (B,S,KH,hd); pos an int.

    Writes the new key and value at ``pos`` of ``cache_k``/``cache_v`` in
    place (``update_cache``) and attends keys ``<= pos``
    (``mask_to_pos``); the query and the new key are rotated at ``pos``
    (``rope_on_q``). Cross-attention turns all three off and reads the
    whole cached cross K/V. The casts are the reference's: the scaled
    query goes to the cache dtype before the score product and the
    probabilities before the value product, and both products accumulate
    in f32 (operands widened to f32, which holds bf16 products exactly).

    On a mesh the caches are the rank's blocks; ``seq_axes`` are the mesh
    axes their sequence dim is split over (``decoding.kv_spec``), along
    which the softmax is combined (module docstring).
    """
    b = x.shape[0]
    hd = cfg.head_dim
    posv = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project(p, cfg, x, posv, rope=rope_on_q,
                               layout=layout)
    n_q = q.shape[2]
    split = layout is not None and layout.span(seq_axes) > 1
    s_loc = cache_k.shape[1]
    lo = layout.index(seq_axes) * s_loc if split else 0
    if update_cache and lo <= pos < lo + s_loc:
        cache_k[:, pos - lo] = k_new[:, 0].to(cache_k.dtype)
        cache_v[:, pos - lo] = v_new[:, 0].to(cache_v.dtype)

    heads = layout.axes("heads") if split else ()
    gather_q = bool(heads) and set(heads) <= set(seq_axes)
    if gather_q:
        q = layout.all_gather(q, heads, 2)
        ks, vs = cache_k, cache_v
    else:
        ks, vs = _kv_for_heads(cache_k, cache_v, cfg, layout, n_q)
    kh = ks.shape[2]
    qg = q.reshape(b, 1, kh, q.shape[2] // kh, hd)
    scale = 1.0 / (hd ** 0.5)
    s = torch.einsum("bqkgd,bskd->bkgqs",
                     (qg * scale).to(ks.dtype).float(), ks.float())
    if mask_to_pos:
        keep = lo + torch.arange(s_loc, device=x.device) <= pos
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    if split:
        m = layout.all_reduce(s.amax(dim=-1, keepdim=True), seq_axes, "max")
        e = torch.exp(s - m)
        probs = e / layout.all_reduce(e.sum(dim=-1, keepdim=True), seq_axes)
    else:
        probs = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", probs.to(vs.dtype).float(),
                     vs.float())
    if split:
        o = layout.all_reduce(o, seq_axes)
    o = o.to(x.dtype).reshape(b, 1, -1, hd)
    if gather_q:
        first = layout.index(heads) * n_q
        o = o[:, :, first:first + n_q]
    return AttnOutput(out=_out(p, o.reshape(b, 1, n_q * hd), layout),
                      k=cache_k, v=cache_v)


__all__ = ["Attention", "init_attention", "attention", "decode_attention",
           "naive_attention", "chunked_attention", "AttnOutput", "IMPLS"]
