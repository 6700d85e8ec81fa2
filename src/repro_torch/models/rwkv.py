"""RWKV6 ("Finch") block: data-dependent per-channel decay, attention-free.

The port of ``repro/models/rwkv.py``. Recurrence per head (state
S ∈ R^{N×N}, k-dim × v-dim):
    o_t = r_t · (S_{t-1} + diag(u) k_t ⊗ v_t)
    S_t = diag(w_t) · S_{t-1} + k_t ⊗ v_t
with the data-dependent decay ``w_t = exp(−exp(w0 + lora(x̄_t)))`` per
channel.

Two evaluators of the same function, as in the reference:
* :func:`rwkv_scan`: the exact recurrence, one step a token (decode, and
  prefill where ``RunConfig.rwkv_impl == "scan"``, which the serving
  launcher sets);
* :func:`rwkv_chunked`: chunk-parallel, the intra-chunk part through
  factored decays in log space re-centred per chunk (``chunk <= 32``, else
  the ``exp(−cum)`` factor overflows f32), the inter-chunk part through a
  loop over chunks.

The reference computes both with XLA ops outside any Pallas kernel, so
the port computes them in plain torch (einsums and a Python loop).
Token shift uses one static learned mix vector per stream, as the
reference does.

On a mesh (``layout``) the weights keep the reference's specs: ``wr``,
``wk``, ``wv``, ``wg`` ``("embed", "ff")``, ``wo`` ``("ff", "embed")``,
the channel mix's ``wk``/``wv`` a column/row pair and its ``wr``
``("embed", None)``; every ``embed`` dim is gathered over data just before
use (ZeRO). The time mix is **head-parallel**: a rank's column block of
``wr``/``wk``/``wv``/``wg`` is a contiguous block of whole heads (``H``
must divide over ``ff``'s axes), so the recurrence runs on the rank's
heads alone, with no collective inside it, and ``wo``'s row block takes
its output row-parallel. Gathering the projections instead would move
four (B, T, d) activations a layer and run every head on every rank. Its
collectives a layer, forward: one all-reduce of a (B, T, 1) mean square
(``ln_x`` normalises over the whole d: :func:`common.rms_norm_split`),
one of the (B, T, d) output; where the caller keeps the state (serving),
one all-gather of the (B, H/n, N, N) WKV state into the cache, whose spec
holds it whole on every model rank (training keeps none). The token-shift
carries are the block's input, whole on every rank. Backward, the inputs
of the split products (``xr``, ``xk``, ``xv``, ``xg``, the LoRA's
activation) and the replicated vectors a rank uses a part of (``w0``,
``u``, ``ln_x``, ``w_b``) have their gradients all-reduced over ``ff``'s
axes (``parallel.copy_to``), so each arrives whole. The channel mix is a
SwiGLU-like pair: ``xk`` copied in, the value product row-parallel, one
all-reduce; ``wr`` runs whole on every rank.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from .common import (dense_init, head_block, linear_rows, replicated_part,
                     rms_norm, rms_norm_split, weight)
from .parallel import copy_to


def rwkv_dims(cfg: ModelConfig):
    n = cfg.rwkv_head_dim
    h = cfg.d_model // n
    return h, n


class RWKVTimeMix(nn.Module):
    """Weights of the time mix: ``mix`` (5, d), ``wr``/``wk``/``wv``/
    ``wg``/``wo`` (d, d), the decay's ``w0`` (d,), LoRA ``w_a`` (d, lora)
    and ``w_b`` (lora, d), the bonus ``u`` (d,) (those four f32 whatever
    the dtype) and the output norm ``ln_x`` (d,)."""

    def __init__(self, cfg: ModelConfig, generator, dtype, device):
        super().__init__()
        d, lora = cfg.d_model, cfg.rwkv_decay_lora
        f32 = torch.float32
        self.mix = weight(torch.full((5, d), 0.5, dtype=dtype, device=device),
                          (None, None))
        self.wr = weight(dense_init((d, d), generator, dtype, device),
                         ("embed", "ff"))
        self.wk = weight(dense_init((d, d), generator, dtype, device),
                         ("embed", "ff"))
        self.wv = weight(dense_init((d, d), generator, dtype, device),
                         ("embed", "ff"))
        self.wg = weight(dense_init((d, d), generator, dtype, device),
                         ("embed", "ff"))
        self.w0 = weight(torch.full((d,), -2.0, dtype=f32, device=device),
                         (None,))
        self.w_a = weight(dense_init((d, lora), generator, f32, device),
                          ("embed", None))
        self.w_b = weight(dense_init((lora, d), generator, f32, device),
                          (None, None))
        self.u = weight(torch.zeros(d, dtype=f32, device=device), (None,))
        self.wo = weight(dense_init((d, d), generator, dtype, device),
                         ("ff", "embed"))
        self.ln_x = weight(torch.ones(d, dtype=dtype, device=device), (None,))


class RWKVChannelMix(nn.Module):
    """Weights of the channel mix: ``mix`` (2, d), ``wk`` (d, ff), ``wv``
    (ff, d), ``wr`` (d, d)."""

    def __init__(self, cfg: ModelConfig, generator, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.mix = weight(torch.full((2, d), 0.5, dtype=dtype, device=device),
                          (None, None))
        self.wk = weight(dense_init((d, f), generator, dtype, device),
                         ("embed", "ff"))
        self.wv = weight(dense_init((f, d), generator, dtype, device),
                         ("ff", "embed"))
        self.wr = weight(dense_init((d, d), generator, dtype, device),
                         ("embed", None))


def _token_shift(x: torch.Tensor, x_prev: torch.Tensor):
    """x (B,T,d); x_prev (B,1,d) carry. Returns shifted (B,T,d), new carry."""
    shifted = torch.cat([x_prev, x[:, :-1]], dim=1)
    return shifted, x[:, -1:]


def _mix(x, shifted, mu):
    return x * mu + shifted * (1.0 - mu)


class RWKVCache(NamedTuple):
    tm_prev: torch.Tensor   # (B, 1, d) token-shift carry (time mix)
    cm_prev: torch.Tensor   # (B, 1, d) token-shift carry (channel mix)
    state: torch.Tensor     # (B, H, N, N) wkv state (f32)


def init_rwkv_cache(cfg: ModelConfig, batch: int,
                    dtype: torch.dtype = torch.float32,
                    device=None) -> RWKVCache:
    h, n = rwkv_dims(cfg)
    return RWKVCache(
        tm_prev=torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                            device=device),
        cm_prev=torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                            device=device),
        state=torch.zeros((batch, h, n, n), dtype=torch.float32,
                          device=device))


def _projections(p: RWKVTimeMix, x: torch.Tensor, x_prev: torch.Tensor,
                 layout=None, axes=(), ch=slice(None)):
    """Shared front-end of the time mix: projections and decay. On a mesh
    r, k, v, g and log w are the rank's channels ``ch`` (module
    docstring)."""
    shifted, carry = _token_shift(x, x_prev)
    mu = p.mix.to(x.dtype)
    xr = _mix(x, shifted, mu[0])
    xk = _mix(x, shifted, mu[1])
    xv = _mix(x, shifted, mu[2])
    xg = _mix(x, shifted, mu[3])
    xw = _mix(x, shifted, mu[4])
    wr, wk, wv, wg, w_a = p.wr, p.wk, p.wv, p.wg, p.w_a
    w_b, w0 = p.w_b, p.w0
    if layout is not None:
        wr, wk, wv, wg, w_a = (layout.whole(w, 0)
                               for w in (wr, wk, wv, wg, w_a))
        if axes:
            xr, xk, xv, xg = (copy_to(t, layout, axes)
                              for t in (xr, xk, xv, xg))
        w_b = replicated_part(w_b, layout, axes, (slice(None), ch))
        w0 = replicated_part(w0, layout, axes, ch)
    r = xr @ wr
    k = xk @ wk
    v = xv @ wv
    g = torch.nn.functional.silu(xg @ wg)
    a = torch.tanh(xw.float() @ w_a)
    if layout is not None and axes:
        a = copy_to(a, layout, axes)
    lora = a @ w_b
    logw = -torch.exp(torch.clamp(w0 + lora, -8.0, 1.0))  # log w ∈ [-e, 0)
    return r, k, v, g, logw, carry


def rwkv_scan(r, k, v, logw, u, state):
    """Exact recurrence. r/k/v (B,T,H,N); logw (B,T,H,N); u (H,N);
    state (B,H,N,N). Returns o (B,T,H,N) f32, final state."""
    w = torch.exp(logw.float())
    r, k, v = r.float(), k.float(), v.float()
    s = state.float()
    uk = u[None, :, :, None]
    outs = []
    for t in range(r.shape[1]):     # one step a token: a few kernels each
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]         # (B,H,N,N)
        outs.append(torch.matmul(r[:, t, :, None, :], s + uk * kv)[:, :, 0])
        s = w[:, t, ..., None] * s + kv
    return torch.stack(outs, dim=1), s


def rwkv_chunked(r, k, v, logw, u, state, chunk: int = 16):
    """Chunk-parallel evaluation, the function of :func:`rwkv_scan`.

    Factored decays: the contribution of j to the output at i (j < i) is
    ``exp(cum[i-1] − cum[j])`` per channel, cum the inclusive cumsum of
    log w, computed as r̃_i = r_i·exp(cum[i-1]−c₀) and
    k̃_j = k_j·exp(c₀−cum[j]) with c₀ = cum[0] per chunk. With log w
    clamped to ≥ −e the largest exponent is chunk·e, so chunk ≤ 32 stays
    inside f32 (16, the default, leaves 2× headroom); larger chunks are
    refused. T is padded to whole chunks with log w = 0 (no decay).
    """
    if chunk > 32:
        raise ValueError("rwkv_chunked: decay factorization overflows f32 "
                         "beyond chunk=32")
    b, t, h, n = r.shape
    pad = (-t) % chunk
    if pad:
        def z(a):
            return torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
        r, k, v, logw = z(r), z(k), z(v), z(logw)
    tt = t + pad
    nc = tt // chunk
    rq = r.reshape(b, nc, chunk, h, n).float()
    kq = k.reshape(b, nc, chunk, h, n).float()
    vq = v.reshape(b, nc, chunk, h, n).float()
    lw = logw.reshape(b, nc, chunk, h, n).float()
    cum = torch.cumsum(lw, dim=2)                      # inclusive
    center = cum[:, :, :1]                             # c₀ per chunk
    # r̃_i carries decay from chunk start up to i-1 (exclusive of w_i).
    cum_excl = cum - lw                                # exclusive prefix
    r_dec = rq * torch.exp(cum_excl - center)
    k_dec = kq * torch.exp(center - cum)
    scores = torch.einsum("bcihn,bcjhn->bchij", r_dec, k_dec)  # j<i strictly
    iq = torch.arange(chunk, device=r.device)
    strict = (iq[:, None] > iq[None, :])[None, None, None]
    scores = torch.where(strict, scores, torch.zeros_like(scores))
    # Diagonal u-bonus.
    diag = torch.einsum("bcihn,hn,bcihn->bcih", rq, u, kq)
    y_intra = torch.einsum("bchij,bcjhn->bcihn", scores, vq)
    y_intra = y_intra + diag[..., None] * vq

    # Inter-chunk: o_i += (r_i ⊙ exp(cum_excl_i)) S_prev; chunk state update.
    decay_to_end = torch.exp(cum[:, :, -1:] - cum)     # Σ_{m>j} log w (≤0)
    s_chunk = torch.einsum("bcjhk,bcjhv->bchkv", kq * decay_to_end, vq)
    total = torch.exp(cum[:, :, -1])                   # (B,nc,H,N)
    s = state.float()
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = total[:, c, ..., None] * s + s_chunk[:, c]
    s_prevs = torch.stack(s_prevs, dim=1)              # (B,nc,H,N,N)
    y_inter = torch.einsum("bcihk,bchkv->bcihv", rq * torch.exp(cum_excl),
                           s_prevs)
    y = (y_intra + y_inter).reshape(b, tt, h, n)[:, :t]
    return y, s


RWKV_IMPLS = ("chunked", "scan")


def _rows(x: torch.Tensor, w: torch.Tensor, layout, axes) -> torch.Tensor:
    """``x @ w`` with ``w`` the rank's rows over ``axes``: row-parallel,
    the partial products all-reduced (``common.linear_rows``)."""
    return linear_rows(x, w, layout, axes) if axes else x @ w


def rwkv_time_mix(p: RWKVTimeMix, cfg: ModelConfig, x: torch.Tensor,
                  x_prev: torch.Tensor, state: torch.Tensor,
                  impl: str = "chunked", layout=None,
                  keep_state: bool = True):
    """x (B,T,d) → (B,T,d), carry, state. ``impl`` ``chunked`` or
    ``scan``; like the reference, any other value runs the scan.

    On a mesh ``state`` is the whole (B, H, N, N) state (the cache's
    block); the rank runs its heads and the returned state is gathered
    whole again, or None where ``keep_state`` is False (training)."""
    b, t, d = x.shape
    h, n = rwkv_dims(cfg)
    axes = layout.axes("ff") if layout is not None else ()
    first, hl = head_block(layout, axes, h, "the RWKV time mix")
    ch = slice(first * n, (first + hl) * n)
    r, k, v, g, logw, carry = _projections(p, x, x_prev, layout, axes, ch)
    u = p.u if layout is None else replicated_part(p.u, layout, axes, ch)
    fn = rwkv_chunked if impl == "chunked" else rwkv_scan
    o, s_final = fn(r.reshape(b, t, hl, n), k.reshape(b, t, hl, n),
                    v.reshape(b, t, hl, n), logw.reshape(b, t, hl, n),
                    u.reshape(hl, n), state[:, first:first + hl])
    o = o.reshape(b, t, hl * n).to(x.dtype)
    if layout is None:
        o = rms_norm(o, p.ln_x, cfg.norm_eps) * g
        return o @ p.wo, carry, s_final
    ln_x = replicated_part(p.ln_x, layout, axes, ch)
    o = rms_norm_split(o, ln_x, cfg.norm_eps, layout, axes, d) * g
    out = _rows(o, layout.whole(p.wo, 1), layout, axes)
    if not keep_state:
        s_final = None
    elif axes:
        s_final = layout.all_gather(s_final, axes, 1)
    return out, carry, s_final


def rwkv_channel_mix(p: RWKVChannelMix, cfg: ModelConfig, x: torch.Tensor,
                     x_prev: torch.Tensor, layout=None):
    shifted, carry = _token_shift(x, x_prev)
    mu = p.mix.to(x.dtype)
    xk = _mix(x, shifted, mu[0])
    xr = _mix(x, shifted, mu[1])
    if layout is None:
        kk = torch.square(torch.relu(xk @ p.wk))
        return torch.sigmoid(xr @ p.wr) * (kk @ p.wv), carry
    axes = layout.axes("ff")
    if axes:
        xk = copy_to(xk, layout, axes)
    kk = torch.square(torch.relu(xk @ layout.whole(p.wk, 0)))
    kv = _rows(kk, layout.whole(p.wv, 1), layout, axes)
    return torch.sigmoid(xr @ layout.whole(p.wr, 0)) * kv, carry


__all__ = ["RWKVTimeMix", "RWKVChannelMix", "rwkv_time_mix",
           "rwkv_channel_mix", "rwkv_scan", "rwkv_chunked", "RWKVCache",
           "init_rwkv_cache", "rwkv_dims", "RWKV_IMPLS"]
