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
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from .common import dense_init, rms_norm, weight


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


def _projections(p: RWKVTimeMix, x: torch.Tensor, x_prev: torch.Tensor):
    """Shared front-end of the time mix: projections and decay."""
    shifted, carry = _token_shift(x, x_prev)
    mu = p.mix.to(x.dtype)
    xr = _mix(x, shifted, mu[0])
    xk = _mix(x, shifted, mu[1])
    xv = _mix(x, shifted, mu[2])
    xg = _mix(x, shifted, mu[3])
    xw = _mix(x, shifted, mu[4])
    r = xr @ p.wr
    k = xk @ p.wk
    v = xv @ p.wv
    g = torch.nn.functional.silu(xg @ p.wg)
    lora = torch.tanh(xw.float() @ p.w_a) @ p.w_b
    logw = -torch.exp(torch.clamp(p.w0 + lora, -8.0, 1.0))  # log w ∈ [-e, 0)
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


def rwkv_time_mix(p: RWKVTimeMix, cfg: ModelConfig, x: torch.Tensor,
                  x_prev: torch.Tensor, state: torch.Tensor,
                  impl: str = "chunked"):
    """x (B,T,d) → (B,T,d), carry, state. ``impl`` ``chunked`` or
    ``scan``; like the reference, any other value runs the scan."""
    b, t, d = x.shape
    h, n = rwkv_dims(cfg)
    r, k, v, g, logw, carry = _projections(p, x, x_prev)
    fn = rwkv_chunked if impl == "chunked" else rwkv_scan
    o, s_final = fn(r.reshape(b, t, h, n), k.reshape(b, t, h, n),
                    v.reshape(b, t, h, n), logw.reshape(b, t, h, n),
                    p.u.reshape(h, n), state)
    o = o.reshape(b, t, d).to(x.dtype)
    o = rms_norm(o, p.ln_x, cfg.norm_eps) * g
    return o @ p.wo, carry, s_final


def rwkv_channel_mix(p: RWKVChannelMix, cfg: ModelConfig, x: torch.Tensor,
                     x_prev: torch.Tensor):
    shifted, carry = _token_shift(x, x_prev)
    mu = p.mix.to(x.dtype)
    xk = _mix(x, shifted, mu[0])
    xr = _mix(x, shifted, mu[1])
    kk = torch.square(torch.relu(xk @ p.wk))
    out = torch.sigmoid(xr @ p.wr) * (kk @ p.wv)
    return out, carry


__all__ = ["RWKVTimeMix", "RWKVChannelMix", "rwkv_time_mix",
           "rwkv_channel_mix", "rwkv_scan", "rwkv_chunked", "RWKVCache",
           "init_rwkv_cache", "rwkv_dims", "RWKV_IMPLS"]
