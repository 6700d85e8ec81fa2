"""Mamba2 (SSD) block: chunked parallel scan and the one-token decode step.

The port of ``repro/models/ssm.py``. State space per head (scalar-decay
SSD):
    h_t = a_t · h_{t-1} + dt_t · B_t ⊗ x_t          a_t = exp(A · dt_t) ∈ (0,1)
    y_t = C_t · h_t + D · x_t

:func:`ssd_chunked` splits T into chunks of Q: within a chunk the
quadratic form ``(C Bᵀ ⊙ L) (dt·x)`` with the decay mask
``L[i,j] = exp(cum[i] − cum[j])`` for i ≥ j and 0 above the diagonal
(the exponent set to −inf there with ``where`` before ``exp``: ``exp(diff)``
may be +inf above the diagonal, where a multiplied mask would give NaN,
and a mask applied after ``exp`` a NaN gradient); across chunks a loop
carries the (H, N, P) state.
As in the reference, the causal depthwise conv is applied to the x stream
only, with no bias, and B/C are shared across heads (one group, zamba2-2.7B's
configuration). The published Mamba2 convolves ``[x | B | C]`` with a bias
and applies SiLU to all three: a config with ``ssm_conv_xbc``
(granite-4.0-h-small) takes that form, its ``conv_w`` and ``conv_b`` and
its conv state ``d_in + 2·N`` wide. The reference computes all of it with
XLA ops outside any Pallas kernel, so the port computes it in plain torch.
While spans are recorded (``repro_torch.spans``), the chunked scan of a
full sequence is the span ``ssd`` and adds its tokens to the counter
``ssd.tokens``.

On a mesh (``layout``) the weights keep the reference's specs and
storage: ``in_proj`` ``("embed", "ff")``, ``conv_w`` ``(None, "ff")``,
``out_proj`` ``("ff", "embed")``; ``embed`` dims are gathered over data
just before use (ZeRO). ``in_proj``'s ``ff`` block is a contiguous
column block of ``[z | xs | B | C | dt]``, which does not line up with
those parts, so the mixer is **head-parallel** behind one all-gather:
each rank multiplies its column block (the input copied in,
``parallel.copy_to``) and the (B, T, P/n) products are all-gathered into
the whole projection (``parallel.gather_from``, whose backward
reduce-scatters: the shared B and C take every rank's part of their
gradient). The rank then runs its contiguous block of whole heads
(``H`` must divide over ``ff``'s axes): its block of ``z``, ``xs`` and
``dt``, the whole B and C. That block of ``xs`` is exactly the channels
of its ``conv_w`` block and of its block of the conv cache (spec
``(None, None, "batch", None, "ff")``), so the conv and its decode state
need no collective. ``_gated_out``'s norm over the whole ``d_in`` sums
the ranks' mean squares (:func:`common.rms_norm_split`), and ``out_proj``'s
row block takes the rank's channels row-parallel. A layer's collectives,
forward: one all-gather of the projection, one all-reduce of a (B, T, 1)
mean square, one of the (B, T, d) output; where the caller keeps the
state (serving), one all-gather of the (B, H/n, N, P) SSD state into the
cache, which holds it whole on every model rank. ``A_log``, ``D``,
``dt_bias`` and ``norm`` are replicated; a rank reads its heads' part,
and their gradients are all-reduced over ``ff``'s axes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from .. import spans
from ..configs.base import ModelConfig
from .common import (dense_init, head_block, linear, linear_rows,
                     replicated_part, rms_norm, rms_norm_split, weight)
from .parallel import copy_to, gather_from

CONV_K = 4


def ssm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    heads = d_in // cfg.ssm_head_dim
    return d_in, heads, cfg.ssm_state


def conv_width(cfg: ModelConfig) -> int:
    """The channels the causal conv (and its decode state) holds: d_in, or
    ``d_in + 2·N`` where it convolves ``[x | B | C]``."""
    d_in, _, n = ssm_dims(cfg)
    return d_in + 2 * n if cfg.ssm_conv_xbc else d_in


class Mamba(nn.Module):
    """Weights of one Mamba2 block: ``in_proj`` (d, 2·d_in + 2·N + H),
    ``conv_w`` (CONV_K, :func:`conv_width`) drawn at fan-in CONV_K (and
    its bias ``conv_b`` where the conv takes ``[x | B | C]``), ``A_log``,
    ``D``, ``dt_bias`` (H,) f32 whatever the dtype, ``norm`` (d_in,) and
    ``out_proj`` (d_in, d)."""

    def __init__(self, cfg: ModelConfig, generator, dtype, device):
        super().__init__()
        d = cfg.d_model
        d_in, h, n = ssm_dims(cfg)
        f32 = torch.float32
        self.in_proj = weight(dense_init((d, 2 * d_in + 2 * n + h), generator,
                                         dtype, device), ("embed", "ff"))
        self.conv_w = weight(dense_init((CONV_K, conv_width(cfg)), generator,
                                        dtype, device, in_axis_size=CONV_K),
                             (None, "ff"))
        if cfg.ssm_conv_xbc:
            self.conv_b = weight(dense_init((conv_width(cfg),), generator,
                                            dtype, device,
                                            in_axis_size=CONV_K), ("ff",))
        self.A_log = weight(torch.zeros(h, dtype=f32, device=device), (None,))
        self.D = weight(torch.ones(h, dtype=f32, device=device), (None,))
        self.dt_bias = weight(torch.zeros(h, dtype=f32, device=device),
                              (None,))
        self.norm = weight(torch.ones(d_in, dtype=dtype, device=device),
                           (None,))
        self.out_proj = weight(dense_init((d_in, d), generator, dtype,
                                          device), ("ff", "embed"))


def _split_proj(proj, d_in, h, n):
    z = proj[..., :d_in]
    xs = proj[..., d_in:2 * d_in]
    bv = proj[..., 2 * d_in:2 * d_in + n]
    cv = proj[..., 2 * d_in + n:2 * d_in + 2 * n]
    dt = proj[..., 2 * d_in + 2 * n:]
    return z, xs, bv, cv, dt


def _causal_conv(xs: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv, kernel CONV_K. xs (B,T,C); state (B,K-1,C).
    The new state is the last K-1 rows of ``state ++ xs`` (decode's
    ``t = 1 < K-1`` included)."""
    b, t, c = xs.shape
    if state is None:
        state = torch.zeros((b, CONV_K - 1, c), dtype=xs.dtype,
                            device=xs.device)
    xp = torch.cat([state, xs], dim=1)
    out = sum(xp[:, i:i + t, :] * w[i][None, None, :] for i in range(CONV_K))
    new_state = xp[:, t:, :] if t >= CONV_K - 1 else xp[:, -(CONV_K - 1):, :]
    return out, new_state


def _conv_silu(p: Mamba, cfg: ModelConfig, xs, bv, cv,
               state: Optional[torch.Tensor]):
    """(x, B, C, new conv state) after the causal conv and SiLU: of x
    alone (zamba2's form), or of ``[x | B | C]`` with ``conv_b`` where
    the config has ``ssm_conv_xbc`` (the published Mamba2)."""
    if not cfg.ssm_conv_xbc:
        xs, new_state = _causal_conv(xs, p.conv_w, state)
        return torch.nn.functional.silu(xs), bv, cv, new_state
    d_in, n = xs.shape[-1], bv.shape[-1]
    xbc, new_state = _causal_conv(torch.cat([xs, bv, cv], dim=-1), p.conv_w,
                                  state)
    xbc = torch.nn.functional.silu(xbc + p.conv_b)
    return (xbc[..., :d_in], xbc[..., d_in:d_in + n], xbc[..., d_in + n:],
            new_state)


def ssd_chunked(x, a_log, bv, cv, chunk: int = 64, init_state=None):
    """Chunked SSD. x (B,T,H,P); a_log (B,T,H) = A·dt (≤0);
    bv/cv (B,T,N). Returns y (B,T,H,P) f32, final state (B,H,N,P).
    T is padded with zeros to whole chunks."""
    b, t, h, p = x.shape
    n = bv.shape[-1]
    pad = (-t) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        a_log = torch.nn.functional.pad(a_log, (0, 0, 0, pad))
        bv = torch.nn.functional.pad(bv, (0, 0, 0, pad))
        cv = torch.nn.functional.pad(cv, (0, 0, 0, pad))
    tt = t + pad
    nc = tt // chunk
    xq = x.reshape(b, nc, chunk, h, p).float()
    aq = a_log.reshape(b, nc, chunk, h).float()
    bq = bv.reshape(b, nc, chunk, n).float()
    cq = cv.reshape(b, nc, chunk, n).float()

    cum = torch.cumsum(aq, dim=2)                     # (B,nc,Q,H) inclusive
    # Intra-chunk: scores[i,j] = (C_i·B_j)·exp(cum_i − cum_j), i ≥ j.
    cb = torch.einsum("bcin,bcjn->bcij", cq, bq)      # (B,nc,Q,Q)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Q,Q,H)
    iq = torch.arange(chunk, device=x.device)
    causal = (iq[:, None] >= iq[None, :])[None, None, :, :, None]
    # Masked before the exponent: where exp(diff) overflowed above the
    # diagonal, a mask after it would pass a 0·inf = NaN gradient back.
    l_mask = torch.exp(torch.where(causal, diff,
                                   torch.full_like(diff, -float("inf"))))
    scores = cb[..., None] * l_mask                   # (B,nc,Q,Q,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, xq)

    # Chunk summary states and the inter-chunk loop.
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B,nc,Q,H)
    s_chunk = torch.einsum("bcjn,bcjh,bcjhp->bchnp", bq, decay_to_end, xq)
    total_decay = torch.exp(cum[:, :, -1, :])         # (B,nc,H)
    s = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * total_decay[:, c, :, None, None] + s_chunk[:, c]
    s_prevs = torch.stack(s_prevs, dim=1)             # (B,nc,H,N,P)
    y_inter = torch.einsum("bcin,bcih,bchnp->bcihp", cq, torch.exp(cum),
                           s_prevs)
    y = (y_intra + y_inter).reshape(b, tt, h, p)[:, :t]
    return y, s


def ssd_step(state, x_t, a_t, b_t, c_t):
    """One decode step. state (B,H,N,P); x_t (B,H,P); a_t (B,H);
    b_t/c_t (B,N)."""
    state = state * a_t[..., None, None] + torch.einsum(
        "bn,bhp->bhnp", b_t, x_t)
    y = torch.einsum("bn,bhnp->bhp", c_t, state)
    return state, y


class MambaCache(NamedTuple):
    conv: torch.Tensor   # (B, K-1, d_in)
    ssm: torch.Tensor    # (B, H, N, P)


def init_mamba_cache(cfg: ModelConfig, batch: int,
                     dtype: torch.dtype = torch.float32,
                     device=None) -> MambaCache:
    d_in, h, n = ssm_dims(cfg)
    return MambaCache(
        conv=torch.zeros((batch, CONV_K - 1, conv_width(cfg)), dtype=dtype,
                         device=device),
        ssm=torch.zeros((batch, h, n, cfg.ssm_head_dim), dtype=torch.float32,
                        device=device))


class _Split(NamedTuple):
    """A rank's share of a Mamba2 layer on a mesh: the model axes the
    heads are split over, its first head and head count."""
    axes: tuple
    first: int
    heads: int


def _split(cfg: ModelConfig, layout) -> Optional[_Split]:
    if layout is None:
        return None
    if cfg.ssm_conv_xbc:
        raise NotImplementedError("the [x | B | C] conv is not split over "
                                  "a mesh")
    axes = layout.axes("ff")
    first, count = head_block(layout, axes, ssm_dims(cfg)[1], "Mamba2")
    return _Split(axes, first, count)


def _gated_out(p: Mamba, cfg: ModelConfig, y: torch.Tensor, z: torch.Tensor,
               dtype: torch.dtype, layout=None, sp=None) -> torch.Tensor:
    y = y.to(dtype) * torch.nn.functional.silu(z)
    if layout is None:
        return linear(rms_norm(y, p.norm, cfg.norm_eps), p.out_proj)
    hp = cfg.ssm_head_dim
    ch = slice(sp.first * hp, (sp.first + sp.heads) * hp)
    norm = replicated_part(p.norm, layout, sp.axes, ch)
    y = rms_norm_split(y, norm, cfg.norm_eps, layout, sp.axes,
                       ssm_dims(cfg)[0])
    w = layout.whole(p.out_proj, 1)
    return linear_rows(y, w, layout, sp.axes) if sp.axes else linear(y, w)


def _mixer_inputs(p: Mamba, cfg: ModelConfig, x: torch.Tensor, layout,
                  sp: Optional[_Split]):
    """(z, xs, B, C, dt) of x (B,T,d) and the per-head ``A_log``, ``D``,
    ``dt_bias``: the rank's heads of each on a mesh (module docstring)."""
    d_in, h, n = ssm_dims(cfg)
    if layout is None:
        return (_split_proj(linear(x, p.in_proj), d_in, h, n), p.A_log, p.D,
                p.dt_bias)
    if sp.axes:
        x = copy_to(x, layout, sp.axes)
    proj = linear(x, layout.whole(p.in_proj, 0))
    if sp.axes:
        proj = gather_from(proj, layout, sp.axes, proj.dim() - 1)
    z, xs, bv, cv, dt = _split_proj(proj, d_in, h, n)
    hs = slice(sp.first, sp.first + sp.heads)
    ch = slice(sp.first * cfg.ssm_head_dim,
               (sp.first + sp.heads) * cfg.ssm_head_dim)
    per_head = (replicated_part(w, layout, sp.axes, hs)
                for w in (p.A_log, p.D, p.dt_bias))
    return (z[..., ch], xs[..., ch], bv, cv, dt[..., hs]), *per_head


def _whole_state(s: torch.Tensor, layout, sp: Optional[_Split],
                 keep: bool) -> Optional[torch.Tensor]:
    """The (B, H, N, P) state from the rank's heads: gathered over the
    heads' axes on a mesh, None where it is not kept."""
    if not keep:
        return None
    if sp is not None and sp.axes:
        return layout.all_gather(s, sp.axes, 1)
    return s


def _heads_of(state: torch.Tensor, sp: Optional[_Split]) -> torch.Tensor:
    """The rank's heads (dim 1) of a whole (B, H, N, P) state."""
    return state if sp is None else state[:, sp.first:sp.first + sp.heads]


def mamba_block(p: Mamba, cfg: ModelConfig, x: torch.Tensor,
                cache: Optional[MambaCache] = None, chunk: int = 64,
                layout=None, keep_state: bool = True):
    """Full-sequence Mamba2 block. x (B,T,d) → (B,T,d), new cache. On a
    mesh (module docstring) the conv state is the rank's channel block and
    the SSD state whole, as the cache holds them; ``keep_state`` False
    (training) returns no SSD state."""
    b, t, _ = x.shape
    sp = _split(cfg, layout)
    hp = cfg.ssm_head_dim
    (z, xs, bv, cv, dt), a_log_w, d_w, dt_bias = _mixer_inputs(
        p, cfg, x, layout, sp)
    xs, bv, cv, new_conv = _conv_silu(
        p, cfg, xs, bv, cv, cache.conv if cache is not None else None)
    dt = torch.nn.functional.softplus(dt.float() + dt_bias)
    a_log = -torch.exp(a_log_w) * dt                 # (B,T,H) ≤ 0
    h = dt.shape[-1]
    xh = xs.reshape(b, t, h, hp)
    with spans.span("ssd"):
        spans.count("ssd.tokens", b * t)
        y, s_final = ssd_chunked(xh.float() * dt[..., None], a_log, bv, cv,
                                 chunk=chunk,
                                 init_state=_heads_of(cache.ssm, sp)
                                 if cache is not None else None)
    y = y + d_w[None, None, :, None] * xh.float()
    out = _gated_out(p, cfg, y.reshape(b, t, h * hp), z, x.dtype, layout, sp)
    return out, MambaCache(conv=new_conv,
                           ssm=_whole_state(s_final, layout, sp, keep_state))


def mamba_step(p: Mamba, cfg: ModelConfig, x: torch.Tensor,
               cache: MambaCache, layout=None):
    """One-token decode. x (B,1,d); on a mesh as :func:`mamba_block`."""
    b = x.shape[0]
    sp = _split(cfg, layout)
    hp = cfg.ssm_head_dim
    (z, xs, bv, cv, dt), a_log_w, d_w, dt_bias = _mixer_inputs(
        p, cfg, x, layout, sp)
    xs, bv, cv, new_conv = _conv_silu(p, cfg, xs, bv, cv, cache.conv)
    dt = torch.nn.functional.softplus(dt.float() + dt_bias)[:, 0]
    a = torch.exp(-torch.exp(a_log_w) * dt)          # (B,H)
    h = dt.shape[-1]
    xh = xs.reshape(b, h, hp).float()
    state, y = ssd_step(_heads_of(cache.ssm, sp), xh * dt[..., None], a,
                        bv[:, 0].float(), cv[:, 0].float())
    y = y + d_w[None, :, None] * xh
    out = _gated_out(p, cfg, y.reshape(b, 1, h * hp), z, x.dtype, layout, sp)
    return out, MambaCache(conv=new_conv,
                           ssm=_whole_state(state, layout, sp, True))


__all__ = ["Mamba", "mamba_block", "mamba_step", "MambaCache",
           "init_mamba_cache", "ssd_chunked", "ssd_step", "ssm_dims",
           "conv_width", "CONV_K"]
