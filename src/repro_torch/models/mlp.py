"""MLP blocks: SwiGLU dense and mixture-of-experts.

The port of ``repro/models/mlp.py``: ``init_mlp`` and ``mlp``, and the MoE
layer with the reference's two dispatch implementations, which compute the
same function:

* ``impl='einsum'``: one-hot dispatch and combine masks of shape
  ``(T, E, C)`` contracted with einsums;
* ``impl='sort'``: assignments sorted by expert (a stable sort), tokens
  scattered into ``(E, C, d)`` expert batches and the results scatter-added
  back to their tokens.

Both route each token to its top-k experts by f32 router logits (ties go to
the lower expert index, as ``jax.lax.top_k`` breaks them), weight them by a
softmax over those k logits, and give every expert ``C`` slots
(:func:`_capacity`). An assignment past its expert's capacity is dropped:
its token gets nothing from that expert, and the gates of the experts it
kept are **not** renormalised (the reference's docstring says they are; its
code, which the port follows, does not). The expert products are batched
matrix products (``torch.matmul`` over the expert axis), as the reference
computes them with einsum outside any Pallas kernel.

``impl='ep_local'`` (expert parallelism over a mesh) waits for ROADMAP
A18d; without a mesh the reference runs ``moe_sort`` in its place, and so
does the port.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from .common import dense_init, linear, weight

MOE_IMPLS = ("sort", "einsum", "ep_local")


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


class MoE(nn.Module):
    """Weights of one MoE block: ``router`` (d, E), always f32, and the
    experts' SwiGLU ``wi``, ``wg`` (E, d, ff) and ``wo`` (E, ff, d). Each is
    drawn with fan-in ``shape[0]``, as the reference draws them."""

    def __init__(self, cfg: ModelConfig, generator, dtype, device):
        super().__init__()
        d, e = cfg.d_model, cfg.num_experts
        f = cfg.moe_d_ff or cfg.d_ff
        self.router = weight(dense_init((d, e), generator, torch.float32,
                                        device))
        self.wi = weight(dense_init((e, d, f), generator, dtype, device))
        self.wg = weight(dense_init((e, d, f), generator, dtype, device))
        self.wo = weight(dense_init((e, f, d), generator, dtype, device))


def init_moe(cfg: ModelConfig, generator, dtype, device) -> MoE:
    return MoE(cfg, generator, dtype, device)


def _router(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """Top-k routing. x (T, d) → gates (T, k) f32, experts (T, k) int64.

    The k largest f32 logits in descending order, equal logits in
    ascending expert order (a stable descending sort), as ``jax.lax.top_k``
    orders them; ``torch.topk`` leaves the order of ties unspecified.
    """
    logits = linear(x.float(), p.router)                  # (T, E)
    k = cfg.experts_per_tok
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    gates = torch.softmax(vals[:, :k], dim=-1)
    return gates, idx[:, :k]


def _capacity(t: int, cfg: ModelConfig, factor: float) -> int:
    """Slots per expert for ``t`` tokens: ``t·k·factor/E + 1`` clamped to
    ``[4, t]``, rounded up to a multiple of 32 (the reference's Python
    arithmetic, so the same ``t`` gives the same capacity)."""
    c = int(t * cfg.experts_per_tok * factor / cfg.num_experts) + 1
    c = max(4, min(t, c))
    return ((c + 31) // 32) * 32


def _experts_ffn(p: MoE, xin: torch.Tensor) -> torch.Tensor:
    """xin (E, C, d) → (E, C, d), every expert's SwiGLU on its batch
    (:func:`linear` on 3-D operands is a batched product)."""
    h = torch.nn.functional.silu(linear(xin, p.wg)) * linear(xin, p.wi)
    return linear(h, p.wo)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of ``idx`` over ``n`` classes; an index outside
    ``[0, n)`` gives a zero row, as ``jax.nn.one_hot`` does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def moe_einsum(p: MoE, x: torch.Tensor, cfg: ModelConfig,
               capacity_factor: float = 1.25) -> torch.Tensor:
    """One-hot dispatch/combine MoE. x (T, d) → (T, d)."""
    t, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_tok
    c = _capacity(t, cfg, capacity_factor)
    gates, idx = _router(p, x, cfg)                       # (T, k)

    onehot = _one_hot(idx, e)                             # (T, k, E)
    # Position of each (token, expert) assignment in its expert's queue.
    pos = torch.cumsum(onehot.reshape(t * k, e), dim=0).reshape(t, k, e) \
        - 1.0
    kept = onehot * ((pos < c) & (onehot > 0))
    pos_oh = _one_hot(pos.to(torch.int32), c)             # (T, k, E, C)
    dispatch = torch.einsum("tke,tkec->tec", kept, pos_oh)
    combine = torch.einsum("tk,tke,tkec->tec", gates, kept, pos_oh)
    xin = torch.einsum("tec,td->ecd", dispatch.to(x.dtype).float(),
                       x.float()).to(x.dtype)
    out = _experts_ffn(p, xin)
    return torch.einsum("tec,ecd->td", combine, out.float()).to(out.dtype)


def moe_sort(p: MoE, x: torch.Tensor, cfg: ModelConfig,
             capacity_factor: float = 1.25) -> torch.Tensor:
    """Gather/scatter dispatch MoE (no one-hot products). x (T, d)."""
    t, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_tok
    c = _capacity(t, cfg, capacity_factor)
    gates, idx = _router(p, x, cfg)                       # (T, k)

    flat_e = idx.reshape(-1)                              # (T·k,)
    flat_g = gates.reshape(-1)
    flat_tok = torch.arange(t, device=x.device).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    tok_sorted = flat_tok[order]
    g_sorted = flat_g[order]
    # Rank within expert: global position − start offset of that expert.
    counts = torch.bincount(e_sorted, minlength=e)
    starts = torch.cumsum(counts, dim=0) - counts
    rank = torch.arange(t * k, device=x.device) - starts[e_sorted]
    valid = rank < c
    slot = torch.where(valid, rank, 0)

    # Tokens into expert batches. A dropped assignment adds a zero row to
    # slot 0 of its expert, so the scatter must accumulate: an assignment
    # would overwrite the kept token that owns the slot.
    xin = torch.zeros((e, c, d), dtype=x.dtype, device=x.device)
    xin = xin.index_put((e_sorted, slot),
                        torch.where(valid[:, None], x[tok_sorted],
                                    torch.zeros((), dtype=x.dtype,
                                                device=x.device)),
                        accumulate=True)
    out = _experts_ffn(p, xin)                            # (E, C, d)

    # Combine: each kept assignment's result, times its gate, added to
    # its token; a dropped one's gate is 0.
    vals = out[e_sorted, slot] * (g_sorted * valid)[:, None].to(out.dtype)
    return torch.zeros((t, d), dtype=out.dtype,
                       device=x.device).index_add(0, tok_sorted, vals)


def moe(p: MoE, x: torch.Tensor, cfg: ModelConfig, *, impl: str = "sort",
        capacity_factor: float = 1.25,
        token_chunk: int = 65_536) -> torch.Tensor:
    """x (B, S, d) → (B, S, d); ``impl`` one of :data:`MOE_IMPLS`.

    The B·S tokens route together (capacity counts them all). More than
    ``token_chunk`` tokens go through the layer a chunk at a time, the last
    padded with zero rows and the padding cut from the result, so the
    dispatch buffers scale with the chunk; under grad each chunk is
    checkpointed (recomputed in the backward), as the reference wraps its
    chunk scan in ``jax.checkpoint``.
    """
    if impl not in MOE_IMPLS:
        raise ValueError(f"moe impl {impl!r} is not one of {MOE_IMPLS}")
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    t = xt.shape[0]
    fn = moe_einsum if impl == "einsum" else moe_sort
    if t <= token_chunk:
        y = fn(p, xt, cfg, capacity_factor)
    else:
        pad = (-t) % token_chunk
        if pad:
            xt = torch.nn.functional.pad(xt, (0, 0, 0, pad))
        ys = []
        for xi in xt.split(token_chunk):
            if torch.is_grad_enabled():
                ys.append(checkpoint(fn, p, xi, cfg, capacity_factor,
                                     use_reentrant=False))
            else:
                ys.append(fn(p, xi, cfg, capacity_factor))
        y = torch.cat(ys)[:t]
    return y.reshape(b, s, d).to(x.dtype)


__all__ = ["MLP", "init_mlp", "mlp", "MoE", "init_moe", "moe", "moe_einsum",
           "moe_sort", "MOE_IMPLS"]
