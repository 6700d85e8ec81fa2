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

On the meta device (the dry run) the dispatch runs as it is, for its
shapes and the collectives around it, with two changes that leave both
alone: ``torch.bincount``, which has no meta kernel, gives an empty tensor
of its shape (:func:`_expert_counts`: a meta tensor holds no values to
count), and the tokens go through in one chunk (the chunks bound memory,
which meta tensors do not take, and issue no collective of their own).

``impl='ep_local'`` is :func:`moe_ep_local`, expert parallelism over a
mesh with a dispatch local to each data shard and its own capacity
(``max(4, int(T_loc·k·cf/E) + 1)``, not :func:`_capacity`); without a
mesh, or where the plan gives the experts no mesh axis, the reference runs
``moe_sort`` in its place, and so does the port.

On a mesh (``layout``) the dense SwiGLU is tensor-parallel (``wi``, ``wg``
column-parallel on the rank's ``ff`` slice, ``wo`` row-parallel, one
all-reduce), and ``sort`` and ``einsum`` compute the unsharded function,
as GSPMD does: every rank routes every token of the batch (gathered over
the data axes) exactly as one device would, with :func:`_capacity` of the
whole batch, runs its own experts (``experts`` → model) or its slice of
every expert's hidden (``expert_ff`` → model), and the partial outputs of
its own tokens are summed with one all-reduce over the model axis.

Under grad on a mesh each rank's gates and expert inputs feed only its own
experts' (or hidden slice's) terms, so the tokens' gradient and the f32
router's are summed over the model axis (``parallel.copy_to``), and the
batch gathered over the data axes takes its gradient back
reduce-scattered (``parallel.gather_from``); the dense SwiGLU's input is
summed likewise. Every replicated weight's gradient arrives whole on each
rank.
"""

from __future__ import annotations

import types

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import spans
from ..configs.base import ModelConfig
from .common import dense_init, linear, linear_rows, reduce_dtype, weight
from .parallel import copy_to, gather_from, reduce_from

MOE_IMPLS = ("sort", "einsum", "ep_local")


class MLP(nn.Module):
    """Weights of one SwiGLU block: wi, wg (d, ff) and wo (ff, d); ff is
    the config's ``d_ff`` unless ``d_ff`` is given (a shared expert)."""

    def __init__(self, cfg: ModelConfig, generator, dtype, device,
                 d_ff: int = 0):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        self.wi = weight(dense_init((d, f), generator, dtype, device),
                         ("embed", "ff"))
        self.wg = weight(dense_init((d, f), generator, dtype, device),
                         ("embed", "ff"))
        self.wo = weight(dense_init((f, d), generator, dtype, device),
                         ("ff", "embed"))


def init_mlp(cfg: ModelConfig, generator, dtype, device) -> MLP:
    return MLP(cfg, generator, dtype, device)


def mlp(p: MLP, x: torch.Tensor, layout=None) -> torch.Tensor:
    if layout is None:
        h = torch.nn.functional.silu(linear(x, p.wg)) * linear(x, p.wi)
        return linear(h, p.wo)
    wi, wg, wo = layout.whole(p.wi, 0), layout.whole(p.wg, 0), \
        layout.whole(p.wo, 1)
    ff = layout.axes("ff")
    if ff:
        x = copy_to(x, layout, ff)
    h = torch.nn.functional.silu(linear(x, wg)) * linear(x, wi)
    return linear_rows(h, wo, layout, ff) if ff else linear(h, wo)


class MoE(nn.Module):
    """Weights of one MoE block: ``router`` (d, E), always f32, and the
    experts' SwiGLU ``wi``, ``wg`` (E_held, d, ff) and ``wo`` (E_held, ff,
    d), where E_held is the config's ``local_experts`` (all E unless it
    holds a block of them). Each is drawn with fan-in ``shape[0]``, as the
    reference draws them."""

    def __init__(self, cfg: ModelConfig, generator, dtype, device):
        super().__init__()
        d, e, held = cfg.d_model, cfg.num_experts, cfg.local_experts
        f = cfg.moe_d_ff or cfg.d_ff
        self.router = weight(dense_init((d, e), generator, torch.float32,
                                        device), ("embed", None))
        self.wi = weight(dense_init((held, d, f), generator, dtype, device),
                         ("experts", "expert_embed", "expert_ff"))
        self.wg = weight(dense_init((held, d, f), generator, dtype, device),
                         ("experts", "expert_embed", "expert_ff"))
        self.wo = weight(dense_init((held, f, d), generator, dtype, device),
                         ("experts", "expert_ff", "expert_embed"))


def init_moe(cfg: ModelConfig, generator, dtype, device) -> MoE:
    return MoE(cfg, generator, dtype, device)


def _router(p, x: torch.Tensor, cfg: ModelConfig):
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


def _expert_counts(e_sorted: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(e_sorted, minlength=n)`` for ids in ``[0, n)``; on
    the meta device, which has no bincount kernel, an empty int64 tensor
    of the same shape ``(n,)``."""
    if e_sorted.device.type == "meta":
        return e_sorted.new_empty((n,), dtype=torch.int64)
    return torch.bincount(e_sorted, minlength=n)


def _experts_ffn(p, xin: torch.Tensor) -> torch.Tensor:
    """xin (E, C, d) → (E, C, d), every expert's SwiGLU on its batch
    (:func:`linear` on 3-D operands is a batched product). Where ``p``
    holds a slice of each expert's hidden (``p.partial``), the last
    product stays in the reduce dtype: a partial sum for the all-reduce."""
    h = torch.nn.functional.silu(linear(xin, p.wg)) * linear(xin, p.wi)
    if getattr(p, "partial", False):
        return torch.matmul(h.float(), p.wo.float()).to(
            reduce_dtype(xin.dtype))
    return linear(h, p.wo)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of ``idx`` over ``n`` classes; an index outside
    ``[0, n)`` gives a zero row, as ``jax.nn.one_hot`` does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def moe_einsum(p, x: torch.Tensor, cfg: ModelConfig,
               capacity_factor: float = 1.25, first: int = 0,
               capacity_tokens: int = 0) -> torch.Tensor:
    """One-hot dispatch/combine MoE. x (T, d) → (T, d). Where ``p`` holds
    the experts ``first, first + 1, …`` only (a mesh's block), the result
    is their part of the output. ``capacity_tokens``, where given, is the
    token count the capacity is computed for in place of T (a chunk's)."""
    t, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_tok
    c = _capacity(capacity_tokens or t, cfg, capacity_factor)
    gates, idx = _router(p, x, cfg)                       # (T, k)

    onehot = _one_hot(idx, e)                             # (T, k, E)
    # Position of each (token, expert) assignment in its expert's queue.
    pos = torch.cumsum(onehot.reshape(t * k, e), dim=0).reshape(t, k, e) \
        - 1.0
    kept = onehot * ((pos < c) & (onehot > 0))
    pos_oh = _one_hot(pos.to(torch.int32), c)             # (T, k, E, C)
    dispatch = torch.einsum("tke,tkec->tec", kept, pos_oh)
    combine = torch.einsum("tk,tke,tkec->tec", gates, kept, pos_oh)
    n_e = p.wi.shape[0]
    dispatch = dispatch[:, first:first + n_e]
    combine = combine[:, first:first + n_e]
    xin = torch.einsum("tec,td->ecd", dispatch.to(x.dtype).float(),
                       x.float()).to(x.dtype)
    out = _experts_ffn(p, xin)
    return torch.einsum("tec,ecd->td", combine, out.float()).to(out.dtype)


def moe_sort(p, x: torch.Tensor, cfg: ModelConfig,
             capacity_factor: float = 1.25, first: int = 0,
             capacity_tokens: int = 0) -> torch.Tensor:
    """Gather/scatter dispatch MoE (no one-hot products). x (T, d). Where
    ``p`` holds the experts ``first, first + 1, …`` only (a mesh's block),
    the result is their part of the output: the routing, the capacity and
    every assignment's rank are the whole layer's. ``capacity_tokens`` as
    in :func:`moe_einsum`."""
    t, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_tok
    c = _capacity(capacity_tokens or t, cfg, capacity_factor)
    with spans.span("moe.route"):
        gates, idx = _router(p, x, cfg)                   # (T, k)
        flat_e = idx.reshape(-1)                          # (T·k,)
        flat_g = gates.reshape(-1)
        flat_tok = torch.arange(t, device=x.device).repeat_interleave(k)
        order = torch.argsort(flat_e, stable=True)
        e_sorted = flat_e[order]
        tok_sorted = flat_tok[order]
        g_sorted = flat_g[order]

    with spans.span("moe.dispatch"):
        # Rank within expert: global position − start offset of that
        # expert.
        with spans.span("sync.bincount", syncs=2):    # its min and max
            counts = _expert_counts(e_sorted, e)
        starts = torch.cumsum(counts, dim=0) - counts
        rank = torch.arange(t * k, device=x.device) - starts[e_sorted]
        valid = rank < c
        slot = torch.where(valid, rank, 0)
        n_e = p.wi.shape[0]
        row = e_sorted - first
        valid = valid & (row >= 0) & (row < n_e)
        row = torch.where(valid, row, 0)
        if spans.recording():
            spans.count("moe.slots", n_e * c)
            spans.count("moe.slots_filled", valid.sum())
            spans.count("moe.assignments", t * k)
            spans.count("moe.dropped", (rank >= c).sum())

        # Tokens into expert batches. A dropped assignment adds a zero row
        # to slot 0 of its expert, so the scatter must accumulate: an
        # assignment would overwrite the kept token that owns the slot.
        xin = torch.zeros((n_e, c, d), dtype=x.dtype, device=x.device)
        xin = xin.index_put((row, slot),
                            torch.where(valid[:, None], x[tok_sorted],
                                        torch.zeros((), dtype=x.dtype,
                                                    device=x.device)),
                            accumulate=True)
    with spans.span("moe.experts"):
        out = _experts_ffn(p, xin)                        # (E, C, d)

    # Combine: each kept assignment's result, times its gate, added to
    # its token; a dropped one's gate is 0.
    with spans.span("moe.combine"):
        vals = out[row, slot] * (g_sorted * valid)[:, None].to(out.dtype)
        return torch.zeros((t, d), dtype=out.dtype,
                           device=x.device).index_add(0, tok_sorted, vals)


def moe(p: MoE, x: torch.Tensor, cfg: ModelConfig, *, impl: str = "sort",
        capacity_factor: float = 1.25, token_chunk: int = 65_536,
        layout=None, mesh=None) -> torch.Tensor:
    """x (B, S, d) → (B, S, d); ``impl`` one of :data:`MOE_IMPLS`.

    The B·S tokens route together (capacity counts them all). More than
    ``token_chunk`` tokens go through the layer a chunk at a time, so the
    dispatch buffers scale with the chunk. Every chunk's capacity is a
    whole chunk's: the reference pads the last one with zero rows, which
    queue behind its every real token and so displace none, and the port
    routes only the real rows at that capacity, the same result without
    the padding's work (its assignments, dropped past capacity, all land
    on one slot). Under grad each chunk is
    checkpointed (recomputed in the backward), as the reference wraps its
    chunk scan in ``jax.checkpoint``.

    On a mesh (``layout``, the model's; ``mesh``, the ``RunConfig``'s)
    ``ep_local`` runs :func:`moe_ep_local` where the plan gives the
    experts a mesh axis and ``mesh`` is set, else ``sort``; ``sort`` and
    ``einsum`` run as the module docstring says.

    Without a mesh, a model that holds a block of its experts (the
    config's ``experts_held`` from ``experts_first``: one device's share
    of an expert-parallel deployment) routes over all ``num_experts``,
    with the whole layer's capacity and ranks, and returns its own
    experts' part of the output: the rank's half of ``sort`` or
    ``einsum`` on a mesh, before the all-reduce, which one device needs
    not.
    """
    if impl not in MOE_IMPLS:
        raise ValueError(f"moe impl {impl!r} is not one of {MOE_IMPLS}")
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    if layout is not None:
        ep = layout.axes("experts")
        if impl == "ep_local" and mesh is not None and ep:
            w = types.SimpleNamespace(
                router=copy_to(layout.whole(p.router, 0), layout, ep),
                wi=p.wi, wg=p.wg, wo=p.wo)
            y = moe_ep_local(w, xt, cfg, capacity_factor, layout)
            return y.reshape(b, s, d).to(x.dtype)
        return _moe_on_mesh(p, xt, cfg, impl, capacity_factor, token_chunk,
                            layout).reshape(b, s, d).to(x.dtype)
    fn = moe_einsum if impl == "einsum" else moe_sort
    return _chunked(fn, p, xt, cfg, capacity_factor, token_chunk,
                    cfg.experts_first).reshape(b, s, d).to(x.dtype)


def _chunked(fn, p, xt: torch.Tensor, cfg: ModelConfig,
             capacity_factor: float, token_chunk: int, first: int
             ) -> torch.Tensor:
    """``fn`` over the tokens xt (T, d), ``token_chunk`` at a time (on
    the meta device all at once: module docstring)."""
    t = xt.shape[0]
    if t <= token_chunk or xt.device.type == "meta":
        return fn(p, xt, cfg, capacity_factor, first)
    ys = []
    for xi in xt.split(token_chunk):
        if torch.is_grad_enabled():
            ys.append(checkpoint(fn, p, xi, cfg, capacity_factor, first,
                                 token_chunk, use_reentrant=False))
        else:
            ys.append(fn(p, xi, cfg, capacity_factor, first, token_chunk))
    return torch.cat(ys)


def _moe_on_mesh(p: MoE, xt: torch.Tensor, cfg: ModelConfig, impl: str,
                 capacity_factor: float, token_chunk: int, layout
                 ) -> torch.Tensor:
    """``sort`` or ``einsum`` on a mesh: the rank's tokens xt (T_loc, d)
    → their outputs, the unsharded function's (module docstring)."""
    batch = layout.axes("batch")
    ep, tp = layout.axes("experts"), layout.axes("expert_ff")
    split = ep or tp
    router = layout.whole(p.router, 0)
    if split:
        xt = copy_to(xt, layout, split)
        router = copy_to(router, layout, split)
    xs = gather_from(xt, layout, batch, 0) if batch else xt
    w = types.SimpleNamespace(
        router=router,
        wi=layout.whole(p.wi, 1, "expert_embed"),
        wg=layout.whole(p.wg, 1, "expert_embed"),
        wo=layout.whole(p.wo, 2, "expert_embed"), partial=bool(tp))
    first = layout.index(ep) * p.wi.shape[0] if ep else 0
    fn = moe_einsum if impl == "einsum" else moe_sort
    y = _chunked(fn, w, xs, cfg, capacity_factor, token_chunk, first)
    if batch:
        y = y[layout.rows(xs.shape[0])]
    return reduce_from(y, layout, split) if split else y


def ep_local_capacity(t_loc: int, cfg: ModelConfig, factor: float) -> int:
    """``moe_ep_local``'s slots per expert for a chunk of ``t_loc`` tokens
    on one data shard: ``max(4, int(t_loc·k·factor/E) + 1)``, neither
    clipped to ``t_loc`` nor rounded to 32 as :func:`_capacity` is."""
    return max(4, int(t_loc * cfg.experts_per_tok * factor
                      / cfg.num_experts) + 1)


def _ep_dispatch(w, x: torch.Tensor, cfg: ModelConfig,
                 capacity_factor: float, m: int, e_loc: int) -> torch.Tensor:
    """One chunk of :func:`moe_ep_local` on model shard ``m``: x (t, d) →
    the partial (t, d) of the shard's experts ``[m·e_loc, (m+1)·e_loc)``.
    Assignments to other experts go to the spill row ``e_loc``, which is
    sorted last and dropped."""
    t, d = x.shape
    k = cfg.experts_per_tok
    c = ep_local_capacity(t, cfg, capacity_factor)
    gates, idx = _router(w, x, cfg)
    flat_e = idx.reshape(-1) - m * e_loc
    flat_g = gates.reshape(-1)
    flat_tok = torch.arange(t, device=x.device).repeat_interleave(k)
    mine = (flat_e >= 0) & (flat_e < e_loc)
    e_mine = torch.where(mine, flat_e, e_loc)             # spill row e_loc
    order = torch.argsort(e_mine, stable=True)
    e_sorted = e_mine[order]
    tok_sorted = flat_tok[order]
    g_sorted = flat_g[order]
    counts = _expert_counts(e_sorted, e_loc + 1)
    starts = torch.cumsum(counts, dim=0) - counts
    rank = torch.arange(t * k, device=x.device) - starts[e_sorted]
    valid = (e_sorted < e_loc) & (rank < c)
    slot = torch.where(valid, rank, 0)
    row = torch.where(valid, e_sorted, e_loc)
    xin = torch.zeros((e_loc + 1, c, d), dtype=x.dtype, device=x.device)
    xin = xin.index_put((row, slot),
                        torch.where(valid[:, None], x[tok_sorted],
                                    torch.zeros((), dtype=x.dtype,
                                                device=x.device)),
                        accumulate=True)[:e_loc]
    out = _experts_ffn(w, xin)                            # (E_loc, C, d)
    out = torch.cat([out, torch.zeros((1, c, d), dtype=out.dtype,
                                      device=out.device)])
    vals = out[row, slot] * (g_sorted * valid)[:, None].to(out.dtype)
    return torch.zeros((t, d), dtype=out.dtype,
                       device=x.device).index_add(0, tok_sorted, vals)


def moe_ep_local(w, x: torch.Tensor, cfg: ModelConfig,
                 capacity_factor: float, layout) -> torch.Tensor:
    """Expert parallelism with a *local* dispatch and one all-reduce: the
    port of the reference's ``moe_ep_local``.

    x (T_loc, d) are the rank's tokens (its block of the batch), the same
    on every rank of the model axis; ``w`` holds the whole f32 ``router``
    and the rank's ``E/|model|`` experts. Each rank routes its tokens,
    gathers those assigned to its own experts (the others go to the spill
    row), runs its experts and adds its partial (T_loc, d); an all-reduce
    over the experts' axis completes the combine. Capacity is per data
    shard and chunk (:func:`ep_local_capacity`); more than 8,192 tokens go
    in chunks of 8,192 where that divides T_loc, each checkpointed under
    grad as the reference's scan step is. Differentiable: x enters through
    :func:`~repro_torch.models.parallel.copy_to` (its gradient summed over
    the model axis) and the output leaves through ``reduce_from``.
    """
    ax = layout.axes("experts")
    if not ax:
        raise ValueError("ep_local needs an expert-parallel plan")
    e_loc = cfg.num_experts // layout.span(ax)
    if w.wi.shape[0] != e_loc:
        raise ValueError(f"{w.wi.shape[0]} experts on this rank, not "
                         f"E/|model| = {e_loc}")
    m = layout.index(ax)
    x = copy_to(x, layout, ax)
    t_loc = x.shape[0]
    chunk = min(8192, t_loc)
    if t_loc % chunk or x.device.type == "meta":
        chunk = t_loc
    if chunk == t_loc:
        y = _ep_dispatch(w, x, cfg, capacity_factor, m, e_loc)
    else:
        ys = []
        for xi in x.split(chunk):
            if torch.is_grad_enabled():
                ys.append(checkpoint(_ep_dispatch, w, xi, cfg,
                                     capacity_factor, m, e_loc,
                                     use_reentrant=False))
            else:
                ys.append(_ep_dispatch(w, xi, cfg, capacity_factor, m,
                                       e_loc))
        y = torch.cat(ys)
    return reduce_from(y, layout, ax)


__all__ = ["MLP", "init_mlp", "mlp", "MoE", "init_moe", "moe", "moe_einsum",
           "moe_sort", "moe_ep_local", "ep_local_capacity", "MOE_IMPLS"]
