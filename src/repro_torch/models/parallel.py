"""A rank's place on a device mesh, and the collectives of sharded models.

The reference annotates weights with ``PartitionSpec`` s and lets GSPMD
insert the collectives. Eager PyTorch has none, so a sharded model here
holds *local blocks* (``sharding.local_block``) and calls the collectives
itself, in the Megatron/ZeRO manner. Every one goes through
:class:`Layout`, which holds one process group per set of mesh axes and
counts calls and bytes by kind in :data:`counts` (as ``core/dist.py``
counts its rounds): ``all_reduce`` (sum or max), ``all_gather`` and
``reduce_scatter``. The bytes are those the rank contributes (its input
tensor). A group of one rank is a pass-through that is still counted, so a
``(1, 1)`` mesh runs the unsharded numbers with every collective's count
visible. Gloo has no reduce-scatter: there it is an all-reduce of the
whole tensor, of which the rank keeps its block, still counted as
``reduce_scatter`` with the whole tensor's bytes (what the rank sent);
NCCL runs ``reduce_scatter_tensor``.

A gloo group carries CUDA tensors through host memory by design: the
tensor is copied to the host, reduced or gathered there, and copied back.
That is how two ranks share one card, which NCCL refuses; NCCL groups take
CUDA tensors directly. No collective is ever skipped, and none falls back
to another path when it fails.

:func:`copy_to` and :func:`reduce_from` are the two autograd halves of a
model-parallel region: the first is the identity forward and an all-reduce
backward (a replicated input whose uses are split over ranks), the second
an all-reduce forward and the identity backward (partial outputs summed).
:func:`gather_from` is the ZeRO half: an all-gather forward and a
reduce-scatter backward, so the gradient of a weight gathered over the data
axes arrives summed over them and cut to the rank's block.
:meth:`Layout.whole` gathers through it. Blocks under
``torch.utils.checkpoint`` run their forward collectives again in the
backward, in the same order on every rank; each is counted as issued.

**A stand-in mesh** (:class:`StandinMesh`, ``launch/mesh.standin_mesh``)
gives the axis names and sizes of a mesh and one rank's coordinates on it,
and nothing else: no ranks, no process group. A :class:`Layout` on it
makes no group, and each collective over two or more ranks returns an
empty meta tensor of the shape a live rank would get, communicating
nothing, and is counted in :data:`counts` exactly as a live rank counts it
(the same tensor's bytes). That byte rule is the same for NCCL and gloo:
a reduce-scatter counts the whole tensor the rank contributes on both, so
a stand-in count stands for either backend. Only the dry run and the
tests build a stand-in mesh, and its collectives refuse any tensor that
is not on the meta device; a live ``DeviceMesh`` never takes this mode.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .sharding import (ShardingPlan, Spec, axes_index, axes_span, entry_axes,
                       local_block, mesh_axis_sizes, mesh_coords)

KINDS = ("all_reduce", "all_gather", "reduce_scatter")

# Collectives issued and the bytes they carried since reset_counts().
counts: Dict[str, Dict[str, int]] = {k: {"calls": 0, "bytes": 0}
                                     for k in KINDS}


def reset_counts() -> None:
    for row in counts.values():
        row["calls"] = row["bytes"] = 0


def snapshot() -> Dict[str, Dict[str, int]]:
    """A copy of :data:`counts`."""
    return {k: dict(v) for k, v in counts.items()}


def _count(kind: str, x: torch.Tensor) -> None:
    counts[kind]["calls"] += 1
    counts[kind]["bytes"] += x.numel() * x.element_size()


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class StandinMesh:
    """The axes of a device mesh ({name: size}, outermost first) and one
    rank's coordinates on it (0 on every axis when None), with the
    attributes a :class:`Layout` reads from a ``DeviceMesh``. It has no
    ranks and no process groups (module docstring)."""

    def __init__(self, axes: Dict[str, int],
                 coords: Optional[Dict[str, int]] = None):
        self.mesh_dim_names = tuple(axes)
        self.shape = tuple(int(n) for n in axes.values())
        coords = {a: 0 for a in axes} if coords is None else dict(coords)
        if set(coords) != set(axes) or any(
                not 0 <= coords[a] < axes[a] for a in axes):
            raise ValueError(f"coordinates {coords} are not a rank of the "
                             f"mesh {dict(axes)}")
        self.coords = coords
        n = 1
        for size in self.shape:
            n *= size
        self.mesh = torch.arange(n).reshape(self.shape)

    def get_local_rank(self, axis: str) -> int:
        return self.coords[axis]

    def get_group(self, axis: str):
        raise RuntimeError("a stand-in mesh has no process groups")


# The group of two or more ranks of a stand-in mesh: none is made.
_STANDIN_GROUP = object()


def _check_meta(x: torch.Tensor, kind: str) -> None:
    if x.device.type != "meta":
        raise ValueError(f"{kind} on a stand-in mesh: it communicates "
                         f"nothing, so it takes meta tensors only, not "
                         f"{x.device}")


class Layout:
    """The rank's coordinates on ``mesh`` (a ``DeviceMesh``) under
    ``plan``, the groups of every set of its axes, and the collectives.

    Built collectively: every rank of the mesh constructs it in the same
    order, since each group of two or more axes is a ``new_group`` that
    every rank must call. Single axes use the mesh's own groups.
    """

    def __init__(self, plan: ShardingPlan, mesh):
        if not plan.active:
            raise ValueError("a Layout needs an active plan")
        self.plan, self.mesh = plan, mesh
        self.standin = isinstance(mesh, StandinMesh)
        self.sizes = mesh_axis_sizes(mesh)
        names = tuple(mesh.mesh_dim_names)
        self.coords = mesh_coords(mesh)
        self.batch_rows: Optional[int] = None   # set by each entry point
        self._groups: Dict[Tuple[str, ...], Optional[object]] = {}
        grid = mesh.mesh
        for r in range(1, len(names) + 1):
            for axes in itertools.combinations(names, r):
                if axes_span(axes, self.sizes) == 1:
                    self._groups[axes] = None
                elif self.standin:
                    self._groups[axes] = _STANDIN_GROUP
                elif r == 1:
                    self._groups[axes] = mesh.get_group(axes[0])
                else:
                    self._groups[axes] = self._new_group(grid, names, axes)

    def _new_group(self, grid, names, axes):
        others = [a for a in names if a not in axes]
        mine = None
        for idx in itertools.product(*(range(self.sizes[a])
                                       for a in others)):
            where = dict(zip(others, idx))
            sel = tuple(slice(None) if a in axes else where[a]
                        for a in names)
            ranks = grid[sel].flatten().tolist()
            g = dist.new_group(ranks)
            if all(self.coords[a] == where[a] for a in others):
                mine = g
        return mine

    # -- the plan on this rank -----------------------------------------

    def axes(self, logical: str) -> Tuple[str, ...]:
        """The mesh axes the plan gives ``logical``."""
        return entry_axes(self.plan.axes.get(logical))

    def span(self, axes: Sequence[str]) -> int:
        return axes_span(axes, self.sizes)

    def index(self, axes: Sequence[str]) -> int:
        return axes_index(axes, self.sizes, self.coords)

    def block(self, shape: Sequence[int], spec: Spec) -> Tuple[slice, ...]:
        """This rank's slices of a ``shape`` leaf with ``spec``."""
        return local_block(shape, spec, self.sizes, self.coords)

    def local(self, t: torch.Tensor, spec: Spec) -> torch.Tensor:
        """This rank's block of the whole tensor ``t``, as a new tensor."""
        return t[self.block(t.shape, spec)].clone()

    def rows(self, n: int, logical: str = "batch") -> slice:
        """The rank's block of ``n`` rows split over ``logical``'s axes."""
        return self.block((n,), (self.plan.axes.get(logical),))[0]

    def whole(self, w: torch.Tensor, dim: int,
              logical: str = "embed") -> torch.Tensor:
        """``w`` with its ``dim`` gathered over ``logical``'s axes: the
        ZeRO gather of a weight's d_model rows just before use (the result
        is dropped after it). ``w`` itself where the plan gives the axis
        no mesh axis."""
        axes = self.axes(logical)
        return gather_from(w, self, axes, dim) if axes else w

    def _group(self, axes: Sequence[str]):
        key = tuple(a for a in self.mesh.mesh_dim_names if a in axes)
        if len(key) != len(tuple(axes)):
            raise ValueError(f"axes {tuple(axes)} are not the mesh's "
                             f"{self.mesh.mesh_dim_names}")
        return self._groups[key] if key else None

    # -- collectives -----------------------------------------------------

    def all_reduce(self, x: torch.Tensor, axes: Sequence[str],
                   op: str = "sum") -> torch.Tensor:
        """The ``op`` (sum or max) of ``x`` over the ranks that differ
        only along ``axes``. ``x`` is not changed; over one rank the
        result is ``x`` itself, so no caller writes into a result."""
        _count("all_reduce", x)
        g = self._group(axes)
        if g is None:
            return x
        if g is _STANDIN_GROUP:
            _check_meta(x, "all_reduce")
            return torch.empty_like(x)
        staged = _staged(x, g)
        dist.all_reduce(staged, op=_OPS[op], group=g)
        return staged.to(x.device)

    def all_gather(self, x: torch.Tensor, axes: Sequence[str],
                   dim: int) -> torch.Tensor:
        """The blocks of ``x`` over ``axes`` concatenated along ``dim`` in
        row-major order of ``axes``: the inverse of :meth:`block` on that
        dim."""
        _count("all_gather", x)
        g = self._group(axes)
        if g is None:
            return x
        if g is _STANDIN_GROUP:
            _check_meta(x, "all_gather")
            shape = list(x.shape)
            shape[dim] *= self.span(axes)
            return x.new_empty(shape)
        staged = _staged(x, g)
        parts = [torch.empty_like(staged) for _ in range(self.span(axes))]
        dist.all_gather(parts, staged, group=g)
        return torch.cat(parts, dim=dim).to(x.device)

    def reduce_scatter(self, x: torch.Tensor, axes: Sequence[str],
                       dim: int) -> torch.Tensor:
        """The sum of ``x`` over ``axes``, cut to this rank's block along
        ``dim`` (the block :meth:`all_gather` takes back): NCCL's
        ``reduce_scatter_tensor``; on gloo, which has none, an all-reduce
        of the whole ``x`` and the rank's block of it."""
        _count("reduce_scatter", x)
        g = self._group(axes)
        if g is None:
            return x
        n, i = self.span(axes), self.index(axes)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                             f"over {tuple(axes)} ({n} ranks)")
        b = x.shape[dim] // n
        if g is _STANDIN_GROUP:
            _check_meta(x, "reduce_scatter")
            shape = list(x.shape)
            shape[dim] = b
            return x.new_empty(shape)
        if dist.get_backend(g) == "gloo":
            staged = _staged(x, g)
            dist.all_reduce(staged, group=g)
            return staged.narrow(dim, i * b, b).contiguous().to(x.device)
        whole = x.detach().movedim(dim, 0).contiguous()
        out = torch.empty((b,) + tuple(whole.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, whole, group=g)
        return out.movedim(0, dim).contiguous()

    def gather_spec(self, t: torch.Tensor, spec: Spec) -> torch.Tensor:
        """The whole leaf from this rank's block ``t`` of a leaf with
        ``spec``: an all-gather along every sharded dim."""
        for dim, entry in enumerate(spec):
            axes = entry_axes(entry)
            if axes:
                t = self.all_gather(t.contiguous(), axes, dim)
        return t


def _staged(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` contiguous, on the host for a gloo group (which this module
    uses to carry CUDA tensors through host memory), as a fresh copy."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        return x.detach().to("cpu", copy=True).contiguous()
    return x.detach().clone().contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout, axes):
        ctx.layout, ctx.axes = layout, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.layout.all_reduce(g, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout, axes):
        y = layout.all_reduce(x, axes)
        return y.view_as(y) if y is x else y

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout, axes, dim):
        ctx.layout, ctx.axes, ctx.dim = layout, axes, dim
        y = layout.all_gather(x, axes, dim)
        return y.view_as(y) if y is x else y

    @staticmethod
    def backward(ctx, g):
        return ctx.layout.reduce_scatter(g, ctx.axes, ctx.dim), None, None, \
            None


def gather_from(x: torch.Tensor, layout: Layout, axes: Sequence[str],
                dim: int) -> torch.Tensor:
    """All-gathered over ``axes`` along ``dim`` forward; the gradient
    reduce-scattered back to the rank's block backward."""
    return _GatherFrom.apply(x, layout, tuple(axes), dim)


def copy_to(x: torch.Tensor, layout: Layout,
            axes: Sequence[str]) -> torch.Tensor:
    """Identity forward; the gradient summed over ``axes`` backward."""
    return _CopyTo.apply(x, layout, tuple(axes))


def reduce_from(x: torch.Tensor, layout: Layout,
                axes: Sequence[str]) -> torch.Tensor:
    """Summed over ``axes`` forward; the identity backward."""
    return _ReduceFrom.apply(x, layout, tuple(axes))


__all__ = ["Layout", "StandinMesh", "counts", "reset_counts", "snapshot", "copy_to",
           "reduce_from", "gather_from", "KINDS"]
