"""Shared model building blocks: weights with their logical axes, norms,
RoPE, linears, and the sharding helpers.

The port of ``repro/models/common.py``. Weights keep the reference's
``x @ W`` orientation, ``(d_in, d_out)``. Where the reference pairs each
leaf with its ``PartitionSpec`` (``Pm``), each weight here records its
*logical* axes once, where it is made (:func:`weight`), and
:func:`param_specs` resolves them against a plan, keyed like
``state_dict`` (the spec half of ``split_params``). While a sharded model
is drawn (:func:`drawing_blocks`), :func:`weight` keeps only the rank's
block of each leaf. :func:`constrain` keeps the reference's call sites and
checks a local shape against the plan; :func:`set_matmul_reduce_dtype`
sets the dtype in which row-parallel partial products are all-reduced
(:func:`linear_rows`).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .. import spans
from .parallel import copy_to, reduce_from

# The layout whose blocks weight() keeps while a sharded model is drawn.
_DRAWING = None


@contextlib.contextmanager
def drawing_blocks(layout):
    """While active, :func:`weight` keeps ``layout``'s block of each leaf
    it is given and the whole leaf is freed: a sharded build never holds
    more than one whole leaf."""
    global _DRAWING
    prev, _DRAWING = _DRAWING, layout
    try:
        yield
    finally:
        _DRAWING = prev


def weight(t: torch.Tensor, axes: Tuple[Optional[str], ...]) -> nn.Parameter:
    """A weight with its logical axes (one name or None a dim, the names
    of ``models/sharding.py``), built frozen for serving;
    ``train.train_step.init_train_state`` turns a model's weights
    trainable. Under :func:`drawing_blocks` it holds the rank's block."""
    axes = tuple(axes)
    if len(axes) != t.dim():
        raise ValueError(f"axes {axes} for a {t.dim()}-d weight")
    if _DRAWING is not None:
        t = _DRAWING.local(t, _DRAWING.plan.P(*axes))
    p = nn.Parameter(t, requires_grad=False)
    p.axes = axes
    return p


def param_axes(model: nn.Module) -> Dict[str, Tuple[Optional[str], ...]]:
    """Every weight's logical axes by its ``state_dict`` name."""
    return {name: p.axes for name, p in model.named_parameters()}


def attach_axes(model: nn.Module, axes: Dict[str, tuple]) -> None:
    """Record ``axes`` (by name) on the model's weights again: a module
    moved with ``to_empty`` or ``to`` holds new parameter objects."""
    for name, p in model.named_parameters():
        p.axes = axes[name]


def param_specs(model: nn.Module, plan) -> Dict[str, tuple]:
    """Each weight's spec under ``plan``, keyed like ``state_dict``. A
    port weight is one layer of the reference's stacked leaf, whose spec
    is this one with ``None`` for each stacked axis
    (``weights.reference_specs``)."""
    return {name: plan.P(*p.axes) for name, p in model.named_parameters()}


def dense_init(shape: Sequence[int], generator: Optional[torch.Generator],
               dtype: torch.dtype, device: torch.device,
               in_axis_size: Optional[int] = None) -> torch.Tensor:
    """Truncated-normal fan-in init: N(0, 1) cut at ±2, times
    ``1 / sqrt(fan_in)``; ``fan_in`` is ``shape[0]`` unless given.

    Drawn in f32 on the generator's device, then moved. On the ``meta``
    device nothing is drawn. The numbers differ from ``jax.random``'s for
    the same seed; tests carry weights across instead (``weights.py``).
    """
    if torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    std = 1.0 / np.sqrt(max(1, fan_in))
    gen_device = generator.device if generator is not None else "cpu"
    t = torch.empty(tuple(shape), dtype=torch.float32, device=gen_device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * std).to(device=device, dtype=dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps)
    return (out * scale.float()).to(dt)


def rms_norm_split(x: torch.Tensor, scale: torch.Tensor, eps: float,
                   layout, axes: Sequence[str], width: int) -> torch.Tensor:
    """:func:`rms_norm` over a last dim of ``width`` whose columns are
    split over the mesh ``axes``: ``x`` and ``scale`` hold the rank's
    columns. Each rank's mean square, weighted by its share of the
    columns, is summed over ``axes`` forward and backward (every rank's
    columns read the total, so its gradient is the sum of theirs). Over
    one rank the weight is 1.0 and the arithmetic :func:`rms_norm`'s, bit
    for bit; without ``axes`` it is :func:`rms_norm`."""
    if not axes:
        return rms_norm(x, scale, eps)
    dt = x.dtype
    x = x.float()
    part = torch.mean(x * x, dim=-1, keepdim=True) * (x.shape[-1] / width)
    var = copy_to(reduce_from(part, layout, axes), layout, axes)
    out = x * torch.rsqrt(var + eps)
    return (out * scale.float()).to(dt)


def head_block(layout, axes: Sequence[str], heads: int,
               what: str) -> Tuple[int, int]:
    """(first, count): the rank's contiguous block of ``heads`` heads
    split over the mesh ``axes`` (all of them, from 0, without axes).
    Raises ``ValueError`` where ``heads`` does not divide over them: a
    recurrent mixer runs whole heads on each rank."""
    if not axes:
        return 0, heads
    n = layout.span(axes)
    if heads % n:
        raise ValueError(f"{what}: {heads} heads do not divide over "
                         f"{tuple(axes)} ({n} ranks)")
    return layout.index(axes) * (heads // n), heads // n


def replicated_part(t: torch.Tensor, layout, axes: Sequence[str],
                    part) -> torch.Tensor:
    """``t[part]`` of a replicated weight of which the rank uses only
    ``part``: its gradient summed over ``axes`` (``parallel.copy_to``),
    so it arrives whole on every rank. ``t`` itself without axes."""
    if not axes:
        return t
    return copy_to(t, layout, axes)[part]


def head_rms_norm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the head dim (qk-norm). x (..., hd)."""
    return rms_norm(x, scale, eps)


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    """Inverse frequencies in float64 numpy, as the reference builds them."""
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half) * 2.0 / head_dim))


# Rope's inverse frequencies, cast to f32, on each device they were asked
# for: (head_dim, theta, device) → tensor. A copy from the host on every
# call would drain the stream (a pageable copy waits for the queued work).
_ROPE_TABLES: Dict[tuple, torch.Tensor] = {}


def rope_table(head_dim: int, theta: float,
               device: torch.device) -> torch.Tensor:
    """:func:`rope_frequencies` as f32 on ``device``, built once per
    ``(head_dim, theta, device)`` (each build counted as
    ``rope.table_builds``) and read from the cache after that."""
    key = (head_dim, theta, device)
    table = _ROPE_TABLES.get(key)
    if table is None:
        spans.count("rope.table_builds")
        table = torch.as_tensor(rope_frequencies(head_dim, theta),
                                dtype=torch.float32, device=device)
        _ROPE_TABLES[key] = table
    return table


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (B, S, H, hd); positions (B, S) or (S,)."""
    half = x.shape[-1] // 2
    freqs = rope_table(x.shape[-1], theta, x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs           # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# Cross-shard matmul reduction precision. 'f32': partial products are
# all-reduced in f32 (the default); 'bf16': a bf16 input's products come
# out in bf16, so a row-parallel all-reduce moves half the bytes.
_MATMUL_REDUCE_DTYPE = "f32"


def set_matmul_reduce_dtype(mode: str) -> None:
    global _MATMUL_REDUCE_DTYPE
    if mode not in ("f32", "bf16"):
        raise ValueError(f"matmul reduce dtype {mode!r} is not f32 or bf16")
    _MATMUL_REDUCE_DTYPE = mode


def reduce_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype a product of ``dtype`` operands comes out in."""
    if _MATMUL_REDUCE_DTYPE == "bf16" and dtype == torch.bfloat16:
        return torch.bfloat16
    return torch.float32


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with f32 accumulation, in the reduce dtype, cast back to
    ``x.dtype``.

    bf16 operands are widened to f32 first: their products are exact in
    f32, so this is the reference's bf16 dot with an f32 accumulator.
    """
    return torch.matmul(x.float(), w.float()).to(
        reduce_dtype(x.dtype)).to(x.dtype)


def linear_rows(x: torch.Tensor, w: torch.Tensor, layout,
                axes: Sequence[str]) -> torch.Tensor:
    """A row-parallel :func:`linear`: ``w`` holds this rank's block of
    rows (and ``x`` the matching columns); the partial products are
    all-reduced over ``axes`` in the reduce dtype (``parallel.reduce_from``:
    the gradient passes back unchanged), then cast to ``x.dtype``. Without
    a layout it is :func:`linear`."""
    part = torch.matmul(x.float(), w.float()).to(reduce_dtype(x.dtype))
    if layout is not None:
        part = reduce_from(part, layout, axes)
    return part.to(x.dtype)


def constrain(x: torch.Tensor, layout, *logical) -> torch.Tensor:
    """The reference's activation constraint: a no-op without a mesh; on
    one, ``x`` must have one dim per logical name and, where the name is
    ``batch``, the rank's rows of the call's batch
    (``layout.batch_rows``). Returns ``x``."""
    if layout is None:
        return x
    if x.dim() != len(logical):
        raise ValueError(f"a {x.dim()}-d tensor constrained as {logical}")
    for dim, name in enumerate(logical):
        if name == "batch" and x.shape[dim] != layout.batch_rows:
            raise ValueError(f"dim {dim} holds {x.shape[dim]} rows; the "
                             f"rank's block of the batch is "
                             f"{layout.batch_rows}")
    return x


__all__ = ["weight", "param_axes", "attach_axes", "param_specs",
           "drawing_blocks", "dense_init", "rms_norm", "rms_norm_split",
           "head_block", "replicated_part", "head_rms_norm",
           "rope_frequencies", "rope_table", "apply_rope",
           "set_matmul_reduce_dtype", "reduce_dtype", "linear", "linear_rows",
           "constrain"]
