"""Sharding plans: logical axes → mesh axes, resolved per (arch × shape).

The port of ``repro/models/sharding.py``. Production mesh: ``(data=16,
model=16)`` single pod, ``(pod=2, data=16, model=16)`` multi-pod
(``launch/mesh.py``). The plan maps *logical* tensor axes to mesh axes
with per-architecture divisibility checks (smollm's 9 heads cannot shard
16-way, so attention is replicated over 'model' while the MLP is still
tensor-parallel; grok's 8 experts go tensor-parallel *inside* the experts
since 8 % 16 != 0; olmoe's 64 experts use expert parallelism).

Logical axes used by the model code:
  batch     — activation batch dim                (pod, data)
  embed     — d_model rows of weight matrices     (ZeRO-3 shard: data)
  ff        — MLP hidden                          (model)
  heads     — q-head dim of attention weights     (model if divisible)
  kv        — kv-head dim                         (model if divisible)
  vocab     — vocabulary dim                      (model)
  experts   — expert dim of stacked MoE weights   (model if divisible)
  expert_ff — per-expert hidden                   (model if experts aren't)
  seq_kv    — sequence dim of decode KV caches    (model [+ data if B small])
  stack     — stacked layer dim                   (never sharded)

A spec is a plain tuple standing in for ``PartitionSpec``: each entry is
``None`` (replicated), a mesh axis name, or a tuple of names taken
row-major, as ``NamedSharding`` takes them. :func:`local_block` is the one
rule that turns a spec into the block a rank holds, for weights, caches
and checkpoints alike.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

from ..configs.base import ModelConfig, ShapeConfig

Spec = Tuple[object, ...]


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    axes: Dict[str, object]          # logical name -> str / tuple / None
    active: bool = True              # False = single-device smoke mode

    def P(self, *logical) -> Spec:
        return tuple(self.axes.get(name) for name in logical)

    @staticmethod
    def null() -> "ShardingPlan":
        return ShardingPlan(axes={}, active=False)


def _divides(a: int, b: int) -> bool:
    return b > 0 and a % b == 0


def resolve_plan(cfg: ModelConfig, shape: Optional[ShapeConfig],
                 mesh_axes: Dict[str, int],
                 expert_mode: str = "auto") -> ShardingPlan:
    """Build the plan for a config on a mesh given as {axis_name: size}.

    ``expert_mode``: 'auto' (EP when E divides the model axis, else TP
    inside experts), or force 'ep'/'tp'; 'ep' raises ``ValueError`` where E
    does not divide the model axis.
    """
    tp = "model" if "model" in mesh_axes else None
    tp_size = mesh_axes.get("model", 1)
    data_axes: Tuple[str, ...] = tuple(
        a for a in ("pod", "data") if a in mesh_axes)

    axes: Dict[str, object] = {}
    axes["stack"] = None
    axes["batch"] = data_axes if len(data_axes) > 1 else (
        data_axes[0] if data_axes else None)

    # ZeRO axes for the d_model rows of weights, spanning the pod axis too.
    span = 1
    for a in data_axes:
        span *= mesh_axes[a]
    if data_axes and _divides(cfg.d_model, span):
        axes["embed"] = data_axes if len(data_axes) > 1 else data_axes[0]
    elif "data" in mesh_axes and _divides(cfg.d_model, mesh_axes["data"]):
        axes["embed"] = "data"
    else:
        axes["embed"] = None

    axes["ff"] = tp if _divides(cfg.d_ff, tp_size) else None
    axes["vocab"] = tp if _divides(cfg.padded_vocab, tp_size) else None
    axes["heads"] = tp if _divides(cfg.num_heads, tp_size) else None
    axes["kv"] = tp if _divides(cfg.num_kv_heads, tp_size) else None

    if cfg.num_experts:
        use_ep = _divides(cfg.num_experts, tp_size)
        if expert_mode == "tp":
            use_ep = False
        elif expert_mode == "ep" and not use_ep:
            raise ValueError(f"E={cfg.num_experts} not divisible by tp")
        if use_ep:
            axes["experts"] = tp
            axes["expert_ff"] = None
            # EP expert weights are E/|model| small: no ZeRO on d.
            axes["expert_embed"] = None
        else:
            axes["experts"] = None
            ff = cfg.moe_d_ff or cfg.d_ff
            axes["expert_ff"] = tp if _divides(ff, tp_size) else None
            axes["expert_embed"] = axes["embed"]
    else:
        axes["experts"] = None
        axes["expert_ff"] = None
        axes["expert_embed"] = axes["embed"]

    # Capacity dim of MoE expert batches: never sharded by default.
    axes["moe_c"] = None

    # Decode KV-cache sequence sharding: over model; when the batch is too
    # small to occupy the data axes (long_500k, B=1), over them too.
    seq_axes = []
    if tp:
        seq_axes.append(tp)
    if shape is not None and shape.kind == "decode":
        batch_axes = axes["batch"]
        if batch_axes is not None:
            b_axes = entry_axes(batch_axes)
            span = 1
            for a in b_axes:
                span *= mesh_axes[a]
            if shape.global_batch < span:
                axes["batch"] = None
                seq_axes = [a for a in ("data", "model", "pod")
                            if a in mesh_axes]
    axes["seq_kv"] = tuple(seq_axes) if len(seq_axes) > 1 else (
        seq_axes[0] if seq_axes else None)

    return ShardingPlan(axes=axes, active=bool(mesh_axes))


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``torch.distributed`` ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def mesh_coords(mesh) -> Dict[str, int]:
    """{axis name: this rank's coordinate} on a ``DeviceMesh``."""
    return {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry: () for None, (name,) for a name."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axes_span(axes: Sequence[str], axis_sizes: Mapping[str, int]) -> int:
    n = 1
    for a in axes:
        n *= axis_sizes[a]
    return n


def axes_index(axes: Sequence[str], axis_sizes: Mapping[str, int],
               coords: Mapping[str, int]) -> int:
    """A rank's index along ``axes`` taken row-major (the first axis
    slowest), as ``NamedSharding`` orders a tuple of axes."""
    i = 0
    for a in axes:
        i = i * axis_sizes[a] + coords[a]
    return i


def local_block(shape: Sequence[int], spec: Spec,
                axis_sizes: Mapping[str, int],
                coords: Mapping[str, int]) -> Tuple[slice, ...]:
    """The slices of a ``shape`` leaf with ``spec`` that the rank at mesh
    ``coords`` holds: along each dim, the contiguous equal block of its
    index on the dim's mesh axes; a dim whose entry is None, or that the
    spec does not reach, whole. Raises ``ValueError`` where a dim does not
    divide its axes' span or the spec is longer than the shape."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    out = []
    for dim, size in enumerate(shape):
        axes = entry_axes(spec[dim]) if dim < len(spec) else ()
        n = axes_span(axes, axis_sizes)
        if size % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} ({size}) does not "
                             f"divide over {axes} ({n} ranks)")
        b = size // n
        i = axes_index(axes, axis_sizes, coords)
        out.append(slice(i * b, (i + 1) * b))
    return tuple(out)


__all__ = ["ShardingPlan", "resolve_plan", "mesh_axis_sizes", "mesh_coords",
           "local_block",
           "entry_axes", "axes_span", "axes_index", "Spec"]
