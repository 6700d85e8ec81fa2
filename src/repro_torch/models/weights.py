"""Carry the reference's params tree and train state to and from the port.

The reference keeps its weights as a nested dict with the layers stacked
along leading axes (``params["blocks"]["attn"]["wq"]`` is ``(L, d,
H·hd)``); the port keeps one module per layer. A port parameter named
``<stack>.<l>.<path>`` is the slice ``l`` of the reference leaf
``<stack>/<path>`` for the singly stacked ``blocks``, ``encoder`` and
``cross_layers``, and ``<stack>.<g>.<j>.<path>`` the slice ``[g, j]`` for
the grouped ``mamba_groups`` ((G, k, ...)) and ``self_groups``
((G, k−1, ...)); every other name (``embed``, ``ln_f``, ``lm_head``,
``enc_ln_f``, the hybrid's ``shared_attn``) is the leaf of the same path.
Both sides use the ``x @ W`` orientation ``(d_in, d_out)``, so nothing is
transposed, and a tied model has no ``lm_head`` leaf on either side (the
head is ``embed.T``). An MoE block's leaves are ``blocks/moe/router``
(``(L, d, E)``, f32 whatever the model's dtype, as in the reference) and
``blocks/moe/{wi,wg,wo}`` (``(L, E, d, ff)``, ``(L, E, ff, d)``) where a
dense block has ``blocks/mlp``.

The tree is given as numpy arrays (``np.asarray`` of each jax leaf), so
this module needs neither jax nor the reference package. On a mesh,
:func:`shard_params` cuts a whole tree to one rank's blocks (each
reference leaf's spec is its port weights' with ``None`` for the stacked
axes, :func:`reference_specs`), ``from_reference_params(plan=, mesh=)``
loads them into a sharded model, and :func:`gather_params` gives the
whole tree back from a sharded model.

A whole train state crosses as the flat mapping the reference's checkpoint
writes (``train/checkpoint.py``): each leaf keyed by the ``str`` of its
tree path joined with ``/``, as ``jax.tree_util.tree_flatten_with_path``
gives it for ``TrainState(params, OptState(mu, nu, step), err)``:
``.params/['blocks']/['attn']/['wq']`` (stacked over layers),
``.opt/.mu/...``, ``.opt/.nu/...``, ``.opt/.step`` and, with compression,
``.err/...``. bf16 arrays cross as raw 2-byte words (numpy has no bf16; the
reference's ``np.savez`` writes them as ``|V2`` too).
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..util import DeviceLike, resolve_device
from .common import attach_axes
from .model import Model, build_model
from .sharding import (ShardingPlan, local_block, mesh_axis_sizes,
                       mesh_coords)
from .transformer import RunConfig

# Key prefixes of the reference's TrainState leaves, by the port's part.
STATE_PREFIXES = {"params": ".params", "mu": ".opt/.mu", "nu": ".opt/.nu",
                  "err": ".err"}
STEP_KEY = ".opt/.step"


# Stacked module lists of the port, by the number of leading axes their
# reference leaves carry.
STACKED = {"blocks": 1, "encoder": 1, "cross_layers": 1, "mamba_groups": 2,
           "self_groups": 2}

Index = Tuple[int, ...]


def reference_path(name: str) -> Tuple[Tuple[str, ...], Index]:
    """The reference leaf path of a port parameter name, and its index
    along the leaf's stacked axes (``()`` outside the stacks, ``(l,)`` in
    a singly stacked list, ``(g, j)`` in a grouped one)."""
    parts = tuple(name.split("."))
    depth = STACKED.get(parts[0], 0)
    return ((parts[0],) + parts[1 + depth:],
            tuple(int(i) for i in parts[1:1 + depth]))


def _stacked_dims(indices) -> Index:
    """The stacked axes' sizes that hold every index of ``indices``."""
    return tuple(max(i[a] for i in indices) + 1
                 for a in range(len(next(iter(indices)))))


def stacked_shapes(model: Model) -> Dict[Tuple[str, ...], Tuple[int, ...]]:
    """Shape of every reference leaf, as the port's parameters give it."""
    leaves: Dict[Tuple[str, ...], list] = {}
    for name, p in model.named_parameters():
        path, idx = reference_path(name)
        leaves.setdefault(path, []).append((idx, tuple(p.shape)))
    return {path: _stacked_dims([i for i, _ in v]) + v[0][1]
            for path, v in leaves.items()}


def _leaf(tree: Mapping, path: Tuple[str, ...]) -> np.ndarray:
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


def _count_leaves(tree) -> int:
    if isinstance(tree, Mapping):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


def reference_specs(model: Model, plan: ShardingPlan
                    ) -> Dict[Tuple[str, ...], tuple]:
    """Each reference leaf's spec under ``plan``: its port weights' spec
    with ``None`` for each stacked axis, as the reference's stacked init
    prepends it."""
    out = {}
    for name, spec in model.param_specs(plan).items():
        path, idx = reference_path(name)
        out[path] = (None,) * len(idx) + spec
    return out


def _tree_set(tree: dict, path: Tuple[str, ...], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def shard_params(cfg: ModelConfig, params: Mapping, plan: ShardingPlan,
                 mesh) -> dict:
    """The rank's blocks of the whole reference tree ``params`` (numpy),
    as a tree of the same paths: each leaf cut by :func:`local_block` of
    its spec (:func:`reference_specs`) at this rank's mesh coordinates."""
    specs = reference_specs(build_model(cfg, device="meta"), plan)
    sizes, coords = mesh_axis_sizes(mesh), mesh_coords(mesh)
    out: dict = {}
    for path, spec in specs.items():
        leaf = _leaf(params, path)
        _tree_set(out, path,
                  np.array(leaf[local_block(leaf.shape, spec, sizes,
                                            coords)]))
    return out


def gather_params(model: Model) -> dict:
    """The whole reference tree (numpy, layers stacked) of a model, from
    its blocks on a mesh (an all-gather a sharded dim, on every rank) or
    from an unsharded one. bf16 leaves as ``|V2`` words."""
    layout = model.layout
    whole = {}
    for name, p in model.named_parameters():
        t = p.detach()
        if layout is not None:
            t = layout.gather_spec(t, layout.plan.P(*p.axes))
        whole[name] = t
    out: dict = {}
    for key, leaf in stacked_arrays("", whole).items():
        _tree_set(out, tuple(k[2:-2] for k in key.split("/")[1:]), leaf)
    return out


def from_reference_params(cfg: ModelConfig, params: Mapping,
                          device: DeviceLike = None,
                          dtype: torch.dtype = torch.float32,
                          rc: Optional[RunConfig] = None,
                          plan: Optional[ShardingPlan] = None,
                          mesh=None) -> Model:
    """A port model on ``device`` holding the reference tree ``params``
    (built on ``meta`` first, so no weights are drawn); raises on a leaf
    missing from either side or a shape that does not match. With
    ``plan`` and ``mesh`` the model is sharded and ``params`` must hold
    this rank's blocks (:func:`shard_params`)."""
    model = build_model(cfg, device="meta", dtype=dtype, rc=rc, plan=plan,
                        mesh=mesh)
    model = model.to_empty(device=resolve_device(device))
    attach_axes(model, model.param_axes)
    n_leaf = 0
    with torch.no_grad():
        for name, p in model.named_parameters():
            path, idx = reference_path(name)
            value = _leaf(params, path)[idx]
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"{name}: reference leaf {'/'.join(path)} "
                                 f"has shape {value.shape}, the port "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(value)))
            n_leaf += not any(idx)
    if n_leaf != _count_leaves(params):
        raise ValueError("the reference tree has leaves the port lacks")
    return model


def reference_key(prefix: str, path: Tuple[str, ...]) -> str:
    """The reference checkpoint's key of the leaf ``path`` under
    ``prefix``: each dict key as ``str(jax.tree_util.DictKey(k))``."""
    return "/".join([prefix] + [f"[{k!r}]" for k in path])


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy as numpy; bf16 as raw 2-byte words (``|V2``)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def from_numpy(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of :func:`to_numpy`, cast to ``dtype``; ``|V2`` words
    (and the ``ml_dtypes`` bf16 that jax arrays convert to) are read as
    bf16."""
    if a.dtype == np.dtype("V2") or str(a.dtype) == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(dtype)
    return torch.from_numpy(np.array(a)).to(dtype)


def _reference_leaves(names: Iterable[str]):
    """Reference leaf path → the port names of its slices, with their
    indices, in order."""
    leaves: Dict[Tuple[str, ...], list] = {}
    for name in names:
        path, idx = reference_path(name)
        leaves.setdefault(path, []).append((idx, name))
    return {path: sorted(v) for path, v in leaves.items()}


def stacked_arrays(prefix: str, tensors: Mapping[str, torch.Tensor]
                   ) -> Dict[str, np.ndarray]:
    """Per-layer port tensors as the reference's stacked leaves, keyed as
    its checkpoint keys them."""
    out = {}
    for path, slices in _reference_leaves(tensors).items():
        arrs = {idx: to_numpy(tensors[n]) for idx, n in slices}
        first = arrs[slices[0][0]]
        leaf = np.empty(_stacked_dims(arrs) + first.shape, first.dtype)
        for idx, a in arrs.items():
            leaf[idx] = a
        out[reference_key(prefix, path)] = leaf
    return out


def load_stacked(prefix: str, arrays: Mapping[str, np.ndarray],
                 tensors: Mapping[str, torch.Tensor], block=None) -> None:
    """Copy the reference leaves ``arrays`` (keyed as in its checkpoint)
    into the port tensors ``tensors``, in place; raises on a missing key
    or a shape that does not match. ``block(name, part)``, where given,
    cuts each layer's whole ``part`` to the block ``tensors[name]``
    holds."""
    with torch.no_grad():
        for path, slices in _reference_leaves(tensors).items():
            key = reference_key(prefix, path)
            if key not in arrays:
                raise KeyError(f"checkpoint missing leaf {key}")
            value = arrays[key]
            for idx, name in slices:
                t = tensors[name]
                part = value[idx]
                if block is not None:
                    part = block(name, part)
                if tuple(part.shape) != tuple(t.shape):
                    raise ValueError(f"leaf {key}: shape {value.shape} does "
                                     f"not hold {name} {tuple(t.shape)}")
                t.copy_(from_numpy(part, t.dtype))


def train_state_arrays(params: Mapping[str, torch.Tensor],
                       mu: Mapping[str, torch.Tensor],
                       nu: Mapping[str, torch.Tensor], step: int,
                       err: Optional[Mapping[str, torch.Tensor]] = None
                       ) -> Dict[str, np.ndarray]:
    """A port train state as the reference checkpoint's flat leaves."""
    out = stacked_arrays(STATE_PREFIXES["params"], params)
    out.update(stacked_arrays(STATE_PREFIXES["mu"], mu))
    out.update(stacked_arrays(STATE_PREFIXES["nu"], nu))
    out[STEP_KEY] = np.asarray(step, dtype=np.int32)
    if err is not None:
        out.update(stacked_arrays(STATE_PREFIXES["err"], err))
    return out


def train_state_keys(names: Iterable[str], err: bool = False) -> list:
    """The checkpoint keys of a train state over the parameter ``names``,
    without copying anything."""
    paths = list(_reference_leaves(names))
    parts = ("params", "mu", "nu") + (("err",) if err else ())
    return [reference_key(STATE_PREFIXES[part], path)
            for part in parts for path in paths] + [STEP_KEY]


def load_train_state_arrays(arrays: Mapping[str, np.ndarray],
                            params: Mapping[str, torch.Tensor],
                            mu: Mapping[str, torch.Tensor],
                            nu: Mapping[str, torch.Tensor],
                            err: Optional[Mapping[str, torch.Tensor]] = None,
                            block=None) -> int:
    """Copy a reference train state (flat leaves) into the port tensors in
    place; returns its step. ``block`` as in :func:`load_stacked`."""
    load_stacked(STATE_PREFIXES["params"], arrays, params, block)
    load_stacked(STATE_PREFIXES["mu"], arrays, mu, block)
    load_stacked(STATE_PREFIXES["nu"], arrays, nu, block)
    if err is not None:
        load_stacked(STATE_PREFIXES["err"], arrays, err, block)
    if STEP_KEY not in arrays:
        raise KeyError(f"checkpoint missing leaf {STEP_KEY}")
    return int(arrays[STEP_KEY])


__all__ = ["reference_path", "stacked_shapes", "from_reference_params",
           "reference_specs", "shard_params", "gather_params",
           "reference_key", "to_numpy", "from_numpy", "stacked_arrays",
           "load_stacked", "train_state_arrays", "train_state_keys",
           "load_train_state_arrays",
           "STATE_PREFIXES", "STEP_KEY", "STACKED"]
