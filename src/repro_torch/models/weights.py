"""Carry the reference's params tree and train state to and from the port.

The reference keeps its weights as a nested dict with the layers stacked
along a leading axis (``params["blocks"]["attn"]["wq"]`` is ``(L, d,
H·hd)``); the port keeps one module per layer. A port parameter named
``blocks.<l>.<path>`` is the slice ``l`` of the reference leaf
``blocks/<path>``; every other name is the leaf of the same path. Both
sides use the ``x @ W`` orientation ``(d_in, d_out)``, so nothing is
transposed, and a tied model has no ``lm_head`` leaf on either side (the
head is ``embed.T``).

The tree is given as numpy arrays (``np.asarray`` of each jax leaf), so
this module needs neither jax nor the reference package.

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
from .model import Model, build_model
from .transformer import RunConfig

# Key prefixes of the reference's TrainState leaves, by the port's part.
STATE_PREFIXES = {"params": ".params", "mu": ".opt/.mu", "nu": ".opt/.nu",
                  "err": ".err"}
STEP_KEY = ".opt/.step"


def reference_path(name: str) -> Tuple[Tuple[str, ...], Optional[int]]:
    """The reference leaf path of a port parameter name, and its layer
    (None outside the stacked blocks)."""
    parts = tuple(name.split("."))
    if parts[0] == "blocks":
        return ("blocks",) + parts[2:], int(parts[1])
    return parts, None


def stacked_shapes(model: Model) -> Dict[Tuple[str, ...], Tuple[int, ...]]:
    """Shape of every reference leaf, as the port's parameters give it."""
    shapes: Dict[Tuple[str, ...], Tuple[int, ...]] = {}
    counts: Dict[Tuple[str, ...], int] = {}
    for name, p in model.named_parameters():
        path, layer = reference_path(name)
        if layer is None:
            shapes[path] = tuple(p.shape)
        else:
            counts[path] = counts.get(path, 0) + 1
            shapes[path] = (counts[path],) + tuple(p.shape)
    return shapes


def _leaf(tree: Mapping, path: Tuple[str, ...]) -> np.ndarray:
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


def _count_leaves(tree) -> int:
    if isinstance(tree, Mapping):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


def from_reference_params(cfg: ModelConfig, params: Mapping,
                          device: DeviceLike = None,
                          dtype: torch.dtype = torch.float32,
                          rc: Optional[RunConfig] = None) -> Model:
    """A port model on ``device`` holding the reference tree ``params``
    (built on ``meta`` first, so no weights are drawn); raises on a leaf
    missing from either side or a shape that does not match."""
    model = build_model(cfg, device="meta", dtype=dtype, rc=rc)
    model = model.to_empty(device=resolve_device(device))
    n_leaf = 0
    with torch.no_grad():
        for name, p in model.named_parameters():
            path, layer = reference_path(name)
            value = _leaf(params, path)
            if layer is not None:
                value = value[layer]
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"{name}: reference leaf {'/'.join(path)} "
                                 f"has shape {value.shape}, the port "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(value)))
            n_leaf += layer is None or layer == 0
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
    """Reference leaf path → the port names of its layers, in order."""
    leaves: Dict[Tuple[str, ...], list] = {}
    for name in names:
        path, layer = reference_path(name)
        leaves.setdefault(path, []).append((layer, name))
    return {path: [n for _, n in sorted(v, key=lambda x: x[0] or 0)]
            for path, v in leaves.items()}


def stacked_arrays(prefix: str, tensors: Mapping[str, torch.Tensor]
                   ) -> Dict[str, np.ndarray]:
    """Per-layer port tensors as the reference's stacked leaves, keyed as
    its checkpoint keys them."""
    out = {}
    for path, names in _reference_leaves(tensors).items():
        arrs = [to_numpy(tensors[n]) for n in names]
        layered = reference_path(names[0])[1] is not None
        out[reference_key(prefix, path)] = np.stack(arrs) if layered \
            else arrs[0]
    return out


def load_stacked(prefix: str, arrays: Mapping[str, np.ndarray],
                 tensors: Mapping[str, torch.Tensor]) -> None:
    """Copy the reference leaves ``arrays`` (keyed as in its checkpoint)
    into the port tensors ``tensors``, in place; raises on a missing key
    or a shape that does not match."""
    with torch.no_grad():
        for path, names in _reference_leaves(tensors).items():
            key = reference_key(prefix, path)
            if key not in arrays:
                raise KeyError(f"checkpoint missing leaf {key}")
            value = arrays[key]
            for name in names:
                t = tensors[name]
                layer = reference_path(name)[1]
                part = value if layer is None else value[layer]
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
                            err: Optional[Mapping[str, torch.Tensor]] = None
                            ) -> int:
    """Copy a reference train state (flat leaves) into the port tensors in
    place; returns its step."""
    load_stacked(STATE_PREFIXES["params"], arrays, params)
    load_stacked(STATE_PREFIXES["mu"], arrays, mu)
    load_stacked(STATE_PREFIXES["nu"], arrays, nu)
    if err is not None:
        load_stacked(STATE_PREFIXES["err"], arrays, err)
    if STEP_KEY not in arrays:
        raise KeyError(f"checkpoint missing leaf {STEP_KEY}")
    return int(arrays[STEP_KEY])


__all__ = ["reference_path", "stacked_shapes", "from_reference_params",
           "reference_key", "to_numpy", "from_numpy", "stacked_arrays",
           "load_stacked", "train_state_arrays", "train_state_keys",
           "load_train_state_arrays",
           "STATE_PREFIXES", "STEP_KEY"]
