"""Carry the reference's params tree into a port :class:`Model`.

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
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..util import DeviceLike, resolve_device
from .model import Model, build_model


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
                          dtype: torch.dtype = torch.float32) -> Model:
    """A port model on ``device`` holding the reference tree ``params``
    (built on ``meta`` first, so no weights are drawn); raises on a leaf
    missing from either side or a shape that does not match."""
    model = build_model(cfg, device="meta", dtype=dtype)
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


__all__ = ["reference_path", "stacked_shapes", "from_reference_params"]
