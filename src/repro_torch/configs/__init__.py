"""Architecture registry: ``get_config(name)`` / ``get_smoke(name)``.

The reference's ten architectures, every family: smollm-135m, qwen3-8b,
granite-3-2b, stablelm-12b (dense), olmoe-1b-7b, grok-1-314b (moe),
rwkv6-1.6b (ssm), zamba2-2.7b (hybrid), whisper-base (encdec) and
llama-3.2-vision-90b (vlm). :data:`SHAPES` is the reference's grid of
four shapes, and :func:`all_cells` its 40 (arch × shape) cells.

The port also runs architectures the reference does not have
(:data:`PORT_ARCHS`: granite-4.0-h-small, of the ``hybrid_moe`` family).
``get_config`` and ``get_smoke`` build them too; they are kept out of
:data:`ARCH_NAMES` and :func:`all_cells`, which stay the reference's.
:data:`ALL_ARCH_NAMES` lists both.
"""

from __future__ import annotations

from . import (
    granite_3_2b,
    granite_4_0_h_small,
    grok_1_314b,
    llama32_vision_90b,
    olmoe_1b_7b,
    qwen3_8b,
    rwkv6_1_6b,
    smollm_135m,
    stablelm_12b,
    whisper_base,
    zamba2_2_7b,
)
from .base import SHAPES, ModelConfig, ShapeConfig, supports_shape

_MODULES = {
    "whisper-base": whisper_base,
    "qwen3-8b": qwen3_8b,
    "granite-3-2b": granite_3_2b,
    "stablelm-12b": stablelm_12b,
    "smollm-135m": smollm_135m,
    "olmoe-1b-7b": olmoe_1b_7b,
    "grok-1-314b": grok_1_314b,
    "zamba2-2.7b": zamba2_2_7b,
    "rwkv6-1.6b": rwkv6_1_6b,
    "llama-3.2-vision-90b": llama32_vision_90b,
}

# Architectures of the port alone: the reference has no such family.
_PORT_MODULES = {
    "granite-4.0-h-small": granite_4_0_h_small,
}

# The reference's architectures not ported yet, with what they wait for.
NOT_PORTED: dict = {}

ARCH_NAMES = tuple(_MODULES)
PORT_ARCHS = tuple(_PORT_MODULES)
ALL_ARCH_NAMES = ARCH_NAMES + PORT_ARCHS


def _module(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet: ROADMAP {NOT_PORTED[name]}")
    module = _MODULES.get(name) or _PORT_MODULES.get(name)
    if module is None:
        raise KeyError(f"unknown arch {name!r}; available: {ALL_ARCH_NAMES}")
    return module


def get_config(name: str) -> ModelConfig:
    return _module(name).config()


def get_smoke(name: str) -> ModelConfig:
    return _module(name).smoke()


def all_cells():
    """Every (arch, shape) cell of the grid, skipped ones included:
    ``(arch, shape name, runs, reason)`` in the reference's order."""
    cells = []
    for name in ARCH_NAMES:
        cfg = get_config(name)
        for shape in SHAPES.values():
            ok, why = supports_shape(cfg, shape)
            cells.append((name, shape.name, ok, why))
    return cells


__all__ = ["ARCH_NAMES", "PORT_ARCHS", "ALL_ARCH_NAMES", "NOT_PORTED",
           "SHAPES", "ModelConfig", "ShapeConfig", "get_config", "get_smoke",
           "supports_shape", "all_cells"]
