"""Architecture registry: ``get_config(name)`` / ``get_smoke(name)``.

The dense and mixture-of-experts architectures are registered: smollm-135m,
qwen3-8b, granite-3-2b, stablelm-12b, olmoe-1b-7b and grok-1-314b. The
reference's other ids, of families not ported yet, are known by name and
raise ``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from . import (
    granite_3_2b,
    grok_1_314b,
    olmoe_1b_7b,
    qwen3_8b,
    smollm_135m,
    stablelm_12b,
)
from .base import ModelConfig

_MODULES = {
    "qwen3-8b": qwen3_8b,
    "granite-3-2b": granite_3_2b,
    "stablelm-12b": stablelm_12b,
    "smollm-135m": smollm_135m,
    "olmoe-1b-7b": olmoe_1b_7b,
    "grok-1-314b": grok_1_314b,
}

# The reference's other architectures, with what they wait for.
NOT_PORTED = {
    "whisper-base": "A18c (other families: encdec)",
    "zamba2-2.7b": "A18c (other families: hybrid)",
    "rwkv6-1.6b": "A18c (other families: ssm)",
    "llama-3.2-vision-90b": "A18c (other families: vlm)",
}

ARCH_NAMES = tuple(_MODULES)


def _module(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet: ROADMAP {NOT_PORTED[name]}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCH_NAMES}")
    return _MODULES[name]


def get_config(name: str) -> ModelConfig:
    return _module(name).config()


def get_smoke(name: str) -> ModelConfig:
    return _module(name).smoke()


__all__ = ["ARCH_NAMES", "NOT_PORTED", "ModelConfig", "get_config",
           "get_smoke"]
