"""Architecture registry: ``get_config(name)`` / ``get_smoke(name)``.

Only the architectures whose family the port runs are registered. The
reference's other ids are known by name and raise ``NotImplementedError``
naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from . import smollm_135m
from .base import ModelConfig

_MODULES = {"smollm-135m": smollm_135m}

# The reference's other architectures, with what they wait for.
NOT_PORTED = {
    "qwen3-8b": "A18 (dense configs other than smollm-135m)",
    "granite-3-2b": "A18 (dense configs other than smollm-135m)",
    "stablelm-12b": "A18 (dense configs other than smollm-135m)",
    "olmoe-1b-7b": "A18 (MoE)",
    "grok-1-314b": "A18 (MoE)",
    "whisper-base": "A18 (other families: encdec)",
    "zamba2-2.7b": "A18 (other families: hybrid)",
    "rwkv6-1.6b": "A18 (other families: ssm)",
    "llama-3.2-vision-90b": "A18 (other families: vlm)",
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
