"""Small shared utilities: power-of-two padding and the device rule.

Kept free of the rest of the package so every layer can import it.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def next_pow2(x: int) -> int:
    """Smallest power of two >= max(1, x) (``next_pow2(0) == 1``).

    The one rounding rule for bucket rows/width and batch-axis padding, so
    the packer and its accounting can never round differently.
    """
    return 1 << max(0, int(x) - 1).bit_length()


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device rule of every public entry point.

    ``None`` means ``cuda``. Asking for CUDA on a machine without it raises:
    there is no silent CPU fallback, a caller that wants the CPU says
    ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev


__all__ = ["next_pow2", "resolve_device", "DeviceLike"]
