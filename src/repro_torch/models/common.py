"""Shared model building blocks: init, norms, RoPE, linears.

The port of ``repro/models/common.py``. Weights keep the reference's
``x @ W`` orientation, ``(d_in, d_out)``. The reference's sharding helpers
(``Pm``, ``split_params``, ``constrain``, ``set_matmul_reduce_dtype``) wait
for the sharded port (ROADMAP A18).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn


def weight(t: torch.Tensor) -> nn.Parameter:
    """A weight, built frozen for serving; ``train.train_step.
    init_train_state`` turns a model's weights trainable."""
    return nn.Parameter(t, requires_grad=False)


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


def head_rms_norm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the head dim (qk-norm). x (..., hd)."""
    return rms_norm(x, scale, eps)


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    """Inverse frequencies in float64 numpy, as the reference builds them."""
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half) * 2.0 / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (B, S, H, hd); positions (B, S) or (S,)."""
    half = x.shape[-1] // 2
    freqs = torch.as_tensor(rope_frequencies(x.shape[-1], theta),
                            dtype=torch.float32, device=x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs           # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with f32 accumulation, cast back to ``x.dtype``.

    bf16 operands are widened to f32 first: their products are exact in
    f32, so this is the reference's bf16 dot with an f32 accumulator.
    """
    return torch.matmul(x.float(), w.float()).to(x.dtype)


__all__ = ["weight", "dense_init", "rms_norm", "head_rms_norm",
           "rope_frequencies", "apply_rope", "linear"]
