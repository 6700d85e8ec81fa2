"""AdamW with precision policies and the LR schedule.

The port of ``repro/train/optimizer.py``, written on tensors rather than
with ``torch.optim.AdamW``, whose clipping, schedule, decay mask and bf16
casts differ from the reference's. The state mirrors the parameters: one
``mu`` and one ``nu`` tensor per parameter name (``blocks.<l>.<path>``, the
names of the port's ``Model``), and the step count. ``state_dtype`` is the
reference's scale lever: f32 moments, or bf16 moments ("fully bf16 Adam")
for the >= 90B policy.

:func:`opt_update` updates the parameters and moments in place (the
reference returns new trees); it returns them all the same, with the
metrics. The scalars of a step (learning rate, bias corrections) are
computed on the host, so the same step gives the same scalars on every
device.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
from typing import Dict, Iterable, Mapping, NamedTuple, Tuple

import numpy as np
import torch

from ..models.weights import reference_path

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    state_dtype: str = "float32"      # float32 | bfloat16


class OptState(NamedTuple):
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    step: int


def state_dtype(oc: OptConfig) -> torch.dtype:
    if oc.state_dtype not in _DTYPES:
        raise ValueError(f"state_dtype {oc.state_dtype!r} is not one of "
                         f"{tuple(_DTYPES)}")
    return _DTYPES[oc.state_dtype]


def opt_init(params: Mapping[str, torch.Tensor], oc: OptConfig) -> OptState:
    """Zero moments in the state dtype, beside each parameter; step 0."""
    dt = state_dtype(oc)
    return OptState(
        mu={n: torch.zeros(p.shape, dtype=dt, device=p.device)
            for n, p in params.items()},
        nu={n: torch.zeros(p.shape, dtype=dt, device=p.device)
            for n, p in params.items()},
        step=0)


_LIBM = None


def _libm():
    global _LIBM
    if _LIBM is None:
        lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
        for fn, nargs in (("cosf", 1), ("fmaf", 3)):
            getattr(lib, fn).argtypes = [ctypes.c_float] * nargs
            getattr(lib, fn).restype = ctypes.c_float
        _LIBM = lib
    return _LIBM


def lr_at(oc: OptConfig, step: int) -> np.float32:
    """Linear warmup + cosine decay to ``min_lr_ratio``, in float32.

    The arithmetic is the reference's as XLA compiles it on the CPU, so
    the values are equal bit for bit: a division by a constant is a
    product with its float32 reciprocal, ``0.5 * (1 - min_lr_ratio)`` is
    folded into one constant, the scale is one fused multiply-add, and the
    cosine is the C library's ``cosf``.
    """
    f32 = np.float32
    libm = _libm()
    s = f32(step)
    warm = min(f32((s + f32(1.0)) * (f32(1.0) / f32(max(1, oc.warmup_steps)))),
               f32(1.0))
    span = f32(1.0) / f32(max(1, oc.total_steps - oc.warmup_steps))
    prog = min(f32(1.0), max(f32(0.0), f32((s - f32(oc.warmup_steps)) * span)))
    cos = f32(libm.cosf(float(f32(prog * f32(np.pi)))))
    half = f32(f32(1.0 - oc.min_lr_ratio) * f32(0.5))
    scale = f32(libm.fmaf(float(f32(cos + f32(1.0))), float(half),
                          float(f32(oc.min_lr_ratio))))
    return f32(f32(warm * f32(oc.lr)) * scale)


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    total = None
    for x in tensors:
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    norm = global_norm(grads.values())
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {n: (g.float() * scale).to(g.dtype) for n, g in grads.items()}, norm


def reference_leaf_name(name: str) -> str:
    """``str`` of the last key of the reference's leaf path for the port
    parameter ``name``: ``"['wq']"`` for ``blocks.3.attn.wq``."""
    path, _ = reference_path(name)
    return f"[{path[-1]!r}]"


def _decay_mask(name: str) -> bool:
    """Weight decay only on matrices (skip norms, biases and scalars).

    The reference tests substrings of ``str(path[-1])`` of its own leaf
    path, so the port tests the same string, the reference's leaf name,
    and never the torch attribute name.
    """
    leaf = reference_leaf_name(name)
    return not any(k in leaf for k in ("ln", "norm", "bias", "u", "w0",
                                       "mix", "gate", "A_log", "D",
                                       "dt_bias"))


def _as(x: float, dt: torch.dtype) -> float:
    """The Python float of ``x`` rounded to ``dt``: the reference casts
    each scalar to the compute dtype before it meets a tensor."""
    return float(torch.tensor(x, dtype=torch.float32).to(dt))


def opt_update(grads: Mapping[str, torch.Tensor], state: OptState,
               params: Mapping[str, torch.Tensor], oc: OptConfig):
    """One AdamW step. Returns (params, state, metrics).

    The parameters and moments are written in place. The moment math runs
    in the state dtype: f32 for the standard policy, bf16 for the >= 90B
    policy, as the reference's (the scalar (1 - beta) products are exact
    in f32 and only the leaf-wide tensors round).
    """
    grads, gnorm = clip_by_global_norm(grads, oc.grad_clip)
    step = state.step + 1
    lr = lr_at(oc, step)
    f32 = np.float32
    c1 = f32(1.0) - f32(oc.b1) ** f32(step)
    c2 = f32(1.0) - f32(oc.b2) ** f32(step)
    sdt = state_dtype(oc)
    cdt = sdt if sdt == torch.bfloat16 else torch.float32
    b1, b2 = _as(oc.b1, cdt), _as(oc.b2, cdt)
    nb1, nb2 = _as(1 - oc.b1, cdt), _as(1 - oc.b2, cdt)
    c1c, c2c, eps = _as(c1, cdt), _as(c2, cdt), _as(oc.eps, cdt)
    wd, lrc = _as(oc.weight_decay, cdt), _as(lr, cdt)
    with torch.no_grad():
        for name, p in params.items():
            gc = grads[name].to(cdt)
            mu_n = state.mu[name].to(cdt) * b1 + gc * nb1
            nu_n = state.nu[name].to(cdt) * b2 + torch.square(gc) * nb2
            upd = (mu_n / c1c) / (torch.sqrt(nu_n / c2c) + eps)
            if oc.weight_decay and _decay_mask(name):
                upd = upd + wd * p.to(cdt)
            p.copy_((p.to(cdt) - lrc * upd).to(p.dtype))
            state.mu[name].copy_(mu_n.to(sdt))
            state.nu[name].copy_(nu_n.to(sdt))
    metrics = {"grad_norm": gnorm,
               "lr": torch.tensor(lr, dtype=torch.float32)}
    return params, OptState(mu=state.mu, nu=state.nu, step=step), metrics


__all__ = ["OptConfig", "OptState", "opt_init", "opt_update", "lr_at",
           "clip_by_global_norm", "global_norm", "state_dtype",
           "reference_leaf_name"]
