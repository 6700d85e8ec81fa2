"""Blocked (flash) attention forward with GQA and a causal mask (kernel B4).

Wrapper of the hand-written CUDA kernel in ``csrc/flash_attention.cu``, the
port of the Pallas TPU kernel ``repro/kernels/flash_attention.py`` and of
its padding wrapper ``repro/kernels/ops.py:flash_attention``.

:func:`flash_attention` takes the reference's layout: q ``(B, H, Sq, D)``,
k and v ``(B, KH, Sk, D)`` with ``H % KH == 0`` (query head ``h`` reads KV
head ``h // (H // KH)``), scale ``1/sqrt(D)``, causal rows offset by
``Sk - Sq``. Inputs are f32 or bf16 and the output has the input's dtype.
The kernel multiplies on the tensor cores with f32 accumulation: f32
inputs as three TF32 products (hi*hi + hi*lo + lo*hi, within ~1e-6 of
f32), bf16 inputs as bf16 products, for which the softmax weights P (f32)
are split into a bf16 hi and lo before P @ V, so that P @ V keeps f32
precision as in the reference. The softmax itself is f32. The kernel masks ragged ``Sq`` and ``Sk``
itself, so no shape is padded on the host and none goes to another path;
the reference's ragged non-causal fallback to its oracle is gone.

The kernel copies K/V tiles with 16-byte ``cp.async``: contiguity puts
every row of q, k, v a multiple of 32 bytes (``D >= 16``) after the
tensor's first element, and a tensor whose first element is not 16-byte
aligned (a view at an odd offset) is copied first, so that every launch is
aligned.

Inputs the wrapper refuses on every device: ``Sk == 0``, and causal with
``Sk < Sq``, where the first rows see no key at all (the reference's
kernel and its oracle disagree there, and prefill never asks for it). On
the card it also refuses a head dim ``D`` that has no kernel instance
(:data:`HEAD_DIMS`); the plain version takes any ``D``, as the
reference's kernel does.

The tensor's device alone picks the implementation: a CUDA tensor launches
the kernel (or the call raises), a CPU tensor takes the plain version
:func:`repro_torch.kernels.ref.attention_ref`, and a meta tensor (the dry
run, ``launch/dryrun.py``) takes the meta form: the card's checks, then an
empty output of q's shape, counted in :data:`meta_launches` (the launches
the card would make), never in :data:`launches`, which counts the kernel's
real launches only.

The kernel has no backward, as the reference's Pallas kernel has none (no
``custom_vjp``): its output, written through ``ctypes``, carries no
``grad_fn``. So a CUDA call under grad mode with any of q, k, v requiring
grad raises (:func:`refuses_grad`) instead of returning an output that
would silently stop the gradient; training takes ``attn_impl="chunked"``
(``repro_torch.models.attention``), as the reference's ``launch/train.py`` does. The
CPU's plain version is differentiable and unchanged.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import _build
from . import ref as _ref

# Head dims with a kernel instance in csrc/flash_attention.cu.
HEAD_DIMS = (16, 32, 64, 80, 128, 160)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of the kernel: the wrapper adds one where it launches it and
# nowhere else. Read and reset by callers that show a path went through it.
launches: Dict[str, int] = {"flash_attention": 0}
# The same launches split by kernel instance and mask, keyed ("float32" or
# "bfloat16", head dim, causal), so a caller can tell which instances a
# path ran, causal or not.
instance_launches: Dict[Tuple[str, int, bool], int] = {}
# Calls on the meta device: the launches the card would make on that
# path, kept apart from the real ones.
meta_launches: Dict[str, int] = {"flash_attention": 0}


def reset_launch_counts() -> None:
    launches["flash_attention"] = 0
    instance_launches.clear()
    meta_launches["flash_attention"] = 0


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_attention")
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.fa_forward.argtypes = [vp, vp, vp, vp] + [i32] * 9 + [vp]
        lib.fa_forward.restype = i32
        lib.fa_smem_bytes.argtypes = [i32, i32]
        lib.fa_smem_bytes.restype = i32
        lib.fa_error_string.argtypes = [i32]
        lib.fa_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool):
    """Validate the inputs; returns ``(B, H, KH, Sq, Sk, D)``."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-D (B, H, S, D)")
    B, H, Sq, D = q.shape
    Bk, KH, Sk, Dk = k.shape
    if Bk != B or Dk != D or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if KH == 0 or H % KH:
        raise ValueError(f"flash_attention: {H} query heads are not a "
                         f"multiple of {KH} KV heads")
    if Sk == 0:
        raise ValueError("flash_attention: no keys (Sk == 0)")
    if causal and Sk < Sq:
        raise ValueError(f"flash_attention: causal with Sk = {Sk} < Sq = "
                         f"{Sq} leaves the first rows without a key")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must share one dtype of "
                         f"{tuple(_DTYPES)}, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: q on {q.device}, k on {k.device},"
                         f" v on {v.device}")
    if q.device.type in ("cuda", "meta"):
        if D not in HEAD_DIMS:
            raise ValueError(f"flash_attention: head dim {D} has no kernel "
                             f"instance on the card; built: {HEAD_DIMS}")
        for name, t in (("q", q), ("k", k), ("v", v)):
            if not t.is_contiguous():
                raise ValueError(f"flash_attention: {name} must be contiguous")
    elif q.device.type != "cpu":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return B, H, KH, Sq, Sk, D


def refuses_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether a call on these inputs would need B4's gradient: grad mode
    is on and q, k or v requires grad. The card refuses such a call."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))


def smem_bytes(dtype: torch.dtype, head_dim: int) -> int:
    """Dynamic shared memory of one block of the kernel (two stages of K
    and V tiles), as the built library reports it."""
    return _lib().fa_smem_bytes(_DTYPES[dtype], head_dim)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Attention forward (kernel B4). q (B,H,Sq,D), k/v (B,KH,Sk,D)."""
    B, H, KH, Sq, Sk, D = _check(q, k, v, causal)
    if q.device.type == "cpu":
        return _ref.attention_ref(q, k, v, causal=causal)
    if refuses_grad(q, k, v):
        raise RuntimeError(
            "flash_attention: kernel B4 has no backward (the reference's "
            "Pallas kernel has none either), so its output would carry no "
            "gradient to q, k, v; train with attn_impl='chunked' or call "
            "it under torch.no_grad()")
    if q.device.type == "meta":
        meta_launches["flash_attention"] += 1
        return torch.empty_like(q)
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    code = _lib().fa_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, KH,
        Sq, Sk, D, int(causal), _DTYPES[q.dtype], *_build.device_and_stream(q))
    if code != 0:
        msg = _lib().fa_error_string(code).decode()
        raise RuntimeError(f"flash_attention: CUDA kernel launch failed "
                           f"({code}: {msg})")
    launches["flash_attention"] += 1
    key = (str(q.dtype).removeprefix("torch."), D, bool(causal))
    instance_launches[key] = instance_launches.get(key, 0) + 1
    return out


__all__ = ["flash_attention", "refuses_grad", "smem_bytes", "launches",
           "instance_launches", "meta_launches", "reset_launch_counts",
           "HEAD_DIMS"]
