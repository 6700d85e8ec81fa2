"""Neighbourhood agreement of the precluster method over an ELL adjacency.

Wrapper of the hand-written CUDA kernel in ``csrc/agreement.cu``, which
takes the place of the agreement pass of the reference's precluster
rounds body (``repro/core/programs.py`` ``_precluster_rounds_body``; XLA
ops there, not a Pallas kernel). :func:`agreement_ell_batch` maps a
``(B, R, W)`` int32 ELL (pad id ``R``) to the agreement graph's ELL: every
neighbour ``v`` of row ``u`` is kept where
``BETA_DEN·(du+dv−2·common−2) < BETA_NUM·(max(du, dv)+1)`` (closed
neighbourhoods differ by less than β = 2/5 of the larger) and replaced by
``R`` elsewhere. Its plain version is
:func:`repro_torch.kernels.ref.agreement_ell_ref`, which builds the
``(B, R, W, W)`` candidate lists in chunks; the kernel builds none.

The tensor's device alone picks the implementation: a CUDA tensor launches
the kernel (or the call raises), a CPU tensor takes the plain version.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import torch

from . import ref as _ref
from ._build import device_and_stream

SMS = 132                   # streaming multiprocessors of an H100 SXM
WARPS = 8                   # warps a block, one row each at a time
MAX_ROWS = 1 << 15          # the bitmap of a row's ids: R bits a warp

# Launches of the kernel: the wrapper adds one where it launches it and
# nowhere else. The executors' dispatch threads launch too, so an
# increment takes the lock.
launches: Dict[str, int] = {"agreement_ell_batch": 0}
_launches_lock = threading.Lock()


def reset_launch_counts() -> None:
    launches["agreement_ell_batch"] = 0


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from . import _build

        lib = _build.load("agreement")
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ag_agreement.argtypes = [vp, vp, i64, i32, i32, i32, i32, i32,
                                     i32, vp]
        lib.ag_agreement.restype = i32
        lib.ag_error_string.argtypes = [i32]
        lib.ag_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def blocks(B: int, R: int) -> int:
    """The kernel's grid: a warp per row, eight blocks of eight warps on
    every SM at most, which stride over the rest."""
    return max(1, min(-(-(B * R) // WARPS), SMS * 8))


def agreement_ell_batch(ell: torch.Tensor) -> torch.Tensor:
    """(B, R, W) int32 agreement ELL of a bucket (pad id ``R``)."""
    if ell.dim() != 3 or ell.dtype != torch.int32:
        raise ValueError(f"agreement_ell_batch: ell must be a 3-D int32 "
                         f"tensor, got {ell.dim()}-D {ell.dtype}")
    B, R, W = ell.shape
    if ell.device.type == "cpu":
        return _ref.agreement_ell_ref(ell)
    if ell.device.type != "cuda":
        raise ValueError(f"agreement_ell_batch: unsupported device "
                         f"{ell.device}")
    if not ell.is_contiguous():
        raise ValueError("agreement_ell_batch: ell must be contiguous")
    if R > MAX_ROWS:
        raise ValueError(f"agreement_ell_batch: R = {R} above the kernel's "
                         f"{MAX_ROWS} rows")
    out = torch.empty_like(ell)
    if out.numel() == 0:
        return out
    code = _lib().ag_agreement(ell.data_ptr(), out.data_ptr(), B, R, W,
                               _ref.BETA_NUM, _ref.BETA_DEN, blocks(B, R),
                               *device_and_stream(ell))
    if code != 0:
        raise RuntimeError(f"agreement_ell_batch: CUDA kernel launch failed "
                           f"({code}: {_lib().ag_error_string(code).decode()}"
                           ")")
    with _launches_lock:
        launches["agreement_ell_batch"] += 1
    return out


__all__ = ["agreement_ell_batch", "blocks", "launches",
           "reset_launch_counts"]
