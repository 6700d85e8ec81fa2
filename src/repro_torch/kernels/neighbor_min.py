"""Masked neighbour-min and same-label count over ELL adjacencies.

Wrappers of the hand-written CUDA kernels in ``csrc/neighbor_min.cu``, the
port of the Pallas TPU kernels in ``repro/kernels/neighbor_min.py``:

* :func:`neighbor_min_ell_batch` (B1) — per graph ``b`` and row ``r``, the
  min of ``ranks[b, id]`` over neighbour ids whose ``active[b, id]`` is set,
  ``INT32_MAX`` if none. The MIS round loop of the batch engine calls it
  twice a round and once more for the PIVOT capture.
* :func:`label_agree_ell_batch` (B2) — per ``(b, r)``, how many neighbours
  carry row ``r``'s label. Summed per graph this is ``2·intra_pos`` of the
  disagreement cost pass.
* :func:`neighbor_min_ell` (B3) — B1 for one graph, ``(n, W)``; the
  per-graph engine's round loop. It launches the B1 kernel with ``B = 1``
  and keeps its own launch count.

Contract (the reference's pad layout): ``ell`` is int32 with pad id ``R``;
the state rows have width ``S = R + 1`` and slot ``R`` is the pad slot
(rank ``INT32_MAX``, ``active`` False, label ``-1``). ``active`` is bool.

The tensor's device alone picks the implementation: a CUDA tensor launches
the kernel (or the call raises), a CPU tensor takes the plain version in
:mod:`.ref`. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import ref as _ref

INF = _ref.INF_I32

# Launches per kernel: each wrapper adds one where it launches its kernel
# and nowhere else. Read and reset by callers that need to show the main
# path went through the kernels.
launches: Dict[str, int] = {
    "neighbor_min_ell_batch": 0,
    "label_agree_ell_batch": 0,
    "neighbor_min_ell": 0,
}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from . import _build

        lib = _build.load("neighbor_min")
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.nm_neighbor_min.argtypes = [vp, vp, vp, vp, i64, i32, i32, i32,
                                        i32, vp]
        lib.nm_neighbor_min.restype = i32
        lib.nm_label_agree.argtypes = [vp, vp, vp, i64, i32, i32, i32, i32, vp]
        lib.nm_label_agree.restype = i32
        lib.nm_error_string.argtypes = [i32]
        lib.nm_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(name: str, ell: torch.Tensor, batched: bool, **state):
    """Validate shapes, dtypes and devices; returns ``(B, R, W)``."""
    want = 3 if batched else 2
    if ell.dim() != want or ell.dtype != torch.int32:
        raise ValueError(f"{name}: ell must be a {want}-D int32 tensor, got "
                         f"{ell.dim()}-D {ell.dtype}")
    B = ell.shape[0] if batched else 1
    R, W = ell.shape[-2], ell.shape[-1]
    shape = (B, R + 1) if batched else (R + 1,)
    for key, (t, dtype) in state.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} must be {dtype} of shape {shape}"
                             f", got {t.dtype} of shape {tuple(t.shape)}")
        if t.device != ell.device:
            raise ValueError(f"{name}: {key} is on {t.device}, ell on "
                             f"{ell.device}")
    if ell.device.type == "cuda":
        for key, t in [("ell", ell)] + [(k, v[0]) for k, v in state.items()]:
            if not t.is_contiguous():
                raise ValueError(f"{name}: {key} must be contiguous")
    elif ell.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {ell.device}")
    return B, R, W


def _raise_on(code: int, name: str) -> None:
    if code != 0:
        msg = _lib().nm_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA kernel launch failed ({code}: {msg})")


def _device_and_stream(t: torch.Tensor):
    """The tensor's device index and PyTorch's current stream on it."""
    index = t.device.index
    if index is None:
        index = torch.cuda.current_device()
    return index, torch.cuda.current_stream(index).cuda_stream


def _launch_neighbor_min(ell, ranks_p, active_p, B, R, W, name):
    out = torch.empty((B, R), dtype=torch.int32, device=ell.device)
    code = _lib().nm_neighbor_min(
        ell.data_ptr(), ranks_p.data_ptr(), active_p.data_ptr(),
        out.data_ptr(), B, R, W, R + 1, *_device_and_stream(ell))
    _raise_on(code, name)
    launches[name] += 1
    return out


def neighbor_min_ell_batch(ell: torch.Tensor, ranks_p: torch.Tensor,
                           active_p: torch.Tensor) -> torch.Tensor:
    """(B, R) int32 masked neighbour-min of a bucket (kernel B1).

    ``ell`` (B, R, W) int32, ``ranks_p`` (B, R+1) int32, ``active_p``
    (B, R+1) bool.
    """
    B, R, W = _check("neighbor_min_ell_batch", ell, True,
                     ranks_p=(ranks_p, torch.int32),
                     active_p=(active_p, torch.bool))
    if ell.device.type == "cpu":
        return _ref.neighbor_min_ref(ell, ranks_p, active_p)
    return _launch_neighbor_min(ell, ranks_p, active_p, B, R, W,
                                "neighbor_min_ell_batch")


def neighbor_min_ell(ell: torch.Tensor, ranks_p: torch.Tensor,
                     active_p: torch.Tensor) -> torch.Tensor:
    """(n,) int32 masked neighbour-min of one graph (kernel B3).

    ``ell`` (n, W) int32, ``ranks_p`` (n+1,) int32, ``active_p`` (n+1,)
    bool (see :func:`pad_state`).
    """
    _, R, W = _check("neighbor_min_ell", ell, False,
                     ranks_p=(ranks_p, torch.int32),
                     active_p=(active_p, torch.bool))
    if ell.device.type == "cpu":
        return _ref.neighbor_min_ref(ell, ranks_p, active_p)
    return _launch_neighbor_min(ell, ranks_p, active_p, 1, R, W,
                                "neighbor_min_ell")[0]


def label_agree_ell_batch(ell: torch.Tensor,
                          labels_p: torch.Tensor) -> torch.Tensor:
    """(B, R) int32 same-label neighbour counts of a bucket (kernel B2).

    ``ell`` (B, R, W) int32, ``labels_p`` (B, R+1) int32 with slot R = -1.
    """
    B, R, W = _check("label_agree_ell_batch", ell, True,
                     labels_p=(labels_p, torch.int32))
    if ell.device.type == "cpu":
        return _ref.label_agree_ref(ell, labels_p)
    out = torch.empty((B, R), dtype=torch.int32, device=ell.device)
    code = _lib().nm_label_agree(ell.data_ptr(), labels_p.data_ptr(),
                                 out.data_ptr(), B, R, W, R + 1,
                                 *_device_and_stream(ell))
    _raise_on(code, "label_agree_ell_batch")
    launches["label_agree_ell_batch"] += 1
    return out


def pad_state(ranks: torch.Tensor, active: torch.Tensor):
    """Append the INF/inactive pad slot that ELL pad entries point at."""
    ranks_p = torch.cat([ranks.to(torch.int32),
                         ranks.new_full((1,), INF, dtype=torch.int32)])
    active_p = torch.cat([active.to(torch.bool),
                          active.new_zeros((1,), dtype=torch.bool)])
    return ranks_p, active_p


def ell_from_graph(g) -> torch.Tensor:
    """The (n, W) int32 ELL neighbour table of a graph, pad id ``n``.

    ``W`` is the max degree (at least 1), so every neighbour has a slot.
    """
    n = g.n
    width = max(1, g.max_degree())
    src = g.src.long()
    slot = torch.arange(src.shape[0], device=src.device) \
        - g.row_offsets.long()[src.clamp(max=n)]
    ell = torch.full((n + 1, width), n, dtype=torch.int32, device=src.device)
    valid = (src < n) & (slot < width)
    rows = torch.where(valid, src, torch.full_like(src, n))
    cols = torch.where(valid, slot, torch.zeros_like(slot))
    vals = torch.where(valid, g.dst, torch.full_like(g.dst, n))
    ell[rows, cols] = vals
    return ell[:n].contiguous()


__all__ = ["neighbor_min_ell", "neighbor_min_ell_batch",
           "label_agree_ell_batch", "ell_from_graph", "pad_state", "INF",
           "launches", "reset_launch_counts"]
