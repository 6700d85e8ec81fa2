"""Per-graph PIVOT of k samples in one launch (kernel B3, redesigned).

Wrapper of the hand-written CUDA kernel in ``csrc/mis_pivot.cu``, which
replaces the Pallas TPU kernel ``neighbor_min_ell`` of
``repro/kernels/neighbor_min.py`` together with the round loop around it
(``repro/core/mis.py`` ``_greedy_mis_parallel_impl``) and the PIVOT capture
(``assign_to_min_rank_mis_neighbor``): :func:`mis_pivot_csr` runs every
greedy-MIS round and the capture of all k samples of one graph in one
launch (the grid route takes 64 samples a launch, so k > 64 there makes a
launch a group of 64), and nothing comes back to the host until the labels
are final.

Contract: ``row_offsets`` int32 ``(n + 2,)`` and ``dst`` int32, the graph's
CSR as :class:`repro_torch.core.graph.Graph` holds it (sorted by src,
padded with the sentinel ``n``); ``ranks`` int32 ``(k, n)``, one
permutation of ``0..n-1`` per row; ``eligible`` bool ``(n,)``. Returns
``status`` and ``labels``, int32 ``(k, n)``, and ``rounds``, int32
``(k,)``: for each sample, bit for bit, the reference's
``greedy_mis_parallel`` (status, rounds), ``assign_to_min_rank_mis_neighbor``
on its MIS and the eligible restriction of PIVOT (ineligible vertices label
themselves).

The tensor's device alone picks the implementation: a CUDA tensor launches
the kernel (or the call raises), a CPU tensor takes the plain version
:func:`repro_torch.kernels.ref.mis_pivot_ref`. On the card every tensor is
contiguous and :func:`mis_launch_plan` picks the route from the shape.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional

import torch

from . import ref as _ref
from ._build import device_and_stream

THREADS = 1024              # threads per block, the most a block may have
SMS = 132                   # streaming multiprocessors of an H100 SXM
SMEM_BYTES_MAX = 232_448    # dynamic shared memory a block may use (sm_90)
STATE_BYTES = 5             # block route: int32 key + winner flag a vertex
MAX_GRID_SAMPLES = 64       # grid route: one bit a sample in a round flag
ROUTES = {"block": 0, "grid": 1}    # the C entry's route codes
# Measured on an H100 (PERF.md, scripts/mis_route_sweep.py): the block
# route's time grows with the vertices each of its threads walks, about
# 7 µs a 1,000 vertices, and the grid route's stays at 0.03–0.05 ms (a
# dozen grid syncs) up to n = 60,000 at k = 1; the block route wins at
# n = 5,120 and loses at 6,144 for λ = 1, 2 and 3 alike, whatever 2m.
BLOCK_MAX_N = 5_632


@dataclasses.dataclass(frozen=True)
class MisPlan:
    """Launches of ``samples`` samples each (the last may hold fewer), of
    ``blocks`` blocks of ``threads`` threads; the block route holds a
    sample's state in ``smem_bytes`` of shared memory, and its one launch
    has a block a sample."""

    route: str
    threads: int
    blocks: int
    smem_bytes: int
    samples: int

    def args(self):
        """The C entry's (route, threads, blocks, smem_bytes)."""
        return ROUTES[self.route], self.threads, self.blocks, self.smem_bytes


def block_plan(k: int, n: int) -> Optional[MisPlan]:
    """The block route: one launch of a block per sample with its keys and
    winner flags in shared memory, or None where they do not fit
    (n > 46,489). A thread a vertex up to 1,024 (at least a warp): fewer
    threads were 2–3 times slower (PERF.md)."""
    smem = STATE_BYTES * n
    if smem > SMEM_BYTES_MAX:
        return None
    threads = min(THREADS, max(32, -(-n // 32) * 32))
    return MisPlan("block", threads, k, smem, k)


def grid_plan(k: int, n: int) -> MisPlan:
    """The grid route: a cooperative launch of 1,024-thread blocks for each
    group of up to 64 samples (the round flag holds a bit a sample), one
    block a (sample, vertex) item of a group up to one block an SM."""
    samples = min(k, MAX_GRID_SAMPLES)
    blocks = max(1, min(SMS, -(-(samples * n) // THREADS)))
    return MisPlan("grid", THREADS, blocks, 0, samples)


def mis_launch_plan(k: int, n: int) -> MisPlan:
    """The plan for ``k`` samples of a graph with ``n`` vertices, from the
    shape alone: the block route up to ``BLOCK_MAX_N`` vertices, the grid
    route above."""
    return block_plan(k, n) if n <= BLOCK_MAX_N else grid_plan(k, n)


# Launches of the kernel: the wrapper adds one where it launches it and
# nowhere else.
launches: Dict[str, int] = {"mis_pivot": 0}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from . import _build

        lib = _build.load("mis_pivot")
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mp_mis_pivot.argtypes = [vp] * 10 + [i32] * 7 + [vp]
        lib.mp_mis_pivot.restype = i32
        lib.mp_error_string.argtypes = [i32]
        lib.mp_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(row_offsets, dst, ranks, eligible):
    """Validate dtypes, shapes, devices and contiguity; returns (k, n)."""
    if ranks.dim() != 2 or ranks.dtype != torch.int32:
        raise ValueError(f"mis_pivot: ranks must be a (k, n) int32 tensor, "
                         f"got {ranks.dim()}-D {ranks.dtype}")
    k, n = ranks.shape
    if k < 1:
        raise ValueError("mis_pivot: ranks has no sample")
    want = {"row_offsets": (row_offsets, torch.int32, (n + 2,)),
            "dst": (dst, torch.int32, None),
            "eligible": (eligible, torch.bool, (n,))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or t.dim() != 1 or (
                shape is not None and tuple(t.shape) != shape):
            raise ValueError(f"mis_pivot: {name} must be 1-D {dtype}"
                             + (f" of shape {shape}" if shape else "")
                             + f", got {t.dtype} of shape {tuple(t.shape)}")
        if t.device != ranks.device:
            raise ValueError(f"mis_pivot: {name} is on {t.device}, ranks on "
                             f"{ranks.device}")
    if ranks.device.type == "cuda":
        for name, t in (("ranks", ranks), ("row_offsets", row_offsets),
                        ("dst", dst), ("eligible", eligible)):
            if not t.is_contiguous():
                raise ValueError(f"mis_pivot: {name} must be contiguous")
    elif ranks.device.type != "cpu":
        raise ValueError(f"mis_pivot: unsupported device {ranks.device}")
    return k, n


def mis_pivot_csr(row_offsets: torch.Tensor, dst: torch.Tensor,
                  ranks: torch.Tensor, eligible: torch.Tensor,
                  plan: Optional[MisPlan] = None):
    """(status, labels, rounds) of k PIVOT samples of one graph (see the
    module docstring). ``plan`` forces a launch plan (the sweep and the
    card tests); by default :func:`mis_launch_plan` picks it."""
    k, n = _check(row_offsets, dst, ranks, eligible)
    if ranks.device.type == "cpu":
        return _ref.mis_pivot_ref(row_offsets, dst, ranks, eligible)
    if plan is None:
        plan = mis_launch_plan(k, n)
    dev = ranks.device
    status = torch.empty((k, n), dtype=torch.int32, device=dev)
    labels = torch.empty((k, n), dtype=torch.int32, device=dev)
    rounds = torch.empty((k,), dtype=torch.int32, device=dev)
    scratch = [None] * 3
    if plan.route == "grid":
        scratch = [torch.empty((plan.samples * n,), dtype=torch.int32,
                               device=dev),
                   torch.empty((plan.samples * n,), dtype=torch.uint8,
                               device=dev),
                   torch.empty((2,), dtype=torch.int64, device=dev)]
    # One launch a group of plan.samples samples; the groups' launches go
    # one after another on the stream and share the scratch.
    for s0 in range(0, k, plan.samples):
        s1 = min(k, s0 + plan.samples)
        code = _lib().mp_mis_pivot(
            row_offsets.data_ptr(), dst.data_ptr(), ranks[s0:s1].data_ptr(),
            eligible.data_ptr(), status[s0:s1].data_ptr(),
            labels[s0:s1].data_ptr(), rounds[s0:s1].data_ptr(),
            *(t if t is None else t.data_ptr() for t in scratch),
            s1 - s0, n, *plan.args(), *device_and_stream(ranks))
        if code != 0:
            msg = _lib().mp_error_string(code).decode()
            raise RuntimeError(f"mis_pivot: CUDA kernel launch failed ({code}:"
                               f" {msg}) with {plan}")
        launches["mis_pivot"] += 1
    return status, labels, rounds


__all__ = ["mis_pivot_csr", "mis_launch_plan", "block_plan", "grid_plan",
           "MisPlan", "launches", "reset_launch_counts"]
