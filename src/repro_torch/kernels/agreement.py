"""Neighbourhood agreement of the precluster method over an ELL adjacency.

Wrapper of the hand-written CUDA kernel in ``csrc/agreement.cu``, which
takes the place of the agreement pass of the reference's precluster
rounds body (``repro/core/programs.py`` ``_precluster_rounds_body``; XLA
ops there, not a Pallas kernel). :func:`agreement_ell_batch` maps a
``(B, R, W)`` int32 ELL (pad id ``R``) to the agreement graph's ELL: every
neighbour ``v`` of row ``u`` is kept where
``BETA_DEN·(du+dv−2·common−2) < BETA_NUM·(max(du, dv)+1)`` (closed
neighbourhoods differ by less than β = 2/5 of the larger) and replaced by
``R`` elsewhere. With ``replicas`` = k the batch is groups of k entries
that carry one graph, as a bucket packs a graph's best-of-k samples: each
group's graph is computed once and its result stored to the k entries.
Its plain version is :func:`repro_torch.kernels.ref.agreement_ell_ref`,
which builds the ``(B, R, W, W)`` candidate lists in chunks; the kernel
builds none.

The kernel has two routes, picked from the shape alone by
:func:`agreement_launch_plan`: ``warp`` (a warp per row, the rows of its
slots read through L2) and ``smem`` (a block per graph, its rows staged in
shared memory in ascending order, a lane per slot; ``W <= 32``). A graph
the smem route cannot stage (too many ids, or rows not as ``pack_bucket``
writes them) runs on the warp route's code within the same launch, so the
plan never needs the data.

The tensor's device alone picks the implementation: a CUDA tensor launches
the kernel (or the call raises), a CPU tensor takes the plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Dict, Optional

import torch

from . import ref as _ref
from ._build import device_and_stream

SMS = 132                   # streaming multiprocessors of an H100 SXM
MAX_ROWS = 1 << 15          # a row's bitmap holds R bits; ids fit 16 bits
MAX_WIDTH = 1 << 12         # the batch engine's MAX_WIDTH
WARP_WARPS = 8              # warp route: warps a block, a row each
WARP_BLOCKS_PER_SM = 8
SMEM_WARPS = 16             # smem route: warps a block
SMEM_MAX_WIDTH = 32         # smem route: a row's slots in one ballot
# Smem route: two blocks an SM, each with this much dynamic shared memory
# (two of them, their static words and the 1 KB each block reserves fit the
# SM's 228 KB).
SMEM_BLOCK_BYTES = 115_200
# Measured on an H100 (PERF.md, scripts/agreement_sweep.py): the thresholds
# of agreement_launch_plan.
SMEM_MAX_R = 4096
SMEM_MIN_GROUPS = 96
ROUTES = {"warp": 0, "smem": 1}     # the C entry's route codes
# The C entry's argument list, as the library's ag_abi_version() reports
# it: 2 is (ell, out, B, R, W, replicas, beta_num, beta_den, route, blocks,
# smem_bytes, device, stream). The source before it exports no version
# and takes (ell, out, B, R, W, beta_num, beta_den, blocks, device, stream).
ABI_VERSION = 2


@dataclasses.dataclass(frozen=True)
class AgreementPlan:
    """One launch: ``blocks`` blocks of ``threads`` threads with
    ``smem_bytes`` of dynamic shared memory each. The warp route strides
    its warps over the ``B/replicas · R`` rows; the smem route its blocks
    over the ``B/replicas`` graphs, staging up to
    :func:`smem_capacity` ids of a graph."""

    route: str
    threads: int
    blocks: int
    smem_bytes: int

    def args(self):
        """The C entry's (route, blocks, smem_bytes)."""
        return ROUTES[self.route], self.blocks, self.smem_bytes


def _words(R: int) -> int:
    return -(-R // 32)


def warp_plan(B: int, R: int, W: int, replicas: int = 1) -> AgreementPlan:
    """The warp route: blocks of 8 warps, a warp per row, eight blocks an
    SM at most (the warps stride over the rest), a bitmap of R bits a
    warp in shared memory."""
    rows = (B // replicas) * R
    blocks = max(1, min(-(-rows // WARP_WARPS), SMS * WARP_BLOCKS_PER_SM))
    return AgreementPlan("warp", 32 * WARP_WARPS, blocks,
                         WARP_WARPS * _words(R) * 4)


def smem_fixed_bytes(R: int) -> int:
    """The smem route's shared memory besides the ids: a meta word (offset,
    degree, rotation) and an agree word a row."""
    return 8 * R


def smem_least_bytes(R: int) -> int:
    """The least shared memory the smem route takes: its fixed part and
    room for the bitmaps of R bits a warp that a graph it cannot stage
    uses in the ids' place."""
    return smem_fixed_bytes(R) + SMEM_WARPS * _words(R) * 4


def smem_capacity(plan: AgreementPlan, R: int) -> int:
    """Ids of one graph the smem route stages with ``plan``'s shared
    memory; a graph with more runs on the warp route's code."""
    return (plan.smem_bytes - smem_fixed_bytes(R)) // 2


def smem_plan(B: int, R: int, W: int, replicas: int = 1,
              smem_bytes: int = SMEM_BLOCK_BYTES) -> Optional[AgreementPlan]:
    """The smem route, or None where it cannot run: rows wider than a warp
    (``W > 32``) or less shared memory than :func:`smem_least_bytes`. A
    block a graph, two blocks an SM at most."""
    if W > SMEM_MAX_WIDTH or smem_bytes < smem_least_bytes(R):
        return None
    blocks = max(1, min(B // replicas, 2 * SMS))
    return AgreementPlan("smem", 32 * SMEM_WARPS, blocks, smem_bytes)


def agreement_launch_plan(B: int, R: int, W: int,
                          replicas: int = 1) -> AgreementPlan:
    """The plan of one launch, from the shape alone: the smem route where
    it can run, for ``R <= SMEM_MAX_R`` and at least ``SMEM_MIN_GROUPS``
    graphs (fewer leave SMs idle, a block a graph); the warp route
    everywhere else."""
    smem = smem_plan(B, R, W, replicas)
    if smem is not None and R <= SMEM_MAX_R and \
            B // replicas >= SMEM_MIN_GROUPS:
        return smem
    return warp_plan(B, R, W, replicas)


# Launches of the kernel: the wrapper adds one where it launches it and
# nowhere else. The executors' dispatch threads launch too, so an
# increment takes the lock.
launches: Dict[str, int] = {"agreement_ell_batch": 0}
_launches_lock = threading.Lock()


def reset_launch_counts() -> None:
    launches["agreement_ell_batch"] = 0


_LIB: Optional[ctypes.CDLL] = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of an agreement library of this ABI."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ag_agreement.argtypes = [vp, vp, i64, i32, i32, i32, i32, i32, i32,
                                 i32, i32, i32, vp]
    lib.ag_agreement.restype = i32
    lib.ag_error_string.argtypes = [i32]
    lib.ag_error_string.restype = ctypes.c_char_p
    return lib


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from . import _build

        _LIB = bind(_build.load("agreement"))
    return _LIB


def agreement_ell_batch(ell: torch.Tensor, replicas: int = 1,
                        plan: Optional[AgreementPlan] = None) -> torch.Tensor:
    """(B, R, W) int32 agreement ELL of a bucket (pad id ``R``), entry
    ``b`` that of ``ell[(b // replicas)·replicas]``. ``plan`` forces a
    launch plan (default :func:`agreement_launch_plan`)."""
    if ell.dim() != 3 or ell.dtype != torch.int32:
        raise ValueError(f"agreement_ell_batch: ell must be a 3-D int32 "
                         f"tensor, got {ell.dim()}-D {ell.dtype}")
    B, R, W = ell.shape
    if replicas < 1 or B % replicas:
        raise ValueError(f"agreement_ell_batch: batch of {B} entries is not "
                         f"whole groups of replicas={replicas}")
    if ell.device.type == "cpu":
        return _ref.agreement_ell_ref(ell, replicas=replicas)
    if ell.device.type != "cuda":
        raise ValueError(f"agreement_ell_batch: unsupported device "
                         f"{ell.device}")
    if not ell.is_contiguous():
        raise ValueError("agreement_ell_batch: ell must be contiguous")
    if R > MAX_ROWS or W > MAX_WIDTH:
        raise ValueError(f"agreement_ell_batch: (R, W) = {(R, W)} above the "
                         f"kernel's ({MAX_ROWS}, {MAX_WIDTH})")
    out = torch.empty_like(ell)
    if out.numel() == 0:
        return out
    if plan is None:
        plan = agreement_launch_plan(B, R, W, replicas)
    code = _lib().ag_agreement(ell.data_ptr(), out.data_ptr(), B, R, W,
                               replicas, _ref.BETA_NUM, _ref.BETA_DEN,
                               *plan.args(), *device_and_stream(ell))
    if code != 0:
        raise RuntimeError(f"agreement_ell_batch: CUDA kernel launch failed "
                           f"({code}: {_lib().ag_error_string(code).decode()}"
                           f") with {plan}")
    with _launches_lock:
        launches["agreement_ell_batch"] += 1
    return out


__all__ = ["agreement_ell_batch", "agreement_launch_plan", "warp_plan",
           "smem_plan", "smem_capacity", "smem_fixed_bytes",
           "smem_least_bytes", "AgreementPlan",
           "launches", "reset_launch_counts", "ROUTES", "ABI_VERSION"]
