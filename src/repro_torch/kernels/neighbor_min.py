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
* :func:`neighbor_min_ell` — B1 for one graph, ``(n, W)``: the function of
  the reference's one-graph kernel (B3), here the round step of the host
  loop ``core/mis.py`` ``_greedy_mis_host_loop``. It launches the B1 kernel
  with ``B = 1`` and keeps its own launch count. The per-graph path runs
  B3 redesigned instead, every round in one launch (:mod:`.mis_pivot`).

Contract (the reference's pad layout): ``ell`` is int32 with pad id ``R``;
the state rows have width ``S = R + 1`` and slot ``R`` is the pad slot
(rank ``INT32_MAX``, ``active`` False, label ``-1``). ``active`` is bool.
On the card every tensor is contiguous, and where the plan takes the
staged route ``ell`` starts 16-byte aligned (the state may start anywhere,
a row slice ``state[b0:b1]`` included); a call that breaks this raises.

The tensor's device alone picks the implementation: a CUDA tensor launches
the kernel (or the call raises), a CPU tensor takes the plain version in
:mod:`.ref`. There is no fallback from one to the other. On the card,
:func:`launch_plan` picks the kernel's route from the shape alone.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional

import torch

from . import ref as _ref
from ._build import device_and_stream

INF = _ref.INF_I32

THREADS = 256               # threads per block of the l2 route
STAGED_THREADS = 1024       # a staged block: one on every SM
SMS = 132                   # streaming multiprocessors of an H100 SXM
SMEM_BYTES_MAX = 232_448    # dynamic shared memory a block may use (sm_90)
# Measured on an H100 (PERF.md): below about 2 MiB of ELL a launch
# is bound by its latency, and the l2 route's is shorter; and a staged
# launch that reads more than two state words per ELL word (a few long
# graphs over many blocks, as in the one-graph host loop) loses to l2.
MIN_STAGED_BYTES = 2 << 20
STAGE_RATIO = 2.0
ROUTES = {"l2": 0, "staged": 1}     # the C entry's route codes
# The C entries' argument list, as the library's nm_abi_version() reports
# it: 2 is (ell, state..., out, B, R, W, S, route, rows_per_block, threads,
# smem_bytes, device, stream). The source before the launch plan exports
# no version and takes no plan.
ABI_VERSION = 2


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one launch covers the ``B·R`` global rows ``b·R + r``: block
    ``i`` of ``blocks`` owns rows ``[i·rows_per_block, (i+1)·rows_per_block)``
    and runs ``threads`` threads; a staged block holds the state of up to
    ``smem_bytes / (4·S)`` graphs at a time in shared memory."""

    route: str
    rows_per_block: int
    threads: int
    smem_bytes: int
    blocks: int

    def args(self):
        """The C entries' (route, rows_per_block, threads, smem_bytes)."""
        return (ROUTES[self.route], self.rows_per_block, self.threads,
                self.smem_bytes)


def _lanes_per_row(words: int) -> int:
    """Lanes that share a row of ``words`` loads: pow2, at most a warp."""
    return min(32, 1 << max(0, words - 1).bit_length())


def l2_plan(B: int, R: int, W: int) -> LaunchPlan:
    """The l2 route: blocks of ``THREADS`` threads, a row to each group of
    ``pow2(W)`` lanes (up to a warp), no shared memory."""
    rows = THREADS // _lanes_per_row(W)
    return LaunchPlan("l2", rows, THREADS, 0, -(-(B * R) // rows))


def staged_plan(B: int, R: int, W: int, S: int,
                block_rows: Optional[int] = None) -> Optional[LaunchPlan]:
    """The staged route's plan, or None where it cannot run: rows that are
    not 16 bytes long (``W % 4``) or one graph's state above a block's
    shared memory.

    By default one block of 1,024 threads runs on every SM, the rows split
    evenly between them, so no block waits on a second wave;
    ``block_rows``, the one tunable, caps the rows per block (more, shorter
    blocks, in several waves). A block walks its rows a segment at a time,
    staging the state of as many of the segment's graphs as shared memory
    holds: the graphs its run touches, up to 227 KB.
    """
    if W % 4 or S * 4 > SMEM_BYTES_MAX:
        return None
    rows = -(-(B * R) // SMS)
    if block_rows is not None:
        rows = min(rows, block_rows)
    graphs = min(B, (rows - 1) // R + 2, SMEM_BYTES_MAX // (S * 4))
    return LaunchPlan("staged", rows, STAGED_THREADS, graphs * S * 4,
                      -(-(B * R) // rows))


def launch_plan(B: int, R: int, W: int, S: int) -> LaunchPlan:
    """The plan of one B1, B2 or one-graph launch: a function of the shape
    alone.

    The one-wave :func:`staged_plan` where it can run, except for launches
    under ``MIN_STAGED_BYTES`` of ELL and launches that would stage more
    than ``STAGE_RATIO`` state words per ELL word; everything else takes
    :func:`l2_plan`: int32 loads, state gathered through L2.
    """
    staged = staged_plan(B, R, W, S)
    total = B * R
    if (staged is None or total * W * 4 < MIN_STAGED_BYTES
            # Each block stages the graph its run starts in and every graph
            # it enters after that.
            or (staged.blocks + B - 1) * S > STAGE_RATIO * total * W):
        return l2_plan(B, R, W)
    return staged


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
                                        i32, i32, i32, i32, i32, vp]
        lib.nm_neighbor_min.restype = i32
        lib.nm_label_agree.argtypes = [vp, vp, vp, i64, i32, i32, i32, i32,
                                       i32, i32, i32, i32, vp]
        lib.nm_label_agree.restype = i32
        lib.nm_error_string.argtypes = [i32]
        lib.nm_error_string.restype = ctypes.c_char_p
        lib.nm_abi_version.argtypes = []
        lib.nm_abi_version.restype = i32
        if lib.nm_abi_version() != ABI_VERSION:
            raise RuntimeError(f"libneighbor_min reports ABI "
                               f"{lib.nm_abi_version()}, this wrapper "
                               f"binds {ABI_VERSION}: rebuild it")
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


def _plan_args(name: str, B: int, R: int, W: int, ell: torch.Tensor):
    """The C entry's (route, rows_per_block, threads, smem_bytes)."""
    plan = launch_plan(B, R, W, R + 1)
    if plan.route == "staged" and ell.data_ptr() % 16:
        raise ValueError(f"{name}: the staged kernel reads ell 16 bytes at a "
                         "time: ell starts at an unaligned offset")
    return plan.args()


def _launch_neighbor_min(ell, ranks_p, active_p, B, R, W, name):
    plan = _plan_args(name, B, R, W, ell)
    out = torch.empty((B, R), dtype=torch.int32, device=ell.device)
    code = _lib().nm_neighbor_min(
        ell.data_ptr(), ranks_p.data_ptr(), active_p.data_ptr(),
        out.data_ptr(), B, R, W, R + 1, *plan, *device_and_stream(ell))
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
    """(n,) int32 masked neighbour-min of one graph (B3's function).

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
    plan = _plan_args("label_agree_ell_batch", B, R, W, ell)
    out = torch.empty((B, R), dtype=torch.int32, device=ell.device)
    code = _lib().nm_label_agree(ell.data_ptr(), labels_p.data_ptr(),
                                 out.data_ptr(), B, R, W, R + 1, *plan,
                                 *device_and_stream(ell))
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
           "launches", "reset_launch_counts", "launch_plan", "l2_plan",
           "staged_plan", "LaunchPlan", "ABI_VERSION"]
