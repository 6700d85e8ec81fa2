"""Timing and same-run A/B helpers for the kernels on the card.

Shared by ``chip_smoke.py``, ``scripts/ell_route_sweep.py``,
``scripts/mis_route_sweep.py``, ``scripts/agreement_sweep.py`` and
``scripts/attention_sweep.py``: the
card's name and power limit, device time per call from the profiler, the
byte and operation bound, the random bucket inputs of the ELL kernels, the
random graphs and the byte count of the fused per-graph PIVOT (B3), B4's
shapes, tolerances and bounds, the agreement kernel's byte count,
:class:`Baseline`, an earlier ``neighbor_min.cu`` built and called beside
the current one, and :class:`FaBaseline`, :class:`AgBaseline` and
:class:`MpBaseline`, the same for ``flash_attention.cu`` (B4),
``agreement.cu`` and ``mis_pivot.cu`` (B3). Nothing here touches
the card or ``nvcc`` at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
NON_TENSOR_OPS_PER_S = 67e12   # H100 SXM peak outside the tensor cores
TF32_TENSOR_OPS_PER_S = 495e12  # H100 SXM dense TF32 tensor-core peak
BF16_TENSOR_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
INF = 2**31 - 1

# B4 shapes (B, H, KH, Sq, Sk, D, causal, dtype): the reference's kernel
# test (tests/test_kernels.py), smollm-135m prefills at three prompt
# lengths, a batch of eight long ones, and prefills at head dims 80
# (zamba2-2.7b's, 32 heads over 32) and 160 (stablelm-12b's, 32 over 8),
# cut to 8 heads.
B4_SHAPES = [
    (1, 4, 4, 128, 128, 64, True, "float32"),
    (2, 4, 2, 128, 128, 64, True, "float32"),
    (1, 8, 1, 256, 256, 64, True, "bfloat16"),
    (2, 4, 4, 128, 384, 64, True, "float32"),
    (1, 2, 2, 192, 192, 32, False, "float32"),
    (1, 9, 3, 130, 130, 64, True, "float32"),
    (1, 4, 4, 64, 64, 128, True, "bfloat16"),
] + [(1, 9, 3, s, s, 64, True, dt) for s in (24, 512, 2048)
     for dt in ("float32", "bfloat16")] + [
    (8, 9, 3, 2048, 2048, 64, True, dt) for dt in ("float32", "bfloat16")] + [
    (1, 8, kh, 1024, 1024, d, True, dt) for d, kh in ((80, 8), (160, 2))
    for dt in ("float32", "bfloat16")]
# The reference's kernel tolerances: sums in another order, and a bf16
# output may round one unit apart.
B4_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# A bf16 case whose every output lies in [4.5, 7.5], where one bf16 unit is
# 2^-5: v = 6 + U(-1.5, 1.5). The kernel's bf16 output is held to
# B4_TOL["bfloat16"] against the plain version's f32 output (before its
# bf16 rounding): the output's own rounding takes half a unit, 1.56e-2, so
# 2e-2 leaves 4.4e-3 for the kernel's error. P rounded to bf16 before
# P @ V costs up to 2^-9 of each weight, more than that.
B4_LARGE_O_SHAPE = (1, 9, 3, 2048, 2048, 64, True, "bfloat16")


def b4_large_output_inputs(shape, rng, dev):
    """q, k, v of :data:`B4_LARGE_O_SHAPE`'s kind and the plain version's
    f32 output on them."""
    from .ref import attention_ref

    B, H, KH, Sq, Sk, D, causal, dtype = shape
    dt = getattr(torch, dtype)
    q = torch.from_numpy(rng.standard_normal((B, H, Sq, D), np.float32))
    k = torch.from_numpy(rng.standard_normal((B, KH, Sk, D), np.float32))
    v = torch.from_numpy(6 + rng.uniform(-1.5, 1.5, (B, KH, Sk, D))
                         .astype(np.float32))
    q, k, v = (t.to(dev, dt) for t in (q, k, v))
    want = attention_ref(q.float(), k.float(), v.float(), causal=causal)
    return q, k, v, want


def b4_large_output_check(got, want, shape):
    """The |o| >= 4 check on :func:`b4_large_output_inputs`: every output
    at least 4 in magnitude and within ``B4_TOL["bfloat16"]`` of the plain
    version's f32 output ``want``. Returns ``(max abs err, min |o|)``;
    raises AssertionError where either fails."""
    err = float((got.float() - want).abs().max())
    low = float(got.float().abs().min())
    if not (err < B4_TOL["bfloat16"] and low >= 4):
        raise AssertionError(f"flash_attention at {tuple(shape)}: min |o| "
                             f"{low}, {err} from the f32 plain output")
    return err, low


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def device_events(fn):
    """Run ``fn`` under the profiler; returns (name, device µs) per kernel
    the card ran, or None when the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    out = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return out or None


def device_ms(fn, calls: int = 20, tries: int = 3):
    """Device time of one call from the profiler (None if unseen): per
    kernel name, its mean time × its launches per call (its count over
    ``calls``, rounded), so that a launch the profiler failed to record
    (it drops some now and then, or a whole session) does not shorten the
    time. A session whose event count is not a multiple of ``calls`` is
    run again, up to ``tries`` times, and the fullest one is used."""
    def many():
        for _ in range(calls):
            fn()
    events = None
    for _ in range(tries):
        seen = device_events(many)
        if seen and (events is None or len(seen) > len(events)):
            events = seen
        if seen and len(seen) % calls == 0:
            break
    if events is None:
        return None
    by_name: dict = {}
    for name, us in events:
        by_name.setdefault(name, []).append(us)
    return sum(max(1, round(len(us) / calls)) * float(np.mean(us))
               for us in by_name.values()) / 1e3


def abba_ms(fns):
    """Device ms per call of each function, each timed alone by the
    profiler (:func:`device_ms`) in the order A B C ... C B A, the mean of
    its two passes (None where the profiler saw nothing). Two builds of
    one kernel may share its name, so each is timed in a session of its
    own."""
    passes: dict = {}
    for i in list(range(len(fns))) + list(range(len(fns)))[::-1]:
        passes.setdefault(i, []).append(device_ms(fns[i]))
    return [None if None in t else sum(t) / 2 for _, t in sorted(
        passes.items())]


def bound_ms(nbytes: int, ops: int, ops_per_s: float = NON_TENSOR_OPS_PER_S):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over the peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def b4_bytes_and_ops(B, H, KH, Sq, Sk, D, causal, dtype):
    """Bytes (q, k, v read once, o written once) and flops of B4: 2 per
    multiply-add of the score and value products, over the (row, key)
    pairs the mask lets through."""
    esize = 4 if dtype == "float32" else 2
    nbytes = esize * D * (2 * B * H * Sq + 2 * B * KH * Sk)
    if causal:   # row i sees keys 0 .. i + Sk - Sq
        pairs = Sq * (Sk - Sq + 1) + Sq * (Sq - 1) // 2
    else:
        pairs = Sq * Sk
    return nbytes, 4 * D * B * H * pairs


def b4_bounds(shape):
    """(bound ms, what bounds it, every bound by name) of B4 at ``shape``:
    bytes against, for f32, the f32 FMA rate for the flops once and the
    TF32 tensor rate for the flops three times (the kernel's split
    products), the smaller of the two; for bf16 the bf16 tensor rate."""
    nbytes, flops = b4_bytes_and_ops(*shape)
    if shape[-1] == "float32":
        bounds = {"f32_fma": bound_ms(nbytes, flops, NON_TENSOR_OPS_PER_S),
                  "tf32x3": bound_ms(nbytes, 3 * flops,
                                     TF32_TENSOR_OPS_PER_S)}
    else:
        bounds = {"bf16": bound_ms(nbytes, flops, BF16_TENSOR_OPS_PER_S)}
    ms, by = min(bounds.values())
    return ms, by, {name: b[0] for name, b in bounds.items()}


def kernel_inputs(B, R, W, rng, dev):
    """Bucket state with the pad contract; a quarter of the rows hold only
    pads and, when B > 1, the last graph has no active vertex at all."""
    ell = rng.integers(0, R + 1, (B, R, W), dtype=np.int32)
    ell[:, ::4, :] = R
    ranks = rng.integers(0, INF, (B, R + 1), dtype=np.int32)
    ranks[:, R] = INF
    active = rng.random((B, R + 1)) < 0.3
    active[:, R] = False
    if B > 1:
        active[-1] = False
    labels = rng.integers(0, 8, (B, R + 1), dtype=np.int32)
    labels[:, R] = -1
    return [torch.from_numpy(a).to(dev) for a in (ell, ranks, active, labels)]


def bytes_and_ops(name, B, R, W):
    """DRAM bytes (each input read once, output written once) and ops of
    B1, B2 or the one-graph form: the ELL roofline's own counts
    (``launch/roofline.py`` ``ell_kernel_bytes``, ``ell_kernel_flops``),
    so the bounds printed here and the autotuner's model are one."""
    from repro_torch.launch.roofline import ell_kernel_bytes, ell_kernel_flops

    kernel = "label_agree" if name == "label_agree_ell_batch" \
        else "neighbor_min"
    return (int(ell_kernel_bytes(kernel, B, R, W)),
            int(ell_kernel_flops(kernel, B, R, W)))


def mis_pivot_bytes_and_ops(n: int, ids: int, k: int, window=None):
    """Bytes and operations kernel B3 (``mis_pivot``) must move and do for
    ``k`` samples of one graph of ``n`` vertices and ``ids`` = 2m neighbour
    ids: the offsets and the ids read once (the samples share them), the
    ranks and the mask read once, status, labels and rounds written once;
    one compare a neighbour id a sample. The rounds' passes over the CSR
    and the state are the kernel's way of computing the function, not
    bytes the function must move: the state stays on chip (shared memory
    on the block route, L2 on the grid route), so they are not charged.

    ``window = (rows, row_ids)`` counts the window mode (k = 1) on this
    run's data: only the ``rows`` undecided vertices in the window compete,
    so their two offsets and ``row_ids`` neighbour ids are read once; the
    ranks and the status in are read and the status out written for every
    vertex (4n each), the rounds once; one compare a neighbour id read."""
    if window is not None:
        rows, row_ids = window
        return 8 * rows + 4 * row_ids + 12 * n + 4, row_ids
    return (4 * (n + 2) + 4 * ids + 4 * k * n + n + 8 * k * n + 4 * k,
            k * ids)


def window_rows(g, ranks: torch.Tensor, status: torch.Tensor, lo: int,
                hi: int):
    """(rows, row_ids) of a window: the undecided vertices with rank in
    ``[lo, hi)`` and the sum of their degrees, for
    :func:`mis_pivot_bytes_and_ops`."""
    rows = (status == 0) & (ranks >= lo) & (ranks < hi)
    return int(rows.sum()), int(g.deg[rows].long().sum())


def agreement_bytes_and_ops(ell: torch.Tensor, replicas: int = 1):
    """Bytes and operations the agreement kernel's function must move and
    do on ``ell`` with ``replicas``: each group's ELL read once
    (4·numel / replicas bytes), every entry's output written once
    (4·numel); a membership test and a count for each of the W ids of the
    neighbour row of every non-pad slot of each group's graph."""
    B, R, W = ell.shape
    return (4 * ell.numel() // replicas + 4 * ell.numel(),
            2 * W * int((ell[::replicas] != R).sum()))


def mis_pivot_inputs(n: int, k: int, lam: int, rng, dev, capped=False,
                     edges=None):
    """A graph of ``n`` vertices on ``dev`` (``edges``, by default a random
    ``lam``-arboric one from ``rng``), ``k`` random rank permutations and
    the eligibility, ``capped``: the per-graph path's degree cap at λ =
    ``lam`` (:func:`repro_torch.core.degree_cap.high_degree`), else every
    vertex: ``(graph, ranks, eligible)``."""
    from repro_torch.core.degree_cap import high_degree
    from repro_torch.core.graph import build_graph, random_arboric

    if edges is None:
        edges = random_arboric(n, lam, rng)[0] if n > 1 \
            else np.zeros((0, 2), np.int64)
    g = build_graph(n, edges, device=dev)
    perms = np.stack([rng.permutation(n) for _ in range(k)]).reshape(k, n)
    ranks = np.empty_like(perms)
    np.put_along_axis(ranks, perms, np.arange(n)[None, :], axis=1)
    eligible = ~high_degree(g, lam)[0] if capped \
        else torch.ones(n, dtype=torch.bool, device=dev)
    return g, torch.from_numpy(ranks.astype(np.int32)).to(dev), eligible


def bind_baseline(lib) -> int:
    """Set the argument types of a ``neighbor_min.cu`` library's C entries
    from the ABI it reports, and return that ABI's version: 1 for a source
    that exports no ``nm_abi_version`` (entries without a launch plan), or
    ``neighbor_min.ABI_VERSION``. Any other version raises, since calling
    an entry with the wrong arguments is undefined."""
    from . import neighbor_min as nm

    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    report = getattr(lib, "nm_abi_version", None)
    if report is None:
        version, plan = 1, []
    else:
        report.argtypes, report.restype = [], i32
        version, plan = report(), [i32] * 4
        if version != nm.ABI_VERSION:
            raise ValueError(f"baseline reports ABI {version}; this checkout "
                             f"calls 1 (no launch plan) or {nm.ABI_VERSION}")
    lib.nm_neighbor_min.argtypes = [vp, vp, vp, vp, i64, i32, i32, i32,
                                    *plan, i32, vp]
    lib.nm_label_agree.argtypes = [vp, vp, vp, i64, i32, i32, i32, *plan,
                                   i32, vp]
    lib.nm_neighbor_min.restype = lib.nm_label_agree.restype = i32
    return version


class _BaselineBuild:
    """Starts ``nvcc`` on another kernel source at construction; ``load``
    waits for it and returns the library. The library is named by the
    source's hash: a process that loads two baselines would otherwise get
    the first library back from the loader."""

    stem = "base"

    def __init__(self, source: Path):
        from . import _build

        out_dir = _build.BUILD_DIR / "baseline"
        out_dir.mkdir(parents=True, exist_ok=True)
        digest = hashlib.sha256(Path(source).read_bytes()).hexdigest()[:16]
        self.source = source
        self.path = out_dir / f"lib{self.stem}-{digest}.so"
        self.proc = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(self.path),
             str(source)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        self.lib = None

    def _library(self):
        text, _ = self.proc.communicate()
        if self.proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source}:\n{text}")
        return ctypes.CDLL(str(self.path))


class Baseline(_BaselineBuild):
    """The ELL kernels built from another ``neighbor_min.cu``, timed beside
    the current ones on the same inputs. A source whose entries take a
    launch plan runs under this checkout's ``launch_plan``."""

    stem = "neighbor_min_base"

    def load(self):
        lib = self._library()
        self.version = bind_baseline(lib)
        self.lib = lib

    def _call(self, entry, ell, *ptrs):
        from . import neighbor_min as nm
        from ._build import device_and_stream

        B, R, W = (1, *ell.shape) if ell.dim() == 2 else ell.shape
        plan = () if self.version == 1 else \
            nm.launch_plan(B, R, W, R + 1).args()
        out = torch.empty(ell.shape[:-1], dtype=torch.int32, device=ell.device)
        code = entry(ell.data_ptr(), *(t.data_ptr() for t in ptrs),
                     out.data_ptr(), B, R, W, R + 1, *plan,
                     *device_and_stream(ell))
        if code != 0:
            raise RuntimeError(f"baseline kernel launch failed ({code})")
        return out

    def neighbor_min(self, ell, ranks, active):
        return self._call(self.lib.nm_neighbor_min, ell, ranks, active)

    def label_agree(self, ell, labels):
        return self._call(self.lib.nm_label_agree, ell, labels)


class AgBaseline(_BaselineBuild):
    """The agreement kernel built from another ``agreement.cu``, called
    beside the current one on the same inputs: a source that exports no
    ``ag_abi_version`` takes (ell, out, B, R, W, beta_num, beta_den, blocks,
    device, stream) and computes every entry (``replicas`` = 1 only), with
    the grid its wrapper gave it; one of this checkout's ABI runs under
    this checkout's launch plan."""

    stem = "agreement_base"

    def load(self):
        from . import agreement as ag

        lib = self._library()
        report = getattr(lib, "ag_abi_version", None)
        if report is None:
            vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.ag_agreement.argtypes = [vp, vp, i64, i32, i32, i32, i32, i32,
                                         i32, vp]
            lib.ag_agreement.restype = i32
            self.version = 1
        else:
            report.argtypes, report.restype = [], ctypes.c_int
            self.version = report()
            if self.version != ag.ABI_VERSION:
                raise ValueError(f"agreement baseline reports ABI "
                                 f"{self.version}; this checkout calls 1 or "
                                 f"{ag.ABI_VERSION}")
            ag.bind(lib)
        self.lib = lib

    def __call__(self, ell, replicas: int = 1):
        from . import agreement as ag
        from .ref import BETA_DEN, BETA_NUM
        from ._build import device_and_stream

        B, R, W = ell.shape
        out = torch.empty_like(ell)
        if self.version == 1:
            if replicas != 1:
                raise ValueError("the agreement baseline computes every "
                                 "entry: replicas=1 only")
            blocks = max(1, min(-(-(B * R) // 8), ag.SMS * 8))
            code = self.lib.ag_agreement(
                ell.data_ptr(), out.data_ptr(), B, R, W, BETA_NUM, BETA_DEN,
                blocks, *device_and_stream(ell))
        else:
            code = self.lib.ag_agreement(
                ell.data_ptr(), out.data_ptr(), B, R, W, replicas, BETA_NUM,
                BETA_DEN, *ag.agreement_launch_plan(B, R, W, replicas).args(),
                *device_and_stream(ell))
        if code != 0:
            raise RuntimeError(f"baseline agreement launch failed ({code})")
        return out


class MpBaseline(_BaselineBuild):
    """Kernel B3 built from another ``mis_pivot.cu`` whose ``mp_mis_pivot``
    takes this checkout's 18 arguments, run under this checkout's launch
    plan beside the current kernel on the same inputs; its launches are not
    counted."""

    stem = "mis_pivot_base"

    def load(self):
        lib = self._library()
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mp_mis_pivot.argtypes = [vp] * 10 + [i32] * 7 + [vp]
        lib.mp_mis_pivot.restype = i32
        self.lib = lib

    def __call__(self, row_offsets, dst, ranks, eligible):
        from . import mis_pivot as mp

        k, n = mp._check(row_offsets, dst, ranks, eligible)
        return mp.run_mis_pivot(self.lib.mp_mis_pivot, row_offsets, dst,
                                ranks, eligible, mp.mis_launch_plan(k, n))[0]


class FaBaseline(_BaselineBuild):
    """Kernel B4 built from another ``flash_attention.cu`` (its C entry
    ``fa_forward`` with the 14 arguments of this checkout's), called beside
    the current kernel on the same inputs."""

    stem = "flash_attention_base"

    def load(self):
        lib = self._library()
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.fa_forward.argtypes = [vp, vp, vp, vp] + [i32] * 9 + [vp]
        lib.fa_forward.restype = i32
        self.lib = lib

    def __call__(self, q, k, v, causal=True):
        from . import flash_attention as fa
        from ._build import device_and_stream

        B, H, KH, Sq, Sk, D = fa._check(q, k, v, causal)
        out = torch.empty_like(q)
        code = self.lib.fa_forward(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            KH, Sq, Sk, D, int(causal), fa._DTYPES[q.dtype],
            *device_and_stream(q))
        if code != 0:
            raise RuntimeError(f"baseline flash_attention launch failed "
                               f"({code})")
        return out
