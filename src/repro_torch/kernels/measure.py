"""Timing and same-run A/B helpers for kernels B1–B3 on the card.

Shared by ``chip_smoke.py`` and ``scripts/ell_route_sweep.py``: the card's
name and power limit, device time per call from the profiler, the byte and
operation bound, the random bucket inputs both time on, and
:class:`Baseline`, an earlier ``neighbor_min.cu`` built and called beside
the current one. Nothing here touches the card or ``nvcc`` at import time.
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
INF = 2**31 - 1


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


def bound_ms(nbytes: int, ops: int, ops_per_s: float = NON_TENSOR_OPS_PER_S):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over the peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    """DRAM bytes (each input read once, output written once) and ops."""
    slots, state = B * R * W, B * (R + 1)
    if name == "label_agree_ell_batch":
        return 4 * slots + 4 * state + 4 * B * R, 3 * slots
    return 4 * slots + 5 * state + 4 * B * R, 3 * slots


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


class Baseline:
    """The ELL kernels built from another ``neighbor_min.cu``, timed beside
    the current ones on the same inputs. A source whose entries take a
    launch plan runs under this checkout's ``launch_plan``."""

    def __init__(self, source: Path):
        from . import _build

        out_dir = _build.BUILD_DIR / "baseline"
        out_dir.mkdir(parents=True, exist_ok=True)
        # Named by the source's hash: a process that loads two baselines
        # would otherwise get the first library back from the loader.
        digest = hashlib.sha256(Path(source).read_bytes()).hexdigest()[:16]
        self.source = source
        self.path = out_dir / f"libneighbor_min_base-{digest}.so"
        self.proc = subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(self.path),
             str(source)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        self.lib, self.version = None, None

    def load(self):
        text, _ = self.proc.communicate()
        if self.proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source}:\n{text}")
        lib = ctypes.CDLL(str(self.path))
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
