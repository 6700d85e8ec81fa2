"""Roofline models of the batched ELL kernels (B1, B2) on the H100.

The port of the ELL half of ``repro/launch/roofline.py``: the two kernels
the bucket program spends its rounds in (``kernels/neighbor_min.py``), one
invocation sweeping a ``(B, R, W)`` int32 ELL adjacency. The model gives
the autotuner's checks a hardware lower bound to hold measured device
times against: a time below the model means the measurement (or the
model) is broken. The LM half of the reference module (HLO collectives,
model flops) is not ported.

The constants are the H100 SXM's, the ones ``kernels/measure.py`` bounds
every kernel with: 3.35 TB/s of device memory and 67 TOP/s outside the
tensor cores.

**The byte count differs from the reference's on purpose.** The reference
charges one gathered word per ELL slot per state table, the TPU's gather
from VMEM. On the H100's staged route the state of the graphs a block
works on sits in shared memory, so those gathers move no device-memory
bytes, and the least the function must move is each input read once and
the output written once: the ELL, the state rows (``neighbor_min``: int32
ranks and a bool active flag a slot; ``label_agree``: int32 labels) and
the int32 output. :func:`ell_kernel_bytes` is that count, and
``measure.bytes_and_ops`` delegates to it, so the kernel table's B1/B2
bounds and this model are one number.
"""

from __future__ import annotations

import dataclasses

from repro_torch.kernels.measure import HBM_BYTES_PER_S, NON_TENSOR_OPS_PER_S

HBM_BW = HBM_BYTES_PER_S
PEAK_OPS = NON_TENSOR_OPS_PER_S

ELL_KERNELS = ("neighbor_min", "label_agree")


def _check_kernel(kernel: str) -> None:
    if kernel not in ELL_KERNELS:
        raise ValueError(f"unknown ELL kernel {kernel!r}; "
                         f"expected one of {ELL_KERNELS}")


def ell_kernel_flops(kernel: str, b: int, r: int, w: int) -> float:
    """Element-op count of one batched ELL kernel invocation.

    Per (entry, row, col): ``neighbor_min`` does a rank gather, an activity
    gather, a select and a running min (≈4 ops); ``label_agree`` does a
    label gather, a compare and an accumulate (≈3 ops). Integer ops on the
    CUDA cores, not tensor-core flops.
    """
    _check_kernel(kernel)
    per_elem = 4.0 if kernel == "neighbor_min" else 3.0
    return per_elem * b * r * w


def ell_kernel_bytes(kernel: str, b: int, r: int, w: int) -> float:
    """Device-memory bytes one batched ELL kernel invocation must move:
    the (B, R, W) int32 ELL read once, the (B, R+1) state rows read once
    (``neighbor_min``: int32 ranks + bool active, 5 bytes a slot;
    ``label_agree``: int32 labels, 4), the (B, R) int32 output written
    once (module docstring: no gathered words, unlike the reference)."""
    _check_kernel(kernel)
    state_bytes = 5 if kernel == "neighbor_min" else 4
    return float(4 * b * r * w + state_bytes * b * (r + 1) + 4 * b * r)


@dataclasses.dataclass(frozen=True)
class KernelRoofline:
    """Roofline model of one batched ELL kernel invocation (no
    collectives — batch entries are independent)."""

    kernel: str
    b: int
    r: int
    w: int
    flops: float
    bytes_hbm: float
    peak_flops: float
    mem_bw: float

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_hbm / self.mem_bw

    @property
    def t_model(self) -> float:
        """The model's lower bound on the invocation's device time (s)."""
        return max(self.t_compute, self.t_memory)

    @property
    def bottleneck(self) -> str:
        return "compute" if self.t_compute >= self.t_memory else "memory"

    def as_dict(self) -> dict:
        return {
            "kernel": self.kernel,
            "shape": [self.b, self.r, self.w],
            "flops": self.flops,
            "bytes_hbm": self.bytes_hbm,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_model_s": self.t_model,
            "bottleneck": self.bottleneck,
        }


def ell_kernel_roofline(kernel: str, b: int, r: int, w: int, *,
                        peak_flops: float = PEAK_OPS,
                        mem_bw: float = HBM_BW) -> KernelRoofline:
    """Roofline bound for one ``(B, R, W)`` batched ELL kernel invocation
    (H100 SXM constants by default; on a slower part it is still a lower
    bound, which is how the checks use it)."""
    return KernelRoofline(kernel=kernel, b=int(b), r=int(r), w=int(w),
                          flops=ell_kernel_flops(kernel, b, r, w),
                          bytes_hbm=ell_kernel_bytes(kernel, b, r, w),
                          peak_flops=peak_flops, mem_bw=mem_bw)


__all__ = [
    "HBM_BW", "PEAK_OPS",
    "ELL_KERNELS", "ell_kernel_flops", "ell_kernel_bytes",
    "KernelRoofline", "ell_kernel_roofline",
]
