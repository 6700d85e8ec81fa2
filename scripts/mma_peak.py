#!/usr/bin/env python3
"""Peak rate of ``mma.sync`` on the card: the ceiling of kernel B4's MMAs.

Run from the root of a checkout on a machine with one CUDA card:

    python3 scripts/mma_peak.py

Builds ``scripts/mma_peak.cu`` with ``nvcc`` and times, with CUDA events,
TF32 m16n8k8 and bf16 m16n8k16 MMAs with f32 accumulation on register
operands (no memory traffic), 1 to 8 independent accumulators a warp, at
1 to 16 warps an SM, in TFLOP/s (2 flops a multiply-add). B4 issues
``mma.sync``, not ``wgmma``, so this and not the card's dense tensor peak
(495 TF32 / 989 bf16 TFLOP/s) is what its MMAs can reach.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build, measure  # noqa: E402

FLOPS = {0: 2 * 16 * 8 * 8, 1: 2 * 16 * 8 * 16}   # per warp-level MMA
NAMES = {0: "tf32 m16n8k8", 1: "bf16 m16n8k16"}


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_peak: no CUDA device", file=sys.stderr)
        return 2
    out_dir = _build.BUILD_DIR / "scripts"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libmma_peak.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path),
                    str(ROOT / "scripts" / "mma_peak.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.mma_peak.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    lib.mma_peak.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"card: {measure.card_line()}, {sms} SMs")
    iters = 4096
    for kind in (0, 1):
        for warps in (4, 8, 16):
            row = []
            for chains in (1, 2, 4, 8):
                blocks, threads = sms * warps // 4, 128
                out = torch.empty(blocks * threads, device="cuda")
                stream = torch.cuda.current_stream().cuda_stream

                def run():
                    code = lib.mma_peak(kind, chains, blocks, threads, iters,
                                        out.data_ptr(), stream)
                    if code:
                        raise RuntimeError(f"mma_peak launch failed ({code})")
                run()
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(5):
                    run()
                end.record()
                end.synchronize()
                sec = start.elapsed_time(end) / 5 / 1e3
                mmas = blocks * threads // 32 * iters * chains
                tflops = mmas * FLOPS[kind] / sec / 1e12
                row.append(f"{chains} acc {tflops:.1f}")
            print(f"  {NAMES[kind]}, {warps} warps an SM: TFLOP/s with "
                  + ", ".join(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
