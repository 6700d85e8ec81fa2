// Peak rate of mma.sync on this card, for the bounds of kernel B4
// (src/repro_torch/kernels/csrc/flash_attention.cu): TF32 m16n8k8 and
// bf16 m16n8k16, f32 accumulation, register operands only (no memory
// traffic), CHAINS independent accumulators a warp. Built and run by
// scripts/mma_peak.py.

#include <cuda_runtime.h>
#include <stdint.h>

template <int CHAINS, bool TF32>
__global__ void mma_loop(float* out, int iters, uint32_t seed) {
  float c[CHAINS][4] = {};
  const uint32_t a0 = seed ^ threadIdx.x, a1 = a0 * 3u, a2 = a0 * 5u,
                 a3 = a0 * 7u, b0 = a0 * 11u, b1 = a0 * 13u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) {
      if constexpr (TF32)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// kind: 0 = TF32 m16n8k8, 1 = bf16 m16n8k16; chains: 1, 2, 4 or 8.
// Returns the launch's error code; the caller times and synchronises.
extern "C" int mma_peak(int kind, int chains, int blocks, int threads,
                        int iters, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define MMA_CASE(N)                                                        \
  case N:                                                                  \
    if (kind == 0)                                                         \
      mma_loop<N, true><<<blocks, threads, 0, s>>>(out, iters, 1u);        \
    else                                                                   \
      mma_loop<N, false><<<blocks, threads, 0, s>>>(out, iters, 1u);       \
    break;
  switch (chains) {
    MMA_CASE(1)
    MMA_CASE(2)
    MMA_CASE(4)
    MMA_CASE(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef MMA_CASE
  return (int)cudaGetLastError();
}
