// ELL gather-reductions of the batch PIVOT engine, hand-written for Hopper.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/neighbor_min.py:
//   neighbor_min_ell_batch (B1)  -> nm_neighbor_min
//   neighbor_min_ell       (B3)  -> nm_neighbor_min with B = 1
//   label_agree_ell_batch  (B2)  -> nm_label_agree
//
// Both kernels walk a (B, R, W) int32 ELL adjacency (pad id R) and gather
// per-graph state of width S = R + 1 through it:
//   neighbor_min: out[b,r] = min over w of ranks[b, ell[b,r,w]] where
//                 active[b, ell[b,r,w]], else INT32_MAX;
//   label_agree:  out[b,r] = #w with labels[b, ell[b,r,w]] == labels[b,r].
// An id outside [0, S) reads as the pad slot (inactive / label -1).
//
// What bounds them on an H100: bytes. Each ELL slot is one 4-byte read and
// one or two dependent gathers for a single integer compare, so the
// arithmetic intensity is far below the ridge point. The ELL is streamed
// once; the gathers are random within one graph's state.
//
// What the design does about it:
//  * A group of TPR lanes (a power of two up to a warp, picked from W) owns
//    one row, so neighbouring lanes read neighbouring ELL words and every
//    row's loads coalesce, from W = 4 up to W = 4096 (a warp loops).
//  * The TPU kernel stages one graph's state in VMEM. At R = 2^15 two int32
//    vectors of R + 1 entries are 262 KB, above the 227 KB a block may use,
//    so the state is read from global memory through the read-only path
//    (__ldg). One graph's state is at most 160 KB and is hit by every row
//    block of that graph, so it stays resident in the 50 MB L2.
//  * `active` arrives as bool and is read as uint8; the rank gather is
//    skipped for inactive neighbours.
//  * The row reduction is a shuffle tree inside the TPR-lane group; no
//    shared memory and no atomics, so the result is deterministic.
//
// Every launch goes on the caller's stream, on the device index the caller
// names (this library links its own CUDA runtime, whose current device is
// not PyTorch's), and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 0x7fffffff;
constexpr int kThreads = 256;

template <int TPR>
__global__ void neighbor_min_kernel(const int32_t* __restrict__ ell,
                                    const int32_t* __restrict__ ranks,
                                    const uint8_t* __restrict__ active,
                                    int32_t* __restrict__ out,
                                    long long total_rows, int R, int W,
                                    int S) {
  const int lane = threadIdx.x % TPR;
  const long long row =
      (long long)blockIdx.x * (kThreads / TPR) + threadIdx.x / TPR;
  int best = kInf;
  if (row < total_rows) {
    const long long b = row / R;
    const int32_t* e = ell + row * (long long)W;
    const int32_t* rk = ranks + b * (long long)S;
    const uint8_t* ac = active + b * (long long)S;
    for (int w = lane; w < W; w += TPR) {
      const int id = e[w];
      if ((unsigned)id < (unsigned)S && __ldg(ac + id)) {
        best = min(best, __ldg(rk + id));
      }
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) {
    best = min(best, __shfl_xor_sync(0xffffffffu, best, off, TPR));
  }
  if (row < total_rows && lane == 0) out[row] = best;
}

template <int TPR>
__global__ void label_agree_kernel(const int32_t* __restrict__ ell,
                                   const int32_t* __restrict__ labels,
                                   int32_t* __restrict__ out,
                                   long long total_rows, int R, int W,
                                   int S) {
  const int lane = threadIdx.x % TPR;
  const long long row =
      (long long)blockIdx.x * (kThreads / TPR) + threadIdx.x / TPR;
  int count = 0;
  if (row < total_rows) {
    const long long b = row / R;
    const int r = (int)(row - b * R);
    const int32_t* e = ell + row * (long long)W;
    const int32_t* lb = labels + b * (long long)S;
    const int own = __ldg(lb + r);
    for (int w = lane; w < W; w += TPR) {
      const int id = e[w];
      const int nbr = (unsigned)id < (unsigned)S ? __ldg(lb + id) : -1;
      count += (nbr == own);
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) {
    count += __shfl_xor_sync(0xffffffffu, count, off, TPR);
  }
  if (row < total_rows && lane == 0) out[row] = count;
}

int lanes_per_row(int W) {
  int t = 1;
  while (t < W && t < 32) t <<= 1;
  return t;
}

unsigned int grid_for(long long total_rows, int tpr) {
  const long long rows_per_block = kThreads / tpr;
  return (unsigned int)((total_rows + rows_per_block - 1) / rows_per_block);
}

}  // namespace

#define NM_DISPATCH(TPR_VALUE, KERNEL, ...)                                \
  case TPR_VALUE:                                                          \
    KERNEL<TPR_VALUE><<<grid, kThreads, 0, s>>>(__VA_ARGS__);              \
    break;

extern "C" int nm_neighbor_min(const void* ell, const void* ranks,
                               const void* active, void* out, long long B,
                               int R, int W, int S, int device,
                               void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const long long total = B * (long long)R;
  if (total == 0) return (int)cudaGetLastError();
  const int tpr = lanes_per_row(W);
  const unsigned int grid = grid_for(total, tpr);
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* e = (const int32_t*)ell;
  const int32_t* rk = (const int32_t*)ranks;
  const uint8_t* ac = (const uint8_t*)active;
  int32_t* o = (int32_t*)out;
  switch (tpr) {
    NM_DISPATCH(1, neighbor_min_kernel, e, rk, ac, o, total, R, W, S)
    NM_DISPATCH(2, neighbor_min_kernel, e, rk, ac, o, total, R, W, S)
    NM_DISPATCH(4, neighbor_min_kernel, e, rk, ac, o, total, R, W, S)
    NM_DISPATCH(8, neighbor_min_kernel, e, rk, ac, o, total, R, W, S)
    NM_DISPATCH(16, neighbor_min_kernel, e, rk, ac, o, total, R, W, S)
    default:
      neighbor_min_kernel<32><<<grid, kThreads, 0, s>>>(e, rk, ac, o, total,
                                                         R, W, S);
  }
  return (int)cudaGetLastError();
}

extern "C" int nm_label_agree(const void* ell, const void* labels, void* out,
                              long long B, int R, int W, int S, int device,
                              void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const long long total = B * (long long)R;
  if (total == 0) return (int)cudaGetLastError();
  const int tpr = lanes_per_row(W);
  const unsigned int grid = grid_for(total, tpr);
  cudaStream_t s = (cudaStream_t)stream;
  const int32_t* e = (const int32_t*)ell;
  const int32_t* lb = (const int32_t*)labels;
  int32_t* o = (int32_t*)out;
  switch (tpr) {
    NM_DISPATCH(1, label_agree_kernel, e, lb, o, total, R, W, S)
    NM_DISPATCH(2, label_agree_kernel, e, lb, o, total, R, W, S)
    NM_DISPATCH(4, label_agree_kernel, e, lb, o, total, R, W, S)
    NM_DISPATCH(8, label_agree_kernel, e, lb, o, total, R, W, S)
    NM_DISPATCH(16, label_agree_kernel, e, lb, o, total, R, W, S)
    default:
      label_agree_kernel<32><<<grid, kThreads, 0, s>>>(e, lb, o, total, R, W,
                                                        S);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* nm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
