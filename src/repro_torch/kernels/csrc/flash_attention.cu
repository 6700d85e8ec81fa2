// Blocked (flash) attention forward with GQA and a causal mask, hand-written
// for Hopper.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py
// (`flash_attention`, body `_fa_kernel`) together with the padding wrapper
// of src/repro/kernels/ops.py (`flash_attention`) -> fa_forward.
//
// Computes, for q (B, H, Sq, D) and k, v (B, KH, Sk, D), all contiguous:
//   o[b,h,i] = sum_j softmax_j(s[i,j]) v[b, h / (H/KH), j],
//   s[i,j]   = (q[b,h,i] * 1/sqrt(D)) . k[b, h / (H/KH), j],
// masked to -1e30 where j >= Sk, or, when causal, where
// j > i + row_offset (row_offset = Sk - Sq). The softmax is the online one
// of _fa_kernel: per row a running max m, a running sum l and an f32
// accumulator, rescaled by exp(m_prev - m_new) at each key tile; a row whose
// l is 0 gives 0. Inputs are f32 or bf16; all math is f32 (no TF32); the
// output has the input's type. D is 16, 32, 64 or 128.
//
// What bounds it on an H100: with f32 inputs the f32 FMA rate outside the
// tensor cores (67 TFLOP/s; TF32 would break the 2e-5 tolerance), with
// bf16 inputs the dense bf16 tensor rate (989 TFLOP/s) that a later
// tensor-core version could reach. Both are also bounded by bytes: q, k, v
// read once and o written once at 3.35 TB/s.
//
// What the design does about it (simple first; wgmma/mma.sync, TMA and one
// K/V tile shared by a GQA group come later):
//  * One block of 256 threads per (query tile of 64 rows, query head,
//    batch). The TPU's sequential KV grid axis becomes a loop inside the
//    block; nothing carries over between blocks.
//  * The block stages its Q tile (pre-scaled) and each 64-row K/V tile in
//    shared memory as f32, so the score and value products read no device
//    memory; rows are padded to D + 1 floats so that the column reads of
//    the score product hit 32 different banks.
//  * A 16 x 16 thread grid: each thread computes a 4 x 4 block of the 64 x
//    64 score tile in registers (rows 4*ty..4*ty+3, columns tx + 16*j) and
//    owns the same 4 rows x D/16 columns of the output accumulator. The
//    row max and row sum reduce over the 16 tx lanes with shuffles, so
//    every thread holds (m, l) of its rows and rescales its accumulator
//    without a second pass. P goes through shared memory to the value
//    product.
//  * Causal: the loop stops after the last key tile that any row of the Q
//    tile can see. Sq and Sk are masked in the kernel (rows past Sq are not
//    stored, keys past Sk score -1e30), so no shape needs host padding and
//    no shape falls back to another path.
//
// Every launch goes on the caller's stream, on the device index the caller
// names (this library links its own CUDA runtime, whose current device is
// not PyTorch's), and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kRows = 4;         // score rows per thread
constexpr int kCols = 4;         // score columns per thread
constexpr float kNegInf = -1e30f;
static_assert(kBQ == kBK && kBQ == 16 * kRows && kBK == 16 * kCols,
              "one 64-row tile shape; a 16 x 16 thread grid covers it");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

constexpr size_t smem_bytes(int d) {
  return sizeof(float) *
         ((size_t)(kBQ + 2 * kBK) * (d + 1) + (size_t)kBQ * (kBK + 1));
}

// Stages a 64-row tile (kBQ == kBK) of a contiguous (S, D) slice as f32
// rows of D + 1 floats; rows at or past rows_left read as 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst,
                                          const T* __restrict__ src,
                                          int rows_left, float scale) {
  // The tile is one contiguous run of 64 * D elements: consecutive threads
  // read consecutive elements.
  for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = r < rows_left ? to_f32(src[i]) * scale : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_forward_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int H, int KH,
                  int Sq, int Sk, int causal, int row_offset, float scale) {
  static_assert(D % 16 == 0, "D must be a multiple of 16");
  constexpr int LD = D + 1;
  constexpr int LP = kBK + 1;
  constexpr int CO = D / 16;     // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * LD;
  float* sV = sK + kBK * LD;
  float* sP = sV + kBK * LD;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KH);
  const T* qb = q + ((long long)(b * H + h) * Sq + q0) * D;
  const T* kb = k + (long long)(b * KH + kvh) * Sk * D;
  const T* vb = v + (long long)(b * KH + kvh) * Sk * D;

  load_tile<T, D>(sQ, qb, Sq - q0, scale);

  float m[kRows], l[kRows], acc[kRows][CO];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CO; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (Sk + kBK - 1) / kBK;
  if (causal) {
    const int last_row = min(q0 + kBQ, Sq) - 1 + row_offset;
    n_tiles = min(n_tiles, last_row / kBK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile<T, D>(sK, kb + (long long)k0 * D, Sk - k0, 1.f);
    load_tile<T, D>(sV, vb + (long long)k0 * D, Sk - k0, 1.f);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[kRows], ka[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qa[i] = sQ[(ty * kRows + i) * LD + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) ka[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty * kRows + i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = k0 + tx + 16 * j;
        if (col >= Sk || (causal && col > row + row_offset)) s[i][j] = kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off, 16));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        sP[(ty * kRows + i) * LP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off, 16);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CO; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pa[kRows], va[CO];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pa[i] = sP[(ty * kRows + i) * LP + j];
#pragma unroll
      for (int c = 0; c < CO; ++c) va[c] = sV[j * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < CO; ++c) acc[i][c] = fmaf(pa[i], va[c], acc[i][c]);
    }
  }

  T* ob = o + ((long long)(b * H + h) * Sq + q0) * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i;
    if (q0 + r >= Sq) continue;
    const float inv = 1.f / (l[i] == 0.f ? 1.f : l[i]);
#pragma unroll
    for (int c = 0; c < CO; ++c)
      store(ob + (long long)r * D + tx + 16 * c, acc[i][c] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KH, int Sq, int Sk, int causal, int row_offset,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  // Above 48 KB a block's dynamic shared memory has to be allowed first.
  cudaError_t err = cudaFuncSetAttribute(
      fa_forward_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  const float scale = 1.f / sqrtf((float)D);
  fa_forward_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, KH, Sq, Sk, causal,
      row_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int B,
               int H, int KH, int Sq, int Sk, int D, int causal, int off,
               cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, KH, Sq, Sk, causal, off, s);
    case 32: return launch<T, 32>(q, k, v, o, B, H, KH, Sq, Sk, causal, off, s);
    case 64: return launch<T, 64>(q, k, v, o, B, H, KH, Sq, Sk, causal, off, s);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, KH, Sq, Sk, causal, off, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The wrapper has checked shapes, types,
// contiguity, D in {16, 32, 64, 128}, H % KH == 0, Sk >= 1 and, when causal,
// Sk >= Sq (row_offset >= 0, so every row sees at least key 0).
extern "C" int fa_forward(const void* q, const void* k, const void* v, void* o,
                          int B, int H, int KH, int Sq, int Sk, int D,
                          int causal, int dtype, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (B == 0 || H == 0 || Sq == 0) return (int)cudaGetLastError();
  const int row_offset = causal ? Sk - Sq : 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, o, B, H, KH, Sq, Sk, D, causal,
                             row_offset, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, B, H, KH, Sq, Sk, D, causal,
                                     row_offset, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* fa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
