// Neighbourhood agreement of the precluster method, hand-written for Hopper.
//
// Replaces the agreement pass of the precluster rounds body
// (src/repro/core/programs.py:187-214, `_precluster_rounds_body`), which the
// reference runs as XLA ops, not as a Pallas kernel -> ag_agreement.
//
// For a (B, R, W) int32 ELL adjacency (pad id R), per graph b, row u and
// slot w with neighbour v = ell[b,u,w] != R:
//   du = #non-pad ids of row u, dv = #non-pad ids of row v,
//   common = #non-pad ids x of row v that also appear in row u,
//   agree  = beta_den * (du + dv - 2 * common - 2)
//            < beta_num * (max(du, dv) + 1),
// and out[b,u,w] = agree ? v : R (R where v == R). An id v outside [0, R]
// reads as a row of pads (dv = common = 0), as the reference's clamped
// gather does; the ELL contract has none.
//
// What bounds it on an H100: the reference (and the plain version in
// kernels/ref.py) materialises every slot's candidate list, a (B, R, W, W)
// intermediate, and sorts and searches it: at (768, 4096, 32) that is 3.2
// billion candidates and 99 % of a precluster bucket program's time on the
// card. The function itself needs each row u read once, each neighbour row
// v read once per slot that names it (the bytes are data-dependent: the
// non-pad slots times W ids), and one output word a slot. So the design
// keeps nothing but the output in device memory:
//  * one warp per row u, rows strided over a grid that fills the card;
//  * row u's ids become a bitmap of R bits in the warp's own slice of
//    shared memory (R <= 2^15: at most 4 KB a warp), set with shared
//    atomics and cleared word by word after the row, so a membership test
//    is one shared read;
//  * for each non-pad slot the warp reads row v coalesced (32 ids a load)
//    and counts dv and common with two ballots, so no lane walks a row
//    alone and a pad slot costs one broadcast read.
// The result is integer and independent of the order of the work, so it
// equals the plain version bit for bit.
//
// Every launch goes on the caller's stream, on the device index the caller
// names (this library links its own CUDA runtime), and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                  // warps a block
constexpr int kMaxRows = 1 << 15;          // the batch engine's MAX_ROWS

__device__ __forceinline__ bool in_row(const unsigned* bits, int x, int R) {
  return (unsigned)x < (unsigned)R && ((bits[x >> 5] >> (x & 31)) & 1u);
}

__global__ void __launch_bounds__(32 * kWarps)
agreement_kernel(const int32_t* __restrict__ ell, int32_t* __restrict__ out,
                 long long total, int R, int W, int beta_num, int beta_den) {
  extern __shared__ unsigned smem_bits[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int words = (R + 31) >> 5;
  unsigned* bits = smem_bits + warp * words;
  for (int i = lane; i < words; i += 32) bits[i] = 0u;
  __syncwarp();

  const long long stride = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + warp; row < total;
       row += stride) {
    const long long b = row / R;
    const int32_t* base = ell + b * R * W;     // graph b's rows
    const int32_t* ru = ell + row * W;
    int32_t* ou = out + row * W;

    // Row u: its degree, and its ids into the bitmap.
    int du = 0;
    for (int c = 0; c < W; c += 32) {
      const int w = c + lane;
      const int x = w < W ? ru[w] : R;
      du += __popc(__ballot_sync(0xffffffffu, x != R));
      if ((unsigned)x < (unsigned)R) atomicOr(&bits[x >> 5], 1u << (x & 31));
    }
    __syncwarp();

    // Each slot: row v read by the whole warp, dv and common by ballots.
    for (int c = 0; c < W; c += 32) {
      int res = R;
      const int n = min(32, W - c);
      for (int j = 0; j < n; ++j) {
        const int v = ru[c + j];               // the same for every lane
        if (v == R) continue;
        int dv = 0, common = 0;
        if ((unsigned)v < (unsigned)R) {
          const int32_t* rv = base + (long long)v * W;
          for (int c2 = 0; c2 < W; c2 += 32) {
            const int w2 = c2 + lane;
            const int y = w2 < W ? rv[w2] : R;
            dv += __popc(__ballot_sync(0xffffffffu, y != R));
            common += __popc(__ballot_sync(0xffffffffu, in_row(bits, y, R)));
          }
        }
        const int sym_diff = du + dv - 2 * common - 2;
        const bool agree = beta_den * sym_diff < beta_num * (max(du, dv) + 1);
        if (lane == j) res = agree ? v : R;
      }
      if (lane < n) ou[c + lane] = res;
    }
    __syncwarp();

    // Clear the words row u set (every id of row u lies in one of them).
    for (int c = 0; c < W; c += 32) {
      const int w = c + lane;
      const int x = w < W ? ru[w] : R;
      if ((unsigned)x < (unsigned)R) bits[x >> 5] = 0u;
    }
    __syncwarp();
  }
}

}  // namespace

// ell, out: (B, R, W) int32, contiguous; blocks: the grid (the wrapper
// fills the card). Returns cudaErrorInvalidValue for R outside
// [1, 2^15] or W < 1, else cudaGetLastError().
extern "C" int ag_agreement(const void* ell, void* out, long long B, int R,
                            int W, int beta_num, int beta_den, int blocks,
                            int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (R < 1 || R > kMaxRows || W < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const long long total = B * (long long)R;
  if (total == 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)kWarps * ((R + 31) / 32) * sizeof(unsigned);
  agreement_kernel<<<blocks, 32 * kWarps, smem, (cudaStream_t)stream>>>(
      (const int32_t*)ell, (int32_t*)out, total, R, W, beta_num, beta_den);
  return (int)cudaGetLastError();
}

extern "C" const char* ag_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
