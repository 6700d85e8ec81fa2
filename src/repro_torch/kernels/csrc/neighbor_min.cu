// ELL gather-reductions of the batch PIVOT engine, hand-written for Hopper.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/neighbor_min.py:
//   neighbor_min_ell_batch (B1)  -> nm_neighbor_min
//   neighbor_min_ell       (B3)  -> nm_neighbor_min with B = 1, the round
//                                   step of the one-graph host loop (the
//                                   per-graph path runs mis_pivot.cu)
//   label_agree_ell_batch  (B2)  -> nm_label_agree
//
// Both kernels walk a (B, R, W) int32 ELL adjacency (pad id R) and gather
// per-graph state of width S = R + 1 through it:
//   neighbor_min: out[b,r] = min over w of ranks[b, ell[b,r,w]] where
//                 active[b, ell[b,r,w]], else INT32_MAX;
//   label_agree:  out[b,r] = #w with labels[b, ell[b,r,w]] == labels[b,r].
// An id outside [0, S) contributes nothing (INT32_MAX, no match).
//
// What bounds them on an H100: bytes. Each ELL slot is one 4-byte read
// followed by a gather and an integer compare, far below the ridge point.
// The ELL is streamed once; the gathers are random within one graph's state.
// Time is lost wherever a gather is a dependent load from L2: at the batch
// path's W = 4..32 a row is a handful of ids, so nothing else is in flight
// while a lane waits on its gathers (the l2 route alone reaches about a
// fifth of the byte bound at (B, R, W) = (768, 4096, 32)).
//
// Two routes, picked by the wrapper (neighbor_min.py launch_plan) from the
// shape (B, R, W, S) alone:
//
//  * staged (the batch path). One block of 1,024 threads on every SM, each
//    owning an even, contiguous run of the global rows b*R + r, so every
//    block is resident at once and none waits on a second wave. A block
//    walks its run a segment at a time: it copies the state of the
//    segment's graphs, state[g0*S : (g1+1)*S], into shared memory (B1
//    folds `active` into it: active ? rank : INT32_MAX), then reduces the
//    segment's rows with every gather a shared-memory read; an ELL pad,
//    which names slot R, is a broadcast. At small R a segment is many whole
//    graphs, at large R part of one; one graph's state is at most
//    (2^15 + 1) * 4 = 131 KB, under the 227 KB a block may use, and above
//    48 KB the launch first raises the kernel's dynamic shared-memory
//    limit. The ELL is read as int4 (W % 4 == 0, so rows are 16-byte
//    aligned): a group of TPR lanes owns a row, one int4 per lane, and
//    each group keeps kInFlight rows' loads in flight before its first
//    gather; the first of them are issued before the staging copy, which
//    reads int4 as well (from the 16-byte boundary at or below the slice,
//    so the state may start anywhere; only the ELL must be 16-byte
//    aligned), so the two overlap. Wide rows (W > 128) give each warp a
//    row and its lanes loop over it.
//  * l2: rows that are not 16-byte aligned (the one-graph form, whose W
//    is the raw max degree), state above 227 KB, launches too small to
//    repay staging, and a few long graphs spread over many blocks. A group
//    of pow2(W) lanes (up to a warp) owns a row, reads it as int32 and
//    gathers the state through the read-only path (__ldg); a graph's state
//    is hit by every block of that graph and stays in the 50 MB L2.
//
// Row reductions are shuffles inside a row's lanes, with no atomics, so the
// result is deterministic. Every launch goes on the caller's stream, on the
// device index the caller names (this library links its own CUDA runtime,
// whose current device is not PyTorch's), and returns the first error:
// an invalid plan, a refused attribute or cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 0x7fffffff;
constexpr int kThreads = 256;        // threads per block of the l2 route
constexpr int kMaxThreads = 1024;
constexpr int kInFlight = 4;         // loads per lane in flight
constexpr int kSmemMax = 232448;     // dynamic shared memory a block may use
constexpr int kSmemDefault = 49152;
constexpr int kRouteL2 = 0;
constexpr int kRouteStaged = 1;

int pow2_at_least(int x) {
  int t = 1;
  while (t < x && t < 32) t <<= 1;
  return t;
}

// ---------------------------------------------------------------------------
// l2 route: int32 loads, state gathered through L2.
// ---------------------------------------------------------------------------

template <int TPR>
__global__ void neighbor_min_l2(const int32_t* __restrict__ ell,
                                const int32_t* __restrict__ ranks,
                                const uint8_t* __restrict__ active,
                                int32_t* __restrict__ out,
                                long long total_rows, int R, int W, int S) {
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
__global__ void label_agree_l2(const int32_t* __restrict__ ell,
                               const int32_t* __restrict__ labels,
                               int32_t* __restrict__ out,
                               long long total_rows, int R, int W, int S) {
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
      count += (unsigned)id < (unsigned)S && __ldg(lb + id) == own;
    }
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) {
    count += __shfl_xor_sync(0xffffffffu, count, off, TPR);
  }
  if (row < total_rows && lane == 0) out[row] = count;
}

// ---------------------------------------------------------------------------
// staged route: state in shared memory, ELL as int4.
// ---------------------------------------------------------------------------

// Copies state[first : first + n) into sm[0 : n); for B1 (`active` given)
// each entry becomes active ? rank : INT32_MAX. The whole 16-byte chunks are
// read as int4 (and 4 bytes of `active`), kInFlight per thread at a time;
// the chunk that holds `first` starts at the 16-byte boundary below it, so
// the state itself may start anywhere (a row slice of a (B, S) tensor), and
// reads up to three entries before `first` that are not stored. `active`
// is read 4 bytes at a time where it lines up with those chunks, as it does
// whenever both tensors sit at the same offset from a 16-byte boundary,
// else byte by byte. The tail is scalar.
__device__ __forceinline__ void stage(int32_t* sm,
                                      const int32_t* __restrict__ state,
                                      const uint8_t* __restrict__ active,
                                      long long first, int n) {
  const int32_t* head = state + first;
  const int shift = (int)(((uintptr_t)head & 15) >> 2);
  const int whole = (shift + n) >> 2;        // int4 chunks inside the slice
  const int4* s4 = (const int4*)(head - shift);
  const uint8_t* ahead = active ? active + first : nullptr;
  const bool a_words =
      !active || (((uintptr_t)active + first - shift) & 3) == 0;
  const uint32_t* a4 =
      active && a_words ? (const uint32_t*)(ahead - shift) : nullptr;
  for (int c0 = threadIdx.x; c0 < whole; c0 += kInFlight * blockDim.x) {
    int4 v[kInFlight];
    uint32_t m[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int c = c0 + u * blockDim.x;
      if (c < whole) {
        v[u] = __ldg(s4 + c);
        if (!active) {
          m[u] = 0xffffffffu;
        } else if (a_words) {
          m[u] = __ldg(a4 + c);
        } else {
          m[u] = 0;
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int j = 4 * c + t - shift;
            if (j >= 0) m[u] |= (uint32_t)__ldg(ahead + j) << (8 * t);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int c = c0 + u * blockDim.x;
      if (c < whole) {
        const int x[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int j = 4 * c + t - shift;
          if (j >= 0) sm[j] = (m[u] >> (8 * t)) & 0xffu ? x[t] : kInf;
        }
      }
    }
  }
  const int tail = max(0, 4 * whole - shift);
  for (int j = tail + (int)threadIdx.x; j < n; j += blockDim.x) {
    const int x = __ldg(head + j);
    sm[j] = !active || __ldg(ahead + j) ? x : kInf;
  }
}

// Folds four neighbour ids into a row's partial result; `base` is the
// row's graph's offset in shared memory, `own` its label (B2).
template <bool AGREE>
__device__ __forceinline__ int fold4(int acc, const int4 ids,
                                     const int32_t* sm, int base, int own,
                                     int S) {
  const int id[4] = {ids.x, ids.y, ids.z, ids.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if ((unsigned)id[k] < (unsigned)S) {
      const int x = sm[base + id[k]];
      if (AGREE) {
        acc += x == own;
      } else {
        acc = min(acc, x);
      }
    }
  }
  return acc;
}

template <bool AGREE, int TPR>
__device__ __forceinline__ int reduce_row(int acc) {
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) {
    const int o = __shfl_xor_sync(0xffffffffu, acc, off, TPR);
    acc = AGREE ? acc + o : min(acc, o);
  }
  return acc;
}

// The body of both staged kernels: AGREE = false is B1 (state = ranks,
// `active` given), AGREE = true is B2 (state = labels, `active` null).
// The block owns rows [row0, row1) and walks them in segments of at most
// `stage_graphs` graphs, staging each segment's state before its rows.
template <bool AGREE, int TPR>
__device__ __forceinline__ void staged_body(
    const int4* __restrict__ ell, const int32_t* __restrict__ state,
    const uint8_t* __restrict__ active, int32_t* __restrict__ out,
    long long total_rows, int R, int W, int S, int rows_per_block,
    int stage_graphs) {
  extern __shared__ int32_t sm[];
  const int groups = blockDim.x / TPR;       // rows a pass of the block holds
  const int lane = threadIdx.x % TPR;
  const int group = threadIdx.x / TPR;
  const int chunks = W >> 2;                 // int4s per row
  const int4 none = make_int4(-1, -1, -1, -1);
  const int init = AGREE ? 0 : kInf;
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const long long row1 =
      min(row0 + (long long)rows_per_block, total_rows);

  for (long long seg0 = row0; seg0 < row1;) {
    const long long g0 = seg0 / R;
    const long long seg1 = min(row1, (g0 + stage_graphs) * R);
    const int first = (int)(seg0 - g0 * R);  // seg0's row in its graph
    const int nrows = (int)(seg1 - seg0);
    const int n_stage = (int)(((seg1 - 1) / R - g0 + 1) * S);
    if (seg0 > row0) __syncthreads();        // the last segment's reads

    // Shared-memory offset of a segment row's graph, and its own label.
    auto locate = [&](int lr, int& base, int& own) {
      const int rl = first + lr;             // row within the staged graphs
      const int gl = (int)((unsigned)rl / (unsigned)R);
      base = gl * S;
      own = AGREE && lr < nrows ? sm[base + rl - gl * R] : 0;
    };

    if (chunks <= TPR) {
      // Narrow rows: one int4 per lane; step s holds kInFlight rows of
      // each group, lr = (s * kInFlight + u) * groups + group.
      const int per_step = kInFlight * groups;
      const int steps = (nrows + per_step - 1) / per_step;
      int4 v[kInFlight];
      auto load = [&](int s) {
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int lr = (s * kInFlight + u) * groups + group;
          v[u] = lr < nrows && lane < chunks
                     ? __ldg(ell + (seg0 + lr) * chunks + lane)
                     : none;
        }
      };
      load(0);                               // in flight while staging
      stage(sm, state, active, g0 * S, n_stage);
      __syncthreads();
      for (int s = 0; s < steps; ++s) {
        if (s > 0) load(s);
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const int lr = (s * kInFlight + u) * groups + group;
          int base, own;
          locate(lr, base, own);
          const int acc = reduce_row<AGREE, TPR>(
              fold4<AGREE>(init, v[u], sm, base, own, S));
          if (lane == 0 && lr < nrows) out[seg0 + lr] = acc;
        }
      }
    } else {
      // Wide rows (TPR = 32): a warp per row, kInFlight int4s per lane in
      // flight at a time.
      stage(sm, state, active, g0 * S, n_stage);
      __syncthreads();
      for (int lr = group; lr < nrows; lr += groups) {
        const int4* e = ell + (seg0 + lr) * chunks;
        int base, own;
        locate(lr, base, own);
        int acc = init;
        for (int c0 = 0; c0 < chunks; c0 += kInFlight * TPR) {
          int4 v[kInFlight];
#pragma unroll
          for (int u = 0; u < kInFlight; ++u) {
            const int c = c0 + u * TPR + lane;
            v[u] = c < chunks ? __ldg(e + c) : none;
          }
#pragma unroll
          for (int u = 0; u < kInFlight; ++u) {
            acc = fold4<AGREE>(acc, v[u], sm, base, own, S);
          }
        }
        acc = reduce_row<AGREE, TPR>(acc);
        if (lane == 0) out[seg0 + lr] = acc;
      }
    }
    seg0 = seg1;
  }
}

// At most 1024 threads and so at most 64 registers a thread: four blocks
// of 256 threads, or one of 1024, always fit an SM's registers.
template <int TPR>
__global__ void __launch_bounds__(kMaxThreads)
    neighbor_min_staged(const int4* __restrict__ ell,
                        const int32_t* __restrict__ ranks,
                        const uint8_t* __restrict__ active,
                        int32_t* __restrict__ out, long long total_rows,
                        int R, int W, int S, int rows_per_block,
                        int stage_graphs) {
  staged_body<false, TPR>(ell, ranks, active, out, total_rows, R, W, S,
                          rows_per_block, stage_graphs);
}

template <int TPR>
__global__ void __launch_bounds__(kMaxThreads)
    label_agree_staged(const int4* __restrict__ ell,
                       const int32_t* __restrict__ labels,
                       const uint8_t* __restrict__ /*unused*/,
                       int32_t* __restrict__ out, long long total_rows,
                       int R, int W, int S, int rows_per_block,
                       int stage_graphs) {
  staged_body<true, TPR>(ell, labels, nullptr, out, total_rows, R, W, S,
                         rows_per_block, stage_graphs);
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

typedef void (*StagedFn)(const int4*, const int32_t*, const uint8_t*,
                         int32_t*, long long, int, int, int, int, int);

template <bool AGREE>
StagedFn staged_fn(int tpr) {
  switch (tpr) {
    case 1: return AGREE ? label_agree_staged<1> : neighbor_min_staged<1>;
    case 2: return AGREE ? label_agree_staged<2> : neighbor_min_staged<2>;
    case 4: return AGREE ? label_agree_staged<4> : neighbor_min_staged<4>;
    case 8: return AGREE ? label_agree_staged<8> : neighbor_min_staged<8>;
    case 16: return AGREE ? label_agree_staged<16> : neighbor_min_staged<16>;
    default: return AGREE ? label_agree_staged<32> : neighbor_min_staged<32>;
  }
}

template <bool AGREE>
int launch_staged(const void* ell, const void* state, const void* active,
                  void* out, long long B, int R, int W, int S,
                  int rows_per_block, int threads, int smem_bytes,
                  cudaStream_t s) {
  // int4 loads of the ELL: rows of W % 4 == 0 words from a 16-byte
  // aligned start. The state may start anywhere (stage() aligns itself).
  const bool aligned = ((uintptr_t)ell & 15) == 0;
  if (W % 4 != 0 || !aligned || rows_per_block <= 0 || threads % 32 != 0 ||
      threads <= 0 || threads > kMaxThreads || smem_bytes > kSmemMax ||
      smem_bytes < S * 4) {
    return (int)cudaErrorInvalidValue;
  }
  const long long total = B * (long long)R;
  const unsigned int grid =
      (unsigned int)((total + rows_per_block - 1) / rows_per_block);
  const StagedFn fn = staged_fn<AGREE>(pow2_at_least(W / 4));
  if (smem_bytes > kSmemDefault) {
    // Above 48 KB a block's dynamic shared memory has to be allowed first.
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  fn<<<grid, threads, smem_bytes, s>>>(
      (const int4*)ell, (const int32_t*)state, (const uint8_t*)active,
      (int32_t*)out, total, R, W, S, rows_per_block, smem_bytes / (S * 4));
  return (int)cudaGetLastError();
}

// The l2 kernels map kThreads / TPR rows to a block; the plan must agree.
bool l2_plan_ok(int W, int rows_per_block, int threads) {
  return threads == kThreads &&
         rows_per_block == kThreads / pow2_at_least(W);
}

}  // namespace

#define NM_L2_CASE(TPR_VALUE, KERNEL, ...)                                 \
  case TPR_VALUE:                                                          \
    KERNEL<TPR_VALUE><<<grid, kThreads, 0, s>>>(__VA_ARGS__);              \
    break;

// route: 0 = l2, 1 = staged; rows_per_block, threads and smem_bytes from
// the plan (neighbor_min.py launch_plan).
extern "C" int nm_neighbor_min(const void* ell, const void* ranks,
                               const void* active, void* out, long long B,
                               int R, int W, int S, int route,
                               int rows_per_block, int threads,
                               int smem_bytes, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const long long total = B * (long long)R;
  if (total == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (route == kRouteStaged) {
    return launch_staged<false>(ell, ranks, active, out, B, R, W, S,
                                rows_per_block, threads, smem_bytes, s);
  }
  if (route != kRouteL2 || !l2_plan_ok(W, rows_per_block, threads)) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned int grid =
      (unsigned int)((total + rows_per_block - 1) / rows_per_block);
  const int32_t* e = (const int32_t*)ell;
  const int32_t* rk = (const int32_t*)ranks;
  const uint8_t* ac = (const uint8_t*)active;
  int32_t* o = (int32_t*)out;
  switch (pow2_at_least(W)) {
    NM_L2_CASE(1, neighbor_min_l2, e, rk, ac, o, total, R, W, S)
    NM_L2_CASE(2, neighbor_min_l2, e, rk, ac, o, total, R, W, S)
    NM_L2_CASE(4, neighbor_min_l2, e, rk, ac, o, total, R, W, S)
    NM_L2_CASE(8, neighbor_min_l2, e, rk, ac, o, total, R, W, S)
    NM_L2_CASE(16, neighbor_min_l2, e, rk, ac, o, total, R, W, S)
    default:
      neighbor_min_l2<32><<<grid, kThreads, 0, s>>>(e, rk, ac, o, total, R,
                                                     W, S);
  }
  return (int)cudaGetLastError();
}

extern "C" int nm_label_agree(const void* ell, const void* labels, void* out,
                              long long B, int R, int W, int S, int route,
                              int rows_per_block, int threads, int smem_bytes,
                              int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  const long long total = B * (long long)R;
  if (total == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (route == kRouteStaged) {
    return launch_staged<true>(ell, labels, nullptr, out, B, R, W, S,
                               rows_per_block, threads, smem_bytes, s);
  }
  if (route != kRouteL2 || !l2_plan_ok(W, rows_per_block, threads)) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned int grid =
      (unsigned int)((total + rows_per_block - 1) / rows_per_block);
  const int32_t* e = (const int32_t*)ell;
  const int32_t* lb = (const int32_t*)labels;
  int32_t* o = (int32_t*)out;
  switch (pow2_at_least(W)) {
    NM_L2_CASE(1, label_agree_l2, e, lb, o, total, R, W, S)
    NM_L2_CASE(2, label_agree_l2, e, lb, o, total, R, W, S)
    NM_L2_CASE(4, label_agree_l2, e, lb, o, total, R, W, S)
    NM_L2_CASE(8, label_agree_l2, e, lb, o, total, R, W, S)
    NM_L2_CASE(16, label_agree_l2, e, lb, o, total, R, W, S)
    default:
      label_agree_l2<32><<<grid, kThreads, 0, s>>>(e, lb, o, total, R, W, S);
  }
  return (int)cudaGetLastError();
}

// The entries' argument list: 2 takes the launch plan (route,
// rows_per_block, threads, smem_bytes) before device and stream. The source
// before the launch plan exports no version. Bump it with any change to the
// entries' arguments or to what the plan's fields mean.
extern "C" int nm_abi_version() { return 2; }

extern "C" const char* nm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
