// Per-graph PIVOT in one launch: every greedy-MIS round and the PIVOT
// capture of k samples of one graph, hand-written for Hopper.
//
// Replaces the Pallas TPU kernel neighbor_min_ell (B3) of
// src/repro/kernels/neighbor_min.py:49 together with the round loop around
// it, the lax.while_loop of src/repro/core/mis.py:190-228, and the capture
// pass assign_to_min_rank_mis_neighbor (src/repro/core/mis.py:231-245). On
// the TPU the loop runs on the device inside one jit; the earlier port ran
// it on the host, one launch and a blocking `.any()` a round. Here the
// rounds run inside the kernel and nothing returns to the host until the
// labels are final.
//
// Inputs: the graph's CSR (row_offsets, n + 2 int32; dst, int32, sorted by
// src, padded with the sentinel n), ranks (k, n) int32, one permutation of
// 0..n-1 per sample, and eligible (n,) bool. Outputs, for each sample s,
// bit-identical to greedy_mis_parallel + assign_to_min_rank_mis_neighbor +
// the eligible restriction of the reference: status (k, n) int32
// (0 undecided, 1 in the MIS, 2 removed), labels (k, n) int32 and
// rounds (k,) int32, the rounds during which the sample still had
// undecided vertices.
//
// State: one int32 key per (sample, vertex): an undecided vertex holds its
// rank r >= 0, an MIS vertex ~r (negative, never INT_MIN), a removed or
// ineligible vertex INT_MIN. Read as unsigned, every decided key is above
// every rank, so a pass-A neighbour-min needs no status test. Beside it
// one byte a vertex flags the round's winners.
//
// A round is two passes with a barrier after each:
//  (A) every undecided vertex takes the min of its neighbours' keys as
//      unsigned (B3's function: the min rank over undecided eligible
//      neighbours) and flags itself a winner if its own rank is smaller;
//      the barrier also tells whether any vertex was undecided, and the
//      loop ends where none was;
//  (B) every winner becomes MIS and writes INT_MIN into its neighbours'
//      keys. Two winners are never adjacent and an MIS vertex's
//      neighbours are all decided, so every such write turns an undecided
//      or already removed vertex into a removed one: the reference's "an
//      undecided non-winner with a winner neighbour is removed", pushed
//      from the winners instead of pulled by every loser.
// Pass A reads only keys that pass B of the previous round wrote, behind a
// barrier. The capture then gives each eligible non-MIS vertex its min-rank
// MIS neighbour as a (rank, id) pair min: ranks are a permutation, so the
// pair's id is the reference's rank -> vertex inverse at that rank. Every
// reduction is a min, so the result does not depend on the order.
//
// Rows: a thread walks its vertex's CSR row directly, so a pass reads at
// most the 2m neighbour ids of the rows still in play and decided rows do
// no work; a row longer than kLongRow entries (a hub that is eligible) is
// walked by the whole warp, so one thread never walks a hub alone.
//
// What bounds it on an H100: bytes, and at small n the barriers. Each pass
// reads the offsets, the ids of the rows in play and the state; at the
// per-graph sizes (n up to 2^15, a few rounds of ~1 MB) that is a few
// microseconds of memory time, and at n <= 4,096 a round's two barriers and
// the dependent loads of a row (offset, then ids, then keys) take longer
// than its bytes. Two routes (mis_pivot.py mis_launch_plan, from the shape):
//
//  * block: one block per sample, its keys and flags in shared memory
//    (5 bytes a vertex, n up to 46,489 in 227 KB), the CSR read through
//    L1/L2, __syncthreads_or as pass A's barrier and undecided test. The
//    k samples run on k SMs at once.
//  * grid: one cooperative launch (cudaLaunchCooperativeKernel) of at most
//    the co-resident blocks, all k samples' items spread over it, the state
//    in device memory (it stays in the 50 MB L2; read with ld.global.cg so
//    no SM sees a stale L1 line), cooperative_groups grid sync as the
//    barrier. Each block ORs a k-bit mask of the samples it saw undecided
//    into a per-round flag; the flags alternate with the round's parity so
//    that resetting the next round's flag never races with reading this
//    one's. k <= 64 a launch; the wrapper launches more samples in
//    groups of 64, one after another.
//
// Window mode (mp_mis_window, kernels mis_window_block / mis_window_grid):
// the counterpart of Algorithm 1's _run_window (src/repro/core/phases.py
// :96-119, one jitted while_loop a window on the TPU). One sample; it starts
// from a status (n,) that earlier windows left and resolves every undecided
// vertex whose rank lies in [lo, hi), then returns the new status and the
// rounds this window took. Three differences from the instances above:
//  * the loop runs while an undecided vertex *in the window* remains;
//  * an undecided vertex outside the window keeps its rank as key but does
//    not compete: pass A folds (unsigned)(key - lo), which is below
//    span = hi - lo exactly for in-window undecided keys (decided keys are
//    negative, so above 2^31 - n, and n <= 2^30), so out-of-window and
//    decided neighbours are never the minimum;
//  * pass B removes only neighbours that are still undecided (in the window
//    or not), the reference's hit rule, so an MIS vertex of the input is
//    never overwritten; there is no capture (Algorithm 1 captures once, at
//    the end, with assign_to_min_rank_mis_neighbor).
// The mode is its own template instance (W = true); the instances with
// W = false compile to the code above, with lo = 0 folded away.
//
// A launch goes on the caller's stream, on the device index the caller
// names, and returns the first error: an invalid plan, a refused attribute,
// a cooperative launch larger than the card holds at once (never retried
// on the other route), or cudaGetLastError(). A sample that still has
// undecided vertices after n rounds (impossible for a permutation, where
// every round decides its least-ranked undecided vertex) stops there with
// rounds = n + 1 and those vertices left undecided, instead of looping.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int kRemoved = INT_MIN;         // key of a removed or ineligible vertex
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLongRow = 32;              // longer rows are walked by a warp
constexpr int kMaxThreads = 1024;
constexpr int kSmemMax = 232448;          // dynamic shared memory a block may use
constexpr int kSmemDefault = 49152;
constexpr int kRouteBlock = 0;
constexpr int kRouteGrid = 1;
constexpr int kMaxGridSamples = 64;       // one bit a sample in the round flags

struct Args {
  const int32_t* off;       // (n + 2,) CSR row offsets
  const int32_t* dst;       // neighbour ids
  const int32_t* ranks;     // (k, n)
  const uint8_t* elig;      // (n,)
  int32_t* status;          // (k, n)
  int32_t* labels;          // (k, n)
  int32_t* rounds;          // (k,)
  int32_t* key;             // grid route: (k, n) keys
  uint8_t* win;             // grid route: (k, n) winner flags
  unsigned long long* flags;  // grid route: two round flags
  int k;
  int n;
  const int32_t* status_in;   // window mode: (n,) status before the window
  unsigned lo;                // window mode: ranks in [lo, lo + span)
  unsigned span;
};

// Keys other threads write: through L2 on the grid route, where another
// SM may have written them since this SM last cached the line.
template <bool G>
__device__ __forceinline__ int ld_key(const int32_t* p) {
  if constexpr (G) {
    return __ldcg(p);
  } else {
    return *p;
  }
}

template <bool G>
__device__ __forceinline__ void st_key(int32_t* p, int x) {
  if constexpr (G) {
    __stcg(p, x);
  } else {
    *p = x;
  }
}

// Folds the neighbours of each lane's vertex where `mine` is set into an
// accumulator: fold(acc, key, u) per neighbour id u < n, with `key` the
// lane's sample's keys. A row of at most kLongRow entries is walked by its
// own thread; each longer one by the whole warp in turn, merged by `merge`
// and handed back to its lane. Every lane of the warp must call it.
template <bool G, typename Acc, typename Fold, typename Merge>
__device__ __forceinline__ Acc walk_row(bool mine, int b, int e, int32_t* key,
                                        int n, const int32_t* __restrict__ dst,
                                        Acc init, Fold fold, Merge merge) {
  const int lane = threadIdx.x & 31;
  Acc acc = init;
  const bool wide = mine && e - b > kLongRow;
  if (mine && !wide) {
    for (int i = b; i < e; ++i) {
      const int u = __ldg(dst + i);
      if ((unsigned)u < (unsigned)n) acc = fold(acc, key, u);
    }
  }
  unsigned todo = __ballot_sync(kFull, wide);
  while (todo) {
    const int l = __ffs(todo) - 1;
    todo &= todo - 1;
    const int bl = __shfl_sync(kFull, b, l);
    const int el = __shfl_sync(kFull, e, l);
    int32_t* kl = key;
    if constexpr (G) {
      kl = reinterpret_cast<int32_t*>(__shfl_sync(
          kFull, reinterpret_cast<unsigned long long>(key), l));
    }
    Acc part = init;
    for (int i = bl + lane; i < el; i += 32) {
      const int u = __ldg(dst + i);
      if ((unsigned)u < (unsigned)n) part = fold(part, kl, u);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      part = merge(part, __shfl_xor_sync(kFull, part, o));
    }
    if (lane == l) acc = part;
  }
  return acc;
}

// The whole computation for G = false (block route: this block's sample,
// state in shared memory skey/swin) or G = true (grid route: every
// sample's items over the grid, state in a.key/a.win); W = true is the
// window mode (one sample, no capture).
template <bool G, bool W>
__device__ __forceinline__ void mis_pivot_body(const Args& a, int32_t* skey,
                                               uint8_t* swin,
                                               unsigned long long* block_mask) {
  const int n = a.n;
  // An undecided key k competes iff (unsigned)k - lo < span.
  const unsigned lo = W ? a.lo : 0u;
  const unsigned span = W ? a.span : 0x80000000u;
  const int lane = threadIdx.x & 31;
  const long long total = G ? (long long)a.k * n : n;
  const long long first =
      (G ? (long long)blockIdx.x * blockDim.x : 0) + (threadIdx.x & ~31);
  const long long stride = G ? (long long)gridDim.x * blockDim.x : blockDim.x;

  // Calls f(valid, s, v, key, win) for each of this thread's items: a
  // warp's lanes take 32 consecutive (sample, vertex) items and step
  // together, so every lane reaches walk_row's warp-wide walks.
  auto for_items = [&](auto f) {
    for (long long base = first; base < total; base += stride) {
      const long long i = base + lane;
      const bool valid = i < total;
      int s = blockIdx.x;
      int v = (int)i;
      int32_t* key = skey;
      uint8_t* win = swin + v;
      if constexpr (G) {
        s = valid ? (int)(i / n) : 0;
        v = valid ? (int)(i - (long long)s * n) : 0;
        key = a.key + (long long)s * n;
        win = a.win + (valid ? i : 0);
      }
      f(valid, s, v, key, win);
    }
  };
  auto barrier = [&]() {
    if constexpr (G) {
      cg::this_grid().sync();
    } else {
      __syncthreads();
    }
  };

  // Keys from ranks and eligibility (window mode: from the status in);
  // no winners yet.
  for_items([&](bool valid, int s, int v, int32_t* key, uint8_t* win) {
    if (!valid) return;
    if constexpr (W) {
      const int st = __ldg(a.status_in + v);
      const int r = __ldg(a.ranks + v);
      st_key<G>(key + v, st == 0 ? r : (st == 1 ? ~r : kRemoved));
    } else {
      st_key<G>(key + v, __ldg(a.elig + v)
                             ? __ldg(a.ranks + (long long)s * n + v)
                             : kRemoved);
    }
    *win = 0;
  });
  if constexpr (G) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      __stcg(a.flags, 0ull);
      __stcg(a.flags + 1, 0ull);
      for (int s = 0; s < a.k; ++s) a.rounds[s] = 0;
      *block_mask = 0;
    } else if (threadIdx.x == 0) {
      *block_mask = 0;
    }
  }
  barrier();

  // Samples with undecided vertices at the last test (grid route).
  unsigned long long live =
      a.k >= kMaxGridSamples ? ~0ull : (1ull << a.k) - 1;
  int rounds = 0;
  for (;;) {
    // Pass A: winners among the undecided.
    unsigned long long seen = 0;
    for_items([&](bool valid, int s, int v, int32_t* key, uint8_t* win) {
      const bool in_play = valid && (!G || ((live >> s) & 1));
      const int kv = in_play ? ld_key<G>(key + v) : -1;
      const bool mine = W ? kv >= 0 && (unsigned)kv - lo < span : kv >= 0;
      const int b = mine ? __ldg(a.off + v) : 0;
      const int e = mine ? __ldg(a.off + v + 1) : 0;
      const unsigned m = walk_row<G>(
          mine, b, e, key, n, a.dst, kFull,
          [lo](unsigned acc, int32_t* kp, int u) {
            return min(acc, (unsigned)ld_key<G>(kp + u) - lo);
          },
          [](unsigned x, unsigned y) { return min(x, y); });
      if (mine) {
        seen |= G ? 1ull << s : 1ull;
        if ((unsigned)kv - lo < m) *win = 1;
      }
    });
    bool go;
    if constexpr (G) {
      // This round's flag: the OR of every thread's sample mask.
      const int par = rounds & 1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        seen |= __shfl_xor_sync(kFull, seen, o);
      }
      if (lane == 0 && seen) atomicOr(block_mask, seen);
      __syncthreads();
      if (threadIdx.x == 0) {
        if (*block_mask) atomicOr(a.flags + par, *block_mask);
        *block_mask = 0;
      }
      barrier();
      live = __ldcg(a.flags + par);
      go = live != 0;
      if (go && blockIdx.x == 0 && threadIdx.x == 0) {
        // Read by every block above, before the last barrier; set again
        // only after the next one.
        __stcg(a.flags + (par ^ 1), 0ull);
        for (unsigned long long m = live; m; m &= m - 1) {
          a.rounds[__ffsll((long long)m) - 1] += 1;
        }
      }
    } else {
      go = __syncthreads_or(seen != 0);
    }
    if (!go) break;
    if (++rounds > n) break;   // never for a permutation (see the note)

    // Pass B: winners join the MIS and remove their neighbours.
    for_items([&](bool valid, int s, int v, int32_t* key, uint8_t* win) {
      const bool w = valid && *win;
      const int b = w ? __ldg(a.off + v) : 0;
      const int e = w ? __ldg(a.off + v + 1) : 0;
      if (w) {
        *win = 0;
        st_key<G>(key + v, ~ld_key<G>(key + v));
      }
      walk_row<G>(
          w, b, e, key, n, a.dst, 0,
          [](int acc, int32_t* kp, int u) {
            // The window mode removes only undecided neighbours.
            if (!W || ld_key<G>(kp + u) >= 0) st_key<G>(kp + u, kRemoved);
            return acc;
          },
          [](int x, int) { return x; });
    });
    barrier();
  }

  // Capture: each eligible non-MIS vertex takes its min-rank MIS
  // neighbour, as the least (rank << 32 | id); everyone else itself.
  for_items([&](bool valid, int s, int v, int32_t* key, uint8_t* win) {
    const int kv = valid ? ld_key<G>(key + v) : kRemoved;
    const bool in_mis = kv < 0 && kv != kRemoved;
    const bool walk = !W && valid && !in_mis && __ldg(a.elig + v);
    const int b = walk ? __ldg(a.off + v) : 0;
    const int e = walk ? __ldg(a.off + v + 1) : 0;
    // ~key is the rank of an MIS neighbour, INT_MAX for a removed one
    // and above INT_MAX as unsigned for an undecided one.
    const unsigned long long best = walk_row<G>(
        walk, b, e, key, n, a.dst, ~0ull,
        [](unsigned long long acc, int32_t* kp, int u) {
          const unsigned c = (unsigned)~ld_key<G>(kp + u);
          return min(acc, ((unsigned long long)c << 32) | (unsigned)u);
        },
        [](unsigned long long x, unsigned long long y) { return min(x, y); });
    if (valid) {
      const long long o = (long long)s * n + v;
      if constexpr (!W) {
        a.labels[o] = walk && (best >> 32) < (unsigned long long)INT_MAX
                          ? (int)(unsigned)best
                          : v;
      }
      a.status[o] = kv >= 0 ? 0 : (kv == kRemoved ? 2 : 1);
    }
  });
  if constexpr (!G) {
    if (threadIdx.x == 0) a.rounds[blockIdx.x] = rounds;
  }
}

// Up to 1,024 threads and one block an SM, so up to 64 registers a
// thread: one block of 1,024 always fits an SM, which the grid route's
// plan counts on. (Without the minimum of one block the compiler aims at
// two and holds the grid kernel to 32 registers, where it spills.)
__global__ void __launch_bounds__(kMaxThreads, 1) mis_pivot_block(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  mis_pivot_body<false, false>(a, reinterpret_cast<int32_t*>(smem),
                               smem + 4 * (size_t)a.n, nullptr);
}

__global__ void __launch_bounds__(kMaxThreads, 1) mis_pivot_grid(Args a) {
  __shared__ unsigned long long block_mask;
  mis_pivot_body<true, false>(a, nullptr, nullptr, &block_mask);
}

__global__ void __launch_bounds__(kMaxThreads, 1) mis_window_block(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  mis_pivot_body<false, true>(a, reinterpret_cast<int32_t*>(smem),
                              smem + 4 * (size_t)a.n, nullptr);
}

__global__ void __launch_bounds__(kMaxThreads, 1) mis_window_grid(Args a) {
  __shared__ unsigned long long block_mask;
  mis_pivot_body<true, true>(a, nullptr, nullptr, &block_mask);
}

// Launches `block` or `grid` (the two instances of one mode) with the plan
// the caller gives, after the checks both entries share.
int launch(const Args& a, const void* block, const void* grid, int route,
           int threads, int blocks, int smem_bytes, int device,
           cudaStream_t s) {
  if (a.k < 1 || a.n < 0 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || blocks < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (route == kRouteBlock) {
    if (blocks != a.k || smem_bytes < 5LL * a.n || smem_bytes > kSmemMax) {
      return (int)cudaErrorInvalidValue;
    }
    if (smem_bytes > kSmemDefault) {
      const cudaError_t err = cudaFuncSetAttribute(
          block, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
      if (err != cudaSuccess) return (int)err;
    }
    void* params[] = {const_cast<Args*>(&a)};
    const cudaError_t err = cudaLaunchKernel(block, blocks, threads, params,
                                             (size_t)smem_bytes, s);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  if (route != kRouteGrid || a.k > kMaxGridSamples || smem_bytes != 0 ||
      a.flags == nullptr || (a.n > 0 && (a.key == nullptr || a.win == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  // Every block of a grid sync must be resident at once.
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, grid, threads, 0);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  if (blocks > per_sm * sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {const_cast<Args*>(&a)};
  err = cudaLaunchCooperativeKernel(grid, blocks, threads, params, 0, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// route: 0 = block (blocks == k, smem_bytes >= 5n), 1 = grid (k <= 64,
// blocks at most the co-resident blocks of `threads` threads); threads a
// multiple of 32 up to 1,024. From mis_pivot.py mis_launch_plan.
extern "C" int mp_mis_pivot(const void* row_offsets, const void* dst,
                            const void* ranks, const void* eligible,
                            void* status, void* labels, void* rounds,
                            void* key, void* win, void* flags, int k, int n,
                            int route, int threads, int blocks,
                            int smem_bytes, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  Args a{(const int32_t*)row_offsets, (const int32_t*)dst,
         (const int32_t*)ranks, (const uint8_t*)eligible, (int32_t*)status,
         (int32_t*)labels, (int32_t*)rounds, (int32_t*)key, (uint8_t*)win,
         (unsigned long long*)flags, k, n, nullptr, 0u, 0u};
  return launch(a, (const void*)mis_pivot_block, (const void*)mis_pivot_grid,
                route, threads, blocks, smem_bytes, device,
                (cudaStream_t)stream);
}

// Window mode: one sample, status_in -> status, rounds (1,); the undecided
// vertices with rank in [lo, lo + span) are resolved (lo >= 0, n <= 2^30).
// The plan as for mp_mis_pivot with k = 1.
extern "C" int mp_mis_window(const void* row_offsets, const void* dst,
                             const void* ranks, const void* status_in,
                             void* status, void* rounds, void* key, void* win,
                             void* flags, int n, int lo, int span, int route,
                             int threads, int blocks, int smem_bytes,
                             int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (lo < 0 || span < 0 || n > (1 << 30) ||
      (n > 0 && status_in == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a{(const int32_t*)row_offsets, (const int32_t*)dst,
         (const int32_t*)ranks, nullptr, (int32_t*)status, nullptr,
         (int32_t*)rounds, (int32_t*)key, (uint8_t*)win,
         (unsigned long long*)flags, 1, n, (const int32_t*)status_in,
         (unsigned)lo, (unsigned)span};
  return launch(a, (const void*)mis_window_block, (const void*)mis_window_grid,
                route, threads, blocks, smem_bytes, device,
                (cudaStream_t)stream);
}

extern "C" const char* mp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
