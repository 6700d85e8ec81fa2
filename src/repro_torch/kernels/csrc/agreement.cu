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
// gather does; the ELL contract has none. With `replicas` = k the batch is
// groups of k entries that carry one graph (the k best-of-k samples of a
// bucket): out[b] = agreement(ell[(b / k) * k]), computed once a group and
// stored to its k entries.
//
// What bounds it on an H100: the bytes the function must move are the
// groups' ELLs read once and every entry's output written once; every
// other read (row u's ids, the rows v of its slots) can come from the
// chip. Non-pad slots are few (8 % of the slots of the smoke's buckets,
// 2.7 a row), so the cost is the latency of the dependent reads of a row:
// row u, then the rows v its ids name, then the predicate. The design:
//  * one pass per graph, not per replica: a group's first entry is read,
//    and each output word is stored to the k entries, coalesced;
//  * warp route: a warp per row u, rows strided over a grid that fills the
//    card, the next row's ids loaded while the current one is walked.
//    Lane w holds id w of row u in a register (ceil(W/32) of them up to
//    W = 128; wider rows are read a window of 32 ids at a time). A ballot
//    gives the non-pad slots; the warp walks only their set bits and gets
//    each id v by a shuffle. Row u's ids become a bitmap of R bits in the
//    warp's own slice of shared memory (R <= 2^15: at most 4 KB), set with
//    shared atomics and cleared from the same registers, so a membership
//    test is one shared read;
//  * several rows v in flight: at W <= 16 the warp splits into 32 / L lane
//    groups (L = pow2(W)), each reading a different slot's row v, counted
//    with ballots masked to the group; and each lane issues the loads of P
//    slots before the ballots of the first (P = 4 at L = 32, 2 at 16, 1
//    below), so a warp has 4 to 8 independent reads outstanding;
//  * smem route (W <= 32): a block of 16 warps takes one group's graph and
//    stages it in shared memory, read from the ELL in one pass with eight
//    loads a lane in flight: every row compacted to its non-pad ids as
//    16-bit values (R <= 2^15) in ascending order, with its offset, degree
//    and rotation. The walk above spends a warp step on each slot, most of
//    whose lanes read pads; here a lane takes a slot (u, v) and counts
//    common by merging the two ascending rows, the slots of 32 rows dealt
//    32 at a time. Rows v come from shared memory, so the ELL crosses
//    device memory once. Rows are staged as pack_bucket writes them (the
//    ids first, ascending up to one rotation: the neighbours above u, then
//    those below), which is what makes them ascending without a sort. A
//    graph with another row, an id outside [0, R] or more ids than the
//    block holds runs on the walk's code within the same launch. The
//    wrapper picks the route from the shape alone (agreement_launch_plan);
//    nothing here waits on the host.
// The result is integer and independent of the order of the work, so it
// equals the plain version bit for bit.
//
// Every launch goes on the caller's stream, on the device index the caller
// names (this library links its own CUDA runtime), and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRows = 1 << 15;          // the batch engine's MAX_ROWS
constexpr int kMaxWidth = 1 << 12;         // the batch engine's MAX_WIDTH
constexpr int kWarpWarps = 8;              // warp route: warps a block
constexpr int kSmemWarps = 16;             // smem route: warps a block
constexpr int kStageRows = 8;              // smem route: rows in flight a warp
constexpr int kRouteWarp = 0, kRouteSmem = 1;

__device__ __forceinline__ bool in_row(const unsigned* bits, int x, int R) {
  return (unsigned)x < (unsigned)R && ((bits[x >> 5] >> (x & 31)) & 1u);
}

__device__ __forceinline__ bool agrees(int du, int dv, int common, int bn,
                                       int bd) {
  return bd * (du + dv - 2 * common - 2) < bn * (max(du, dv) + 1);
}

// Lane groups of a warp (G = 32 / L) and the slots a group takes in a
// pipelined batch (P), their rows v in flight together.
template <int L>
struct Batch {
  static constexpr int G = 32 / L;
  static constexpr int P = L == 32 ? 4 : (L == 16 ? 2 : 1);
};

// One batch of up to G * Q of the slots left in m (the same in every
// lane): group j takes set bits j, j + G, ... of m, reads their rows v,
// all loads before the first ballot, and counts dv and common with ballots
// masked to the group. Clears the batch's bits from m; returns the bits
// of the slots whose edge agrees (in the lanes of the group that took
// them).
template <int L, int Q>
__device__ __forceinline__ unsigned walk_batch(
    const int32_t* ell_g, int x, unsigned& m, int du, const unsigned* bits,
    int R, int W, int lane, int bn, int bd) {
  constexpr int G = Batch<L>::G;
  const int j = lane / L, t = lane & (L - 1);
  const unsigned gm = L == 32 ? kFull : (((1u << L) - 1u) << (j * L));
  int s[Q], v[Q];
  unsigned mm = m;
  for (int q = 0; q < j; ++q) mm &= mm - 1u;
#pragma unroll
  for (int i = 0; i < Q; ++i) {
    s[i] = mm ? __ffs(mm) - 1 : -1;
#pragma unroll
    for (int q = 0; q < G; ++q) mm &= mm - 1u;
  }
#pragma unroll
  for (int q = 0; q < G * Q; ++q) m &= m - 1u;
#pragma unroll
  for (int i = 0; i < Q; ++i)
    v[i] = __shfl_sync(kFull, x, s[i] < 0 ? 0 : s[i]);

  const int vwin = L == 32 ? (W + 31) >> 5 : 1;     // windows of a row v
  int dv[Q], cm[Q];
#pragma unroll
  for (int i = 0; i < Q; ++i) dv[i] = cm[i] = 0;
  for (int c2 = 0; c2 < vwin; ++c2) {
    const int w2 = c2 * 32 + t;
    int y[Q];
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const bool ok = s[i] >= 0 && (unsigned)v[i] < (unsigned)R && w2 < W;
      y[i] = ok ? ell_g[(long long)v[i] * W + w2] : R;
    }
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      dv[i] += __popc(__ballot_sync(kFull, y[i] != R) & gm);
      cm[i] += __popc(__ballot_sync(kFull, in_row(bits, y[i], R)) & gm);
    }
  }
  unsigned agree = 0u;
#pragma unroll
  for (int i = 0; i < Q; ++i)
    if (s[i] >= 0 && agrees(du, dv[i], cm[i], bn, bd)) agree |= 1u << s[i];
  return agree;
}

// One window of 32 slots of row u (lane l holds slot c * 32 + l in x):
// walks its non-pad slots, a full batch while more than one slot a group
// is left, then one a group; returns the mask of the slots whose edge
// agrees (the same in every lane).
template <int L>
__device__ __forceinline__ unsigned walk_window(
    const int32_t* ell_g, int x, int du, const unsigned* bits, int R, int W,
    int lane, int bn, int bd) {
  constexpr int G = Batch<L>::G, P = Batch<L>::P;
  unsigned m = __ballot_sync(kFull, x != R);
  unsigned agree = 0u;
  while (m) {                                      // uniform in the warp
    if (P > 1 && __popc(m) > G)
      agree |= walk_batch<L, P>(ell_g, x, m, du, bits, R, W, lane, bn, bd);
    else
      agree |= walk_batch<L, 1>(ell_g, x, m, du, bits, R, W, lane, bn, bd);
  }
  return __reduce_or_sync(kFull, agree);
}

// Row u of a group's graph (ell_g: its (R, W) rows), whose ids lane l
// holds in x[c] (slot c * 32 + l, R beyond the row; NC windows), or with
// NC == 0 (W > 128) reads from ell_g a window at a time. Stores the row's
// agreement ids to the group's `rep` entries from out_u on, `entry` words
// apart.
template <int L, int NC>
__device__ __forceinline__ void agree_row(
    const int32_t* ell_g, const int (&x)[NC > 0 ? NC : 1], int32_t* out_u,
    long long entry, int rep, int u, int R, int W, unsigned* bits, int lane,
    int bn, int bd) {
  auto store = [&](int c, int xc, unsigned agree) {
    const int w = c * 32 + lane;
    const int o = (agree >> lane) & 1u ? xc : R;
    if (w < W) {
      int32_t* p = out_u + w;
      for (int r = 0; r < rep; ++r, p += entry) *p = o;
    }
  };
  int du = 0;
  if constexpr (NC > 0) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      du += __popc(__ballot_sync(kFull, x[c] != R));
    if (du == 0) {                     // a row of pads: pads out, no walk
#pragma unroll
      for (int c = 0; c < NC; ++c) store(c, R, 0u);
      return;
    }
    // The bitmap of row u, then its windows, then the clear: every id
    // from the registers.
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if ((unsigned)x[c] < (unsigned)R)
        atomicOr(&bits[x[c] >> 5], 1u << (x[c] & 31));
    __syncwarp();
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store(c, x[c],
            walk_window<L>(ell_g, x[c], du, bits, R, W, lane, bn, bd));
    __syncwarp();
#pragma unroll
    for (int c = 0; c < NC; ++c)
      if ((unsigned)x[c] < (unsigned)R) bits[x[c] >> 5] = 0u;
  } else {
    const int nwin = (W + 31) >> 5;
    const int32_t* ru = ell_g + (long long)u * W;
    auto id = [&](int c) {
      const int w = c * 32 + lane;
      return w < W ? ru[w] : R;
    };
    for (int c = 0; c < nwin; ++c) {
      const int xc = id(c);
      du += __popc(__ballot_sync(kFull, xc != R));
      if ((unsigned)xc < (unsigned)R)
        atomicOr(&bits[xc >> 5], 1u << (xc & 31));
    }
    __syncwarp();
    for (int c = 0; c < nwin; ++c) {
      const int xc = id(c);
      store(c, xc,
            walk_window<L>(ell_g, xc, du, bits, R, W, lane, bn, bd));
    }
    __syncwarp();
    for (int c = 0; c < nwin; ++c) {
      const int xc = id(c);
      if ((unsigned)xc < (unsigned)R) bits[xc >> 5] = 0u;
    }
  }
  __syncwarp();
}

template <int NC>
__device__ __forceinline__ void load_row(int (&x)[NC > 0 ? NC : 1],
                                         const int32_t* ru, int R, int W,
                                         int lane, bool live) {
#pragma unroll
  for (int c = 0; c < (NC > 0 ? NC : 1); ++c) {
    const int w = c * 32 + lane;
    x[c] = NC > 0 && live && w < W ? ru[w] : R;
  }
}

// Warp route: a warp per row u of the (groups * R) rows, the next row's
// ids loaded before the current one is walked.
template <int L, int NC>
__global__ void __launch_bounds__(32 * kWarpWarps)
agreement_warp(const int32_t* __restrict__ ell, int32_t* __restrict__ out,
               long long groups, int R, int W, int rep, int bn, int bd) {
  extern __shared__ unsigned smem_bits[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int words = (R + 31) >> 5;
  unsigned* bits = smem_bits + warp * words;
  for (int i = lane; i < words; i += 32) bits[i] = 0u;
  __syncwarp();

  const long long entry = (long long)R * W;
  // Row (g, u) = g * R + u, advanced by the grid's stride without a
  // division a row.
  const long long stride = (long long)gridDim.x * kWarpWarps;
  const long long sg = stride / R;
  const int su = (int)(stride % R);
  const long long row0 = (long long)blockIdx.x * kWarpWarps + warp;
  long long g = row0 / R;
  int u = (int)(row0 % R);
  int x[NC > 0 ? NC : 1];
  load_row<NC>(x, ell + (g * rep * R + u) * W, R, W, lane, g < groups);
  while (g < groups) {
    long long gn = g + sg;
    int un = u + su;
    if (un >= R) { un -= R; ++gn; }
    int xn[NC > 0 ? NC : 1];
    load_row<NC>(xn, ell + (gn * rep * R + un) * W, R, W, lane,
                 gn < groups);
    agree_row<L, NC>(ell + g * rep * entry, x,
                     out + g * rep * entry + (long long)u * W, entry, rep, u,
                     R, W, bits, lane, bn, bd);
#pragma unroll
    for (int c = 0; c < (NC > 0 ? NC : 1); ++c) x[c] = xn[c];
    g = gn;
    u = un;
  }
}

// A staged row's meta word: offset of its ids (20 bits), degree (6 bits)
// and rotation (6 bits): original slot w holds staged id (w - rot) mod deg.
__device__ __forceinline__ unsigned meta_word(unsigned off, unsigned deg,
                                              unsigned rot) {
  return off << 12 | deg << 6 | rot;
}

// Smem route (W <= 32): a block per group's graph at a time. Shared
// memory: [meta: R words][agree: R words, a row's agreeing slots][ids: cap
// 16-bit values, a row's ids in ascending order]. A row is staged as
// pack_bucket writes it: its non-pad ids first, ascending up to one
// rotation (the neighbours above u, then those below). A graph with
// another row, an id outside [0, R] or more than cap ids runs on the warp
// route's code, its bitmaps in the ids' space.
template <int L>
__global__ void __launch_bounds__(32 * kSmemWarps, 2)
agreement_smem(const int32_t* __restrict__ ell, int32_t* __restrict__ out,
               long long groups, int R, int W, int rep, int cap, int bn,
               int bd) {
  constexpr int G = 32 / L;
  extern __shared__ unsigned smem[];
  __shared__ unsigned cursor, fallback;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = lane / L, t = lane & (L - 1);
  const unsigned gm = L == 32 ? kFull : (((1u << L) - 1u) << (j * L));
  unsigned* meta = smem;
  unsigned* agree = smem + R;
  uint16_t* ids = (uint16_t*)(smem + 2 * R);
  const long long entry = (long long)R * W;
  constexpr int kPass = kSmemWarps * G;    // rows the block stages a load

  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const int32_t* ell_g = ell + g * rep * entry;
    int32_t* out_g = out + g * rep * entry;
    if (threadIdx.x == 0) cursor = fallback = 0u;
    __syncthreads();
    // Stage: a row a lane group, kStageRows loads a lane in flight and the
    // next kStageRows issued before these are compacted, the warp's rows
    // at an offset from one atomic on the cursor.
    auto load = [&](int (&xs)[kStageRows], int base) {
#pragma unroll
      for (int i = 0; i < kStageRows; ++i) {
        const int u = base + i * kPass + j;
        xs[i] = u < R && t < W ? ell_g[(long long)u * W + t] : R;
      }
    };
    int xn[kStageRows];
    load(xn, warp * G);
    for (int base = warp * G; base < R; base += kPass * kStageRows) {
      int xs[kStageRows];
#pragma unroll
      for (int i = 0; i < kStageRows; ++i) xs[i] = xn[i];
      load(xn, base + kPass * kStageRows);
      unsigned ms[kStageRows], total = 0u;
      int rot[kStageRows];
      bool odd = false;
#pragma unroll
      for (int i = 0; i < kStageRows; ++i) {
        ms[i] = __ballot_sync(kFull, xs[i] != R);
        total += __popc(ms[i]);
        const int du = __popc(ms[i] & gm);
        const int nx = __shfl_down_sync(kFull, xs[i], 1);
        const unsigned desc =
            __ballot_sync(kFull, t + 1 < du && xs[i] > nx) & gm;
        const int first = __shfl_sync(kFull, xs[i], j * L);
        const int last = __shfl_sync(kFull, xs[i], j * L + max(du - 1, 0));
        const unsigned lead =
            du >= 32 ? kFull : ((1u << du) - 1u) << (j * L);
        // Pads trail, ids in [0, R), ascending up to one rotation.
        odd |= (ms[i] & gm) != lead ||
               (xs[i] != R && (unsigned)xs[i] >= (unsigned)R) ||
               __popc(desc) > 1 || (desc && last > first);
        rot[i] = desc ? __ffs(desc) - j * L : 0;
      }
      if (__any_sync(kFull, odd)) fallback = 1u;
      unsigned off = 0u;
      if (lane == 0 && total) off = atomicAdd(&cursor, total);
      off = __shfl_sync(kFull, off, 0);
#pragma unroll
      for (int i = 0; i < kStageRows; ++i) {
        const int u = base + i * kPass + j;
        const unsigned mg = ms[i] & gm;
        const int du = __popc(mg);
        const unsigned o = off + __popc(ms[i] & ((1u << (j * L)) - 1u));
        if (t < du && o + du <= (unsigned)cap) {
          const int k = t >= rot[i] ? t - rot[i] : t - rot[i] + du;
          ids[o + k] = (uint16_t)xs[i];
        }
        if (t == 0 && u < R) {
          meta[u] = meta_word(o, du, rot[i]);
          agree[u] = 0u;
        }
        off += __popc(ms[i]);
      }
    }
    __syncthreads();
    if (!fallback && cursor <= (unsigned)cap) {
      // A warp takes 32 rows at a time and their slots 32 at a time, a
      // lane a slot (u, v): common = |ids(v) ∩ ids(u)| by a merge of the
      // two ascending rows, each id of v counted once if u holds it.
      for (int c0 = warp * 32; c0 < R; c0 += kSmemWarps * 32) {
        const unsigned mr = c0 + lane < R ? meta[c0 + lane] : 0u;
        const int dr = (mr >> 6) & 63;
        int incl = dr;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(kFull, incl, d);
          if (lane >= d) incl += y;
        }
        const int start = incl - dr;
        const int slots = __shfl_sync(kFull, incl, 31);
        for (int s0 = 0; s0 < slots; s0 += 32) {
          const int q = s0 + lane;
          int r = 0;                          // the last row starting <= q
#pragma unroll
          for (int st = 16; st; st >>= 1)
            if (__shfl_sync(kFull, start, r + st) <= q) r += st;
          const unsigned mu = __shfl_sync(kFull, mr, r);
          const int k = q - __shfl_sync(kFull, start, r);
          if (q < slots) {
            const int ou = mu >> 12, du = (mu >> 6) & 63;
            const int v = ids[ou + k];
            const unsigned mv = meta[v];
            const int ov = mv >> 12, dv = (mv >> 6) & 63;
            // Branch-free merge: both loads of a step independent; an id
            // of v that u holds is counted and v moves on, so a repeated
            // id of v counts again.
            int common = 0, ia = 0, ib = 0;
            while (ia < du && ib < dv) {
              const int a = ids[ou + ia], b = ids[ov + ib];
              common += a == b;
              ia += a < b;
              ib += a >= b;
            }
            if (agrees(du, dv, common, bn, bd)) {
              const int w = k + (int)(mu & 63);
              atomicOr(&agree[c0 + r], 1u << (w < du ? w : w - du));
            }
          }
        }
        __syncwarp();
        // The 32 rows out, G a store: slot t of row u, to every replica.
        for (int i = 0; i < 32; i += G) {
          const int u = c0 + i + j;
          if (u < R && t < W) {
            const unsigned mu = meta[u];
            const int du = (mu >> 6) & 63, rt = mu & 63;
            int o = R;
            if (t < du && (agree[u] >> t) & 1u)
              o = ids[(mu >> 12) + (t >= rt ? t - rt : t - rt + du)];
            int32_t* p = out_g + (long long)u * W + t;
            for (int r = 0; r < rep; ++r, p += entry) *p = o;
          }
        }
      }
    } else {
      const int words = (R + 31) >> 5;
      unsigned* bits = (unsigned*)ids + warp * words;
      for (int i = lane; i < words; i += 32) bits[i] = 0u;
      __syncwarp();
      for (int u = warp; u < R; u += kSmemWarps) {
        int x[1];
        x[0] = lane < W ? ell_g[(long long)u * W + lane] : R;
        agree_row<L, 1>(ell_g, x, out_g + (long long)u * W, entry, rep, u,
                        R, W, bits, lane, bn, bd);
      }
    }
    __syncthreads();          // the next graph overwrites the staged rows
  }
}

int lanes_for(int W) { return W <= 4 ? 4 : W <= 8 ? 8 : W <= 16 ? 16 : 32; }

template <int L, int NC>
cudaError_t launch_warp(const int32_t* ell, int32_t* out, long long groups,
                        int R, int W, int rep, int bn, int bd, int blocks,
                        size_t smem, cudaStream_t stream) {
  // At most the blocks the card holds at once: a block of a second wave
  // would add its rows' whole time after the first.
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, agreement_warp<L, NC>, 32 * kWarpWarps, smem);
  if (err != cudaSuccess) return err;
  blocks = min(blocks, max(1, per_sm * sms));
  agreement_warp<L, NC><<<blocks, 32 * kWarpWarps, smem, stream>>>(
      ell, out, groups, R, W, rep, bn, bd);
  return cudaGetLastError();
}

template <int L>
cudaError_t launch_smem(const int32_t* ell, int32_t* out, long long groups,
                        int R, int W, int rep, int cap, int bn, int bd,
                        int blocks, size_t smem, cudaStream_t stream) {
  const cudaError_t set = cudaFuncSetAttribute(
      agreement_smem<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (set != cudaSuccess) return set;
  agreement_smem<L><<<blocks, 32 * kSmemWarps, smem, stream>>>(
      ell, out, groups, R, W, rep, cap, bn, bd);
  return cudaGetLastError();
}

}  // namespace

// The argument list of ag_agreement, for callers that bind an earlier
// library: 2 is (ell, out, B, R, W, replicas, beta_num, beta_den, route,
// blocks, smem_bytes, device, stream). The source before it exports no
// version and takes (ell, out, B, R, W, beta_num, beta_den, blocks, device,
// stream).
extern "C" int ag_abi_version() { return 2; }

// ell, out: (B, R, W) int32, contiguous; B a multiple of `replicas`, whose
// groups of entries carry one graph each. route 0 (warp): `blocks` blocks
// of 8 warps at most (no more than the card holds at once), smem_bytes >=
// 8 * ceil(R / 32) * 4. route 1 (smem, W <= 32): `blocks` blocks of 16
// warps, smem_bytes = 8R (meta and agree words) + the ids' room, at least
// 16 * ceil(R / 32) * 4 bytes (the fallback's bitmaps). Returns
// cudaErrorInvalidValue for a shape or plan outside these, else
// cudaGetLastError().
extern "C" int ag_agreement(const void* ell, void* out, long long B, int R,
                            int W, int replicas, int beta_num, int beta_den,
                            int route, int blocks, int smem_bytes, int device,
                            void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (R < 1 || R > kMaxRows || W < 1 || W > kMaxWidth || replicas < 1 ||
      B < 0 || B % replicas || blocks < 1 || smem_bytes < 0)
    return (int)cudaErrorInvalidValue;
  const long long groups = B / replicas;
  if (groups == 0) return (int)cudaGetLastError();
  const int words = (R + 31) / 32;
  const int32_t* in = (const int32_t*)ell;
  int32_t* o = (int32_t*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)smem_bytes;
  const int L = lanes_for(W);
  cudaError_t err = cudaErrorInvalidValue;
  if (route == kRouteWarp) {
    if (smem < (size_t)kWarpWarps * words * 4) return (int)err;
    auto go = [&](auto launch) {
      return launch(in, o, groups, R, W, replicas, beta_num, beta_den, blocks,
                    smem, st);
    };
    err = W > 128 ? go(launch_warp<32, 0>) : W > 64 ? go(launch_warp<32, 4>)
          : W > 32 ? go(launch_warp<32, 2>) : L == 32 ? go(launch_warp<32, 1>)
          : L == 16 ? go(launch_warp<16, 1>) : L == 8 ? go(launch_warp<8, 1>)
          : go(launch_warp<4, 1>);
  } else if (route == kRouteSmem && W <= 32) {
    // Beside meta and agree words, room for the fallback's bitmaps; ids
    // offsets fit 20 bits.
    const long long room = smem_bytes - 8LL * R;
    const long long cap = room / 2;
    if (room < (long long)kSmemWarps * words * 4 || cap >= (1LL << 20))
      return (int)err;
    auto go = [&](auto launch) {
      return launch(in, o, groups, R, W, replicas, (int)cap, beta_num,
                    beta_den, blocks, smem, st);
    };
    err = L == 32 ? go(launch_smem<32>) : L == 16 ? go(launch_smem<16>)
          : L == 8 ? go(launch_smem<8>) : go(launch_smem<4>);
  }
  return (int)err;
}

extern "C" const char* ag_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
