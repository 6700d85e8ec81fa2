// Blocked (flash) attention forward with GQA and a causal mask, hand-written
// for Hopper's tensor cores.
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
// accumulator, rescaled at each key tile; a row whose l is 0 gives 0. The
// scores are kept in base 2 (scaled by log2(e), exponentials by
// ex2.approx), which is the same softmax. Inputs are f32 or bf16, the
// output has the input's type, D is one of the instances listed below.
//
// What bounds it on an H100 (same flops, same bytes for both types: q, k,
// v read once and o written once at 3.35 TB/s):
//  * f32 inputs: the tensor cores' dense TF32 rate (495 TFLOP/s) for three
//    times the flops, since every product is taken three times (below);
//    beside it, the f32 FMA rate outside the tensor cores (67 TFLOP/s) for
//    the flops once, which the previous, scalar version of this kernel was
//    held to. The smaller of the two is the bound.
//  * bf16 inputs: the dense bf16 tensor rate (989 TFLOP/s).
//  mma.sync itself peaks at about two thirds of those rates on this card
//  (scripts/mma_peak.py). At B = 1 the time is also the heaviest block's
//  walk over the keys, a chain of dependent MMAs.
//
// Why 3xTF32: one TF32 product keeps 10 mantissa bits, and attention in
// TF32 is ~1e-3 off the f32 result, above the 2e-5 f32 tolerance. Each f32
// operand x is split into hi = tf32(x) (cvt.rna) and lo = x - hi, which
// the MMA reads toward zero; hi*hi + hi*lo + lo*hi with f32 accumulation
// drops only lo*lo and lo's cut bits (~2^-21 relative) and lands ~1e-6
// off (tests/test_torch_attention.py emulates both schemes on the CPU).
// bf16 inputs: Q K^T is exact in one bf16 MMA with f32 accumulation. For
// P V, P (f32, in [0, 1]) is the MMA's A operand, which takes bf16: it is
// split into hi = bf16(p) and lo = bf16(p - hi), and P V is taken as
// hi V + lo V with f32 accumulation, as the f32 path splits its operands.
// That keeps ~16 bits of each weight (|p - hi - lo| <= 2^-17 p), so the
// kernel's f32 result sits ~1e-5 of |o| from the f32 reference, which
// computes P V in f32, and the bf16 output differs from the reference's
// only by its own rounding, half a unit. Rounding P to bf16 alone (SDPA's
// and FlashAttention's choice, and this kernel's before) costs up to 2^-9
// of each weight and pushed the error to ~1.6e-2 at |o| in [2, 4), one
// unit, so that the 2e-2 tolerance could not hold at |o| >= 4. The split
// doubles the MMAs of P V (PERF.md).
//
// Head dims: 16, 32, 64, 80, 128 and 160, each an instance below (80 and
// 160 are the head dims of zamba2-2.7b and stablelm-12b). Every one
// divides into k-steps of 16 and into 8-wide column groups of an even
// count, which the bf16 path's paired V loads need.
//
// Design, against the five causes that held back the previous version
// (scalar FMAs; synchronous staging; P through shared memory; the causal
// critical path; no K/V sharing in a GQA group):
//  1. Tensor cores: each warp takes 16 query rows and keeps their Q
//     fragments in registers (f32: pre-scaled by log2(e)/sqrt(D) and split
//     once into hi and lo, above D = 64 at every tile, for registers;
//     bf16: as stored, the scores scaled in f32).
//     S = Q K^T and O += P V run on mma.sync: m16n8k8 TF32, three MMAs a
//     fragment pair, for f32; m16n8k16 bf16, one MMA for S and two (P's
//     hi and lo) for P V, for bf16. The small products of S and of P V
//     go to accumulators of their own, so that no two MMAs in a row wait
//     on each other; at D = 160 the second accumulator of P V would take
//     80 more registers a thread, and the small products go to the main
//     one.
//     mma.sync and not wgmma: wgmma with TF32 takes only K-major operands,
//     so V would have to be transposed in shared memory; that, TMA and
//     warp specialisation are the next step (ROADMAP.md).
//  2. Asynchronous copies: K/V tiles of BK keys (64; 32 for f32 at
//     D >= 128, for registers) go by cp.async in 16-byte chunks, in the
//     input's own type, into two stages: tile t + 1 loads while tile t is
//     multiplied. The TF32 split is done as fragments are read from shared
//     memory (a shared split copy of each tile measured no faster). Rows
//     are padded by 16 bytes (f32: D + 4, bf16: D + 8 elements) so that
//     every fragment read is free of bank conflicts. Keys past Sk are
//     zero-filled by the copy (src-size 0), so no garbage reaches P V.
//  3. P stays in registers: the m16n8 accumulator of S is the A operand of
//     P V. For bf16 its layout is the m16n8k16 A layout, packed pairwise.
//     For TF32 the accumulator holds key columns (2t, 2t+1) where the A
//     fragment wants (t, t + 4): V's B fragment is read in the permuted key
//     order (rows 2t and 2t + 1), so P needs no shuffle.
//  4. Causal critical path: the query-tile index is the slowest grid axis,
//     reversed, so the heaviest tiles are issued first; a warp skips the
//     MMAs of its keys of a tile that lie wholly above its rows' diagonal;
//     a block stops after the last tile any of its rows can see. A block
//     takes 32 query rows, and the two warps of each 16-row group take half
//     of every key tile each, merging (m, l, acc) at the end ("key
//     halves"): the heaviest walk takes half the MMAs a warp. The serving
//     path prefills one request at a time (B = 1) at up to 2,048 tokens,
//     where the grid is at most 9 x 64 = 576 such blocks and the heaviest
//     walk sets the time. 64-row blocks (4 warps x 16 rows, K/V tiles
//     shared among more rows) were faster only where B * H * ceil(Sq / 64)
//     exceeds ~3 blocks an SM, which no path of the port launches (PERF.md).
//  5. GQA: a block per GQA group of three query heads on one shared K/V
//     stage (3 times fewer K/V bytes and blocks) lost at the serving
//     shapes on the card (PERF.md) and was removed: at B = 1 it
//     leaves a third of the blocks, and the heaviest walk does not shrink.
//
// Every launch goes on the caller's stream, on the device index the caller
// names (this library links its own CUDA runtime, whose current device is
// not PyTorch's), and returns cudaGetLastError(). q, k, v and o must start
// 16-byte aligned (the wrapper guarantees it); otherwise the entry returns
// cudaErrorMisalignedAddress and launches nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarpRows = 16;             // query rows per warp
constexpr int kWarps = 4;                 // warps a block
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int D>
struct Tile {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int BK = (kF32 && D >= 128) ? 32 : 64;  // keys per tile
  static constexpr int LD = D + 16 / (int)sizeof(T);       // padded row
  static constexpr int ELEMS = BK * LD;                    // one K or V tile
  static constexpr int CHUNK = 16 / (int)sizeof(T);        // elements / copy
  static constexpr int CHUNKS = D / CHUNK;                 // copies per row
  static constexpr size_t SMEM = 2 * 2 * ELEMS * sizeof(T);  // 2 stages K, V
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = hi + lo: hi = tf32(x) rounded to nearest; lo = x - hi, exact in f32,
// goes to the MMA as it is, which reads its top 19 bits (rounding toward
// zero): lo loses at most 2^-21 |x|, as much as the dropped lo * lo.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}
// The same, kept in the loop it is written in (volatile): at D = 128 Q's
// split hoisted out of the key loop would hold 64 more registers a thread
// and spill.
__device__ __forceinline__ void split_in_place(float x, uint32_t& hi,
                                               uint32_t& lo) {
  asm volatile("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c += a*b in three TF32 products, the two small ones into cs (which may
// be c itself: then they go first).
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], float (&cs)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], float b0,
                                           float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(cs, al, bh0, bh1);
  mma_tf32(cs, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// Two 8x8 bf16 matrices of rows (keys) r..r+15 transposed into the B
// fragment of m16n8k16, for two 8-column groups: (b0, b1) of columns
// c..c+7 and of c+8..c+15.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (a, b) = hi + lo with hi and lo pairs of bf16: hi rounded to nearest,
// lo the rounded rest (|a - hi - lo| <= 2^-17 |a|).
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Issues the copies of one K and one V tile (keys k0 .. k0 + BK - 1) into
// a stage; rows at or past Sk are zero-filled.
template <typename T, int D, int NT>
__device__ __forceinline__ void load_kv(T* sk, T* sv, const T* __restrict__ kb,
                                        const T* __restrict__ vb, int k0,
                                        int Sk) {
  using C = Tile<T, D>;
  for (int i = threadIdx.x; i < C::BK * C::CHUNKS; i += NT) {
    const int r = i / C::CHUNKS, c = (i % C::CHUNKS) * C::CHUNK;
    const bool ok = k0 + r < Sk;
    const long long src = (long long)(ok ? k0 + r : 0) * D + c;
    cp_async16(sk + r * C::LD + c, kb + src, ok);
    cp_async16(sv + r * C::LD + c, vb + src, ok);
  }
}

// One block: 32 query rows of one query head, 4 warps. Warp w takes rows
// 16 (w % 2) .. + 15 and keys (w / 2) BK/2 .. + BK/2 - 1 of every tile: the
// block's walk over the keys takes half the MMAs a warp, and the two key
// halves merge their (m, l, acc) at the end. Grid: x = query head,
// y = batch, z = query tile (reversed under causal, so that the longest
// walks start first).
template <typename T, int D>
__global__ void __launch_bounds__(32 * kWarps)
fa_forward_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int H, int KH,
                  int Sq, int Sk, int causal, int row_offset, float qk_scale) {
  using C = Tile<T, D>;
  constexpr bool F32 = C::kF32;
  constexpr int BK = C::BK, LD = C::LD, NT = 32 * kWarps;
  constexpr int RG = kWarps / 2;       // 16-row groups of a block
  constexpr int BQ = RG * kWarpRows;   // query rows of a block
  constexpr int KW = BK / 2;           // keys of a tile a warp takes
  constexpr int NS = KW / 8;   // 8-key column groups of a warp's scores
  constexpr int ND = D / 8;    // 8-wide column groups of the output
  constexpr int KQ = F32 ? D / 8 : D / 16;   // k-steps of Q K^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);  // [stage][K, V][BK][LD]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qt = causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * BQ;
  const int b = blockIdx.y;
  const int rg = warp % RG, half = warp / RG;
  const int h = blockIdx.x;
  const int kvh = h / (H / KH);
  const int wr = q0 + rg * kWarpRows;   // the warp's first row
  const int kw = half * KW;             // its first key in every tile
  const T* kb = k + (long long)(b * KH + kvh) * Sk * D;
  const T* vb = v + (long long)(b * KH + kvh) * Sk * D;
  const T* qb = q + (long long)(b * H + h) * Sq * D;

  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) {
    const int last_row = min(q0 + BQ, Sq) - 1 + row_offset;
    n_tiles = min(n_tiles, last_row / BK + 1);
  }
  // The first tile's copies fly while Q's fragments load.
  load_kv<T, D, NT>(smem, smem + C::ELEMS, kb, vb, 0, Sk);
  cp_async_commit();

  // Q's A fragments (rows g and g + 8 of the warp's 16), kept in registers:
  // f32 split once into hi and lo, or above D = 64 kept as f32 (qf) and
  // split at every tile; rows past Sq read as 0 and are never stored.
  constexpr bool kQOnce = D <= 64;
  const int r0 = wr + g, r1 = wr + g + 8;
  uint32_t qh[KQ][4], ql[F32 && kQOnce ? KQ : 1][4];
  float qf[F32 && !kQOnce ? KQ : 1][4];
  if constexpr (F32) {
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      const int c = 8 * kk + t;
      const float x[4] = {
          r0 < Sq ? qb[(long long)r0 * D + c] * qk_scale : 0.f,
          r1 < Sq ? qb[(long long)r1 * D + c] * qk_scale : 0.f,
          r0 < Sq ? qb[(long long)r0 * D + c + 4] * qk_scale : 0.f,
          r1 < Sq ? qb[(long long)r1 * D + c + 4] * qk_scale : 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (kQOnce)
          split(x[e], qh[kk][e], ql[kk][e]);
        else
          qf[kk][e] = x[e];
      }
    }
  } else {
    const uint32_t* q32 = reinterpret_cast<const uint32_t*>(qb);
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      const int c = (16 * kk + 2 * t) / 2;   // in bf16 pairs
      qh[kk][0] = r0 < Sq ? q32[(long long)r0 * (D / 2) + c] : 0u;
      qh[kk][1] = r1 < Sq ? q32[(long long)r1 * (D / 2) + c] : 0u;
      qh[kk][2] = r0 < Sq ? q32[(long long)r0 * (D / 2) + c + 4] : 0u;
      qh[kk][3] = r1 < Sq ? q32[(long long)r1 * (D / 2) + c + 4] : 0u;
    }
  }

  // The small products of P V (f32: hi*lo and lo*hi; bf16: P's lo) go to
  // accs, so that no two MMAs in a row wait on each other: the heaviest
  // block's walk, a chain of dependent MMAs, sets the time. At D = 160
  // accs would not fit in the registers, and they go to acc.
  constexpr bool kSepPV = D <= 128;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[ND][4], accs[kSepPV ? ND : 1][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = accs[kSepPV ? n : 0][e] = 0.f;
  // The accumulator of column group n's small products of P V.
  auto small = [&](int n) -> float(&)[4] {
    if constexpr (kSepPV) return accs[n];
    else return acc[n];
  };

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * BK;
    if (it + 1 < n_tiles) {
      T* next = smem + ((it + 1) & 1) * 2 * C::ELEMS;
      load_kv<T, D, NT>(next, next + C::ELEMS, kb, vb, k0 + BK, Sk);
    }
    cp_async_commit();   // an empty group on the last tile keeps the count
    cp_async_wait<1>();  // this thread's copies of tile `it` have landed
    __syncthreads();     // and every other thread's

    const T* sK = smem + (it & 1) * 2 * C::ELEMS;
    const T* sV = sK + C::ELEMS;
    // A warp whose rows are all past Sq, or all above its first key of this
    // tile (causal), has nothing to add.
    const int c0 = k0 + kw;   // the warp's first key
    const bool live = wr < Sq && !(causal && c0 > wr + kWarpRows - 1 +
                                                row_offset);
    if (live) {
      // S = Q K^T: sc[j] holds rows (g, g + 8) x keys c0 + 8j + (2t, 2t+1).
      float sc[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
      if constexpr (F32) {
        float ss[NS][4];
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) ss[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KQ; ++kk) {
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if constexpr (kQOnce) {
              ah[e] = qh[kk][e];
              al[e] = ql[kk][e];
            } else {
              split_in_place(qf[kk][e], ah[e], al[e]);
            }
          }
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            const float* kr = sK + (kw + 8 * j + g) * LD + 8 * kk + t;
            mma_3xtf32(sc[j], ss[j], ah, al, kr[0], kr[4]);
          }
        }
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] += ss[j][e];
      } else {
#pragma unroll
        for (int kk = 0; kk < KQ; ++kk)
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            const uint32_t* kr = reinterpret_cast<const uint32_t*>(
                sK + (kw + 8 * j + g) * LD + 16 * kk + 2 * t);
            mma_bf16(sc[j], qh[kk], kr[0], kr[4]);
          }
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] *= qk_scale;
      }

      // Masks, only where the warp's keys reach past Sk or across the
      // diagonal.
      if (c0 + KW > Sk || (causal && c0 + KW - 1 > wr + row_offset)) {
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c0 + 8 * j + 2 * t + (e & 1);
            const int row = wr + g + (e >> 1) * 8;
            if (col >= Sk || (causal && col > row + row_offset))
              sc[j][e] = kNegInf;
          }
      }

      // Online softmax on the fragments; rows are reduced over the quad of
      // lanes that shares them. l stays a per-lane partial sum until the
      // end (every lane of a quad rescales by the same alpha). A row that
      // has seen only masked keys (a second key half can start above the
      // diagonal) keeps p = 0: its exponent is taken against 0, not -1e30.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mt = m[r];
#pragma unroll
        for (int j = 0; j < NS; ++j)
          mt = fmaxf(mt, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float mu = mt == kNegInf ? 0.f : mt;
        const float alpha = ex2(m[r] - mu);
        m[r] = mt;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          sc[j][2 * r] = ex2(sc[j][2 * r] - mu);
          sc[j][2 * r + 1] = ex2(sc[j][2 * r + 1] - mu);
          rs += sc[j][2 * r] + sc[j][2 * r + 1];
        }
        l[r] = l[r] * alpha + rs;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          acc[n][2 * r] *= alpha;
          acc[n][2 * r + 1] *= alpha;
          if constexpr (kSepPV) {
            accs[n][2 * r] *= alpha;
            accs[n][2 * r + 1] *= alpha;
          }
        }
      }

      // O += P V with P straight from the score registers.
      if constexpr (F32) {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          // k index t <-> key 8j + 2t, t + 4 <-> key 8j + 2t + 1.
          const float pa[4] = {sc[j][0], sc[j][2], sc[j][1], sc[j][3]};
          uint32_t ph[4], pl[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split(pa[e], ph[e], pl[e]);
          const float* vr = sV + (kw + 8 * j + 2 * t) * LD + g;
#pragma unroll
          for (int n = 0; n < ND; ++n)
            mma_3xtf32(acc[n], small(n), ph, pl, vr[8 * n], vr[LD + 8 * n]);
        }
      } else {
        // P split into bf16 hi and lo for the MMAs (source note).
#pragma unroll
        for (int j = 0; j < NS / 2; ++j) {
          uint32_t ph[4], pl[4];
          split_bf16(sc[2 * j][0], sc[2 * j][1], ph[0], pl[0]);
          split_bf16(sc[2 * j][2], sc[2 * j][3], ph[1], pl[1]);
          split_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1], ph[2], pl[2]);
          split_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3], ph[3], pl[3]);
          // Lanes 0-15 address keys kw + 16j + (lane % 16), columns 8n;
          // lanes 16-31 the same keys, columns 8n + 8.
          const T* vr =
              sV + (kw + 16 * j + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
          for (int n = 0; n < ND; n += 2) {
            uint32_t bv[4];
            ldmatrix_x4_trans(bv, vr + 8 * n);
            mma_bf16(small(n), pl, bv[0], bv[1]);
            mma_bf16(small(n + 1), pl, bv[2], bv[3]);
            mma_bf16(acc[n], ph, bv[0], bv[1]);
            mma_bf16(acc[n + 1], ph, bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();  // stage (it & 1) is read; the next issue refills it
  }

  if constexpr (kSepPV) {
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += accs[n][e];
  }
  // l is summed over the quad. The second key half of each row group hands
  // its (m, l, acc) to the first through shared memory, free after the
  // loop's last sync, element-major so that lanes hit distinct banks.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  constexpr int XW = 4 + 4 * ND;   // floats a lane hands over
  float* xch = reinterpret_cast<float*>(smem_raw) +
               rg * 32 * XW + lane;
  if (half == 1) {
    xch[0] = m[0];
    xch[32] = m[1];
    xch[64] = l[0];
    xch[96] = l[1];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) xch[32 * (4 + 4 * n + e)] = acc[n][e];
  }
  __syncthreads();
  if (half == 1) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mo = xch[32 * r], mn = fmaxf(m[r], mo);
    const float a = ex2(m[r] - mn), c = ex2(mo - mn);
    l[r] = l[r] * a + xch[32 * (2 + r)] * c;
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e)
        acc[n][e] = acc[n][e] * a + xch[32 * (4 + 4 * n + e)] * c;
  }

  // Rows past Sq are not stored.
  T* ob = o + (long long)(b * H + h) * Sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = l[r];
    const int row = wr + g + 8 * r;
    if (row >= Sq) continue;
    const float inv = 1.f / (lr == 0.f ? 1.f : lr);
#pragma unroll
    for (int n = 0; n < ND; ++n)
      store2(ob + (long long)row * D + 8 * n + 2 * t, acc[n][2 * r] * inv,
             acc[n][2 * r + 1] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KH, int Sq, int Sk, int causal, int row_offset,
           cudaStream_t stream) {
  using C = Tile<T, D>;
  static_assert((kWarps / 2) * 32 * (4 + D / 2) * sizeof(float) <= C::SMEM,
                "the merge of the key halves reuses the stages");
  constexpr int BQ = kWarps / 2 * kWarpRows;
  const int n_qt = (Sq + BQ - 1) / BQ;
  if (B > 65535 || n_qt > 65535) return (int)cudaErrorInvalidValue;
  // Above 48 KB a block's dynamic shared memory has to be allowed first.
  cudaError_t err = cudaFuncSetAttribute(
      fa_forward_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B, n_qt);
  const float inv_sqrt_d = 1.f / sqrtf((float)D);
  fa_forward_kernel<T, D><<<grid, 32 * kWarps, C::SMEM, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, KH, Sq, Sk, causal,
      row_offset, inv_sqrt_d * kLog2e);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int KH, int Sq, int Sk, int D, int causal, int off,
             cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, KH, Sq, Sk, causal, off, s);
    case 32: return launch<T, 32>(q, k, v, o, B, H, KH, Sq, Sk, causal, off, s);
    case 64: return launch<T, 64>(q, k, v, o, B, H, KH, Sq, Sk, causal, off, s);
    case 80: return launch<T, 80>(q, k, v, o, B, H, KH, Sq, Sk, causal, off, s);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, KH, Sq, Sk, causal, off, s);
    case 160:
      return launch<T, 160>(q, k, v, o, B, H, KH, Sq, Sk, causal, off, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The wrapper has checked shapes, types,
// contiguity, D in {16, 32, 64, 80, 128, 160}, H % KH == 0, Sk >= 1 and, when
// causal, Sk >= Sq (row_offset >= 0, so every row sees at least key 0).
extern "C" int fa_forward(const void* q, const void* k, const void* v, void* o,
                          int B, int H, int KH, int Sq, int Sk, int D,
                          int causal, int dtype, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return (int)set;
  if (B == 0 || H == 0 || Sq == 0) return (int)cudaGetLastError();
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) & 15)
    return (int)cudaErrorMisalignedAddress;
  const int row_offset = causal ? Sk - Sq : 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, H, KH, Sq, Sk, D, causal,
                           row_offset, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, H, KH, Sq, Sk, D, causal,
                                   row_offset, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block (two stages of K and V), for reports.
extern "C" int fa_smem_bytes(int dtype, int D) {
  switch (D * 2 + dtype) {
    case 32: return (int)Tile<float, 16>::SMEM;
    case 64: return (int)Tile<float, 32>::SMEM;
    case 128: return (int)Tile<float, 64>::SMEM;
    case 160: return (int)Tile<float, 80>::SMEM;
    case 256: return (int)Tile<float, 128>::SMEM;
    case 320: return (int)Tile<float, 160>::SMEM;
    case 33: return (int)Tile<__nv_bfloat16, 16>::SMEM;
    case 65: return (int)Tile<__nv_bfloat16, 32>::SMEM;
    case 129: return (int)Tile<__nv_bfloat16, 64>::SMEM;
    case 161: return (int)Tile<__nv_bfloat16, 80>::SMEM;
    case 257: return (int)Tile<__nv_bfloat16, 128>::SMEM;
    case 321: return (int)Tile<__nv_bfloat16, 160>::SMEM;
    default: return -1;
  }
}

extern "C" const char* fa_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
