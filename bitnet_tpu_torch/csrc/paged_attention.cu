// K33: paged decode attention for Hopper (sm_90a).
//
// Replaces JAX's stock Pallas kernel
// jax.experimental.pallas.ops.tpu.paged_attention (its pallas_call sits in
// the JAX library; the repo calls it at experiments/exp_r4_attn.py:63-88)
// and serves the paged scheduler's decode step (models/bitnet.py, plan
// "paged").  The function:
//   q [B, H, D]; k / v pages [KV, P, page, D] (strides multiples of 16
//   bytes, D contiguous); lengths [B]; page_indices [B, pages_per_seq];
//   out[b, h] = softmax_p(q[b, h] . k[h / G, p]) . v[h / G, p] over the
//   positions p < min(lengths[b], pages_per_seq * page), position p read
//   from page page_indices[b, p / page] at row p % page, a negative
//   (unassigned) entry reading page 0 as the JAX paged gather does
//   (bitnet_tpu/engine/paged_cache.py:225): a scheduler's K-step window
//   runs a slot past the pages it was grown for when it will stop sooner.
//   No scale (the caller scales q); masked positions weigh nothing (the
//   stock kernel adds mask_value, which underflows to 0 once a position is
//   valid); a length of 0 gives 0.  q and out bf16 or f32, pages bf16 or
//   f32, every sum in f32.
//
// On f32 pages this kernel reads k and v at f32, as the scheduler's JAX
// reference (a dense f32 view it gathers) wants; the stock kernel rounds
// f32 pages to bf16 before its dots (paged_attention_kernel.py:94-109,
// wait_and_get_loaded -> _maybe_dequantize -> astype(bfloat16)).
//
// What bounds it on the card: the bytes of the k and v rows it attends (2 *
// n * KV * D * itemsize), as for the split-S decode attention
// (decode_attention.cu), whose design this follows.  One launch: grid
// (splits, KV, B), R rows a split (ops/paged_attention.paged_plan, from the
// table's reach, so a CUDA graph keeps it and no host sync reads lengths);
// blocks past a slot's length exit at once.  A block is one producer warp
// and CW = 4 consumer warps.
//
//   The producer's lanes stream the split's rows through TMA, SR = 64
//   positions a stage, k and v each under their own mbarrier, into a ring
//   of NST (2-4) stages.  The map is 4-D over the layer [KV, P, page, D]
//   (any strides TMA takes), its box BR = gcd(page, 64) rows of one page by
//   one 128-byte panel of D with TMA's 128-byte swizzle: stage and page
//   boundaries both fall on multiples of BR, so a stage is 64 / BR boxes of
//   whole page runs, lane j issuing box j with the page entry it read from
//   the table one stage ahead (negative -> 0; positions stop at the table's
//   reach), and the stage's expect_tx counts the boxes that hold valid
//   rows.  A page index past the pool reads zeros (TMA's bounds), never
//   another allocation.
//
//   bf16 pages: consumer warp w takes rows 16w .. 16w+15 of every stage
//   with a running softmax of its own and runs both products on the tensor
//   cores, mma.sync m16n8k16 in bf16 with f32 sums.  The G <= 8 heads are
//   A's rows 0..7 and rows 8..15 carry the low halves that keep f32
//   accuracy: an f32 q is split into q_hi = bf16(q) and q_lo = bf16(q -
//   q_hi), the f32 softmax weights the same way, so one mma gives both
//   halves' products (the score / ctx is the rows' sum) and each cache row
//   is read once for all heads and both halves.  v's rows reach B through
//   ldmatrix.trans.  A bf16 q has no low half (SPLIT_Q false).
//
//   f32 pages: the same ring feeds the CUDA cores with nothing rounded
//   (lanes own rows for the scores, the stage's max meets in shared
//   memory, lanes own D/32 elements of the PV sum), as the split-S
//   kernel's f32-cache instance does.
//
// The combine runs in the same launch.  A slot whose rows fit one split
// writes its output from shared memory.  Otherwise each block writes its
// partial (m, d, ctx) (it stays in the L2), fences, and counts itself in
// the (b, kv head) arrival counter (ops/decode_attention.attn_counters,
// shared with the split-S kernel on one stream); the block that sees the
// last live split arrive resets the counter to 0 (so the next call and
// every CUDA-graph replay find it zeroed) and folds the partials in split
// order, so a second call gives the same bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "ternary_common.cuh"

namespace {

using namespace bn;

constexpr float NEG_INF = -1e30f;
constexpr int CW = 4;                   // consumer warps
constexpr int THREADS = (CW + 1) * 32;  // and one producer warp
constexpr int SR = 64;                  // positions a stage
constexpr int WPG = SR / 32;            // warps of a head group (f32 score pass)
constexpr int HG = CW / WPG;            // head groups
constexpr int MAXG = 8;                 // query heads of a kv head
constexpr int GPL = MAXG / HG;          // heads a lane scores (f32)
constexpr int PV_ROWS = SR / CW;        // rows of a stage a warp folds into ctx
constexpr int PB = 128;                 // panel bytes: the swizzle's span
constexpr int MAX_SPLITS = 64;          // ops/paged_attention.PAGED_MAX_SPLITS
constexpr int SMEM_BUDGET = 98304;      // the ring: two blocks an SM at bf16, D = 128

// The shape of a stage for rows of D elements of C: ROW bytes in NP panels
// of PB bytes; TILE bytes of k (and of v) a stage; NST stages in the ring,
// as many as SMEM_BUDGET holds (2 to 4).
template <int D, typename C>
struct Geo {
  static constexpr int ESZ = sizeof(C);
  static constexpr int ROW = D * ESZ;
  static constexpr int NP = ROW / PB;
  static constexpr int TILE = SR * ROW;
  static constexpr int STAGE = 2 * TILE;
  static constexpr int NST = 4 * STAGE <= SMEM_BUDGET ? 4 : 3 * STAGE <= SMEM_BUDGET ? 3 : 2;
  static constexpr int RING = NST * STAGE;
  static constexpr int EPL = D / 32;            // elements of a lane in the f32 PV sum
  static constexpr int BPL = EPL * ESZ;
  static_assert(ROW % PB == 0, "head rows of a multiple of 128 bytes");
};

// The device helpers below repeat decode_attention.cu's (a separate
// library; that file's kernels stay as they are).
//
// byte b of row r of a stage tile: panel b / PB, then TMA's 128-byte
// swizzle, which XORs the 16-byte chunk with r & 7 (the panels are
// 1024-byte aligned; the swizzle follows the shared-memory address, so a
// box of BR rows at row r0 lands where rows r0.. of a whole-stage box would)
__device__ __forceinline__ int tile_off(int r, int b) {
  const int c = b % PB;
  return (b / PB) * SR * PB + r * PB + ((((c >> 4) ^ (r & 7)) << 4) | (c & 15));
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
// the consumer warps' own barrier (the producer warp is not in it)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(CW * 32) : "memory");
}

// c += A (16 x 16: rows 0..7 the heads' high halves, 8..15 their low
// halves) * [b0; b1] (16 x 8), bf16 in, f32 sums
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices, transposed (lane i names row i % 8 of matrix i / 8)
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// the A fragment of four f32 values x0..x3 of one row: their bf16 high
// halves in rows 0..7 (a[0], a[2]) and, with LO, bf16(x - hi) in rows 8..15
// (a[1], a[3]); x - hi is exact in f32
template <bool LO>
__device__ __forceinline__ void split_frag(uint32_t (&a)[4], float x0, float x1, float x2,
                                           float x3) {
  const float h0 = bf16_round(x0), h1 = bf16_round(x1);
  const float h2 = bf16_round(x2), h3 = bf16_round(x3);
  a[0] = pack_bf16(h0, h1);
  a[2] = pack_bf16(h2, h3);
  a[1] = LO ? pack_bf16(x0 - h0, x1 - h1) : 0u;
  a[3] = LO ? pack_bf16(x2 - h2, x3 - h3) : 0u;
}

// the EPL f32 elements of a lane (f32 pages; in one 16-byte chunk)
template <int EPL>
__device__ __forceinline__ void load_lane(const unsigned char* p, float* out) {
  if constexpr (EPL == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  }
}

// one 4-D TMA box (c0 the innermost coordinate) into shared memory
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// q [B, H, D]; table rows table_stride apart; part: the partials' ctx
// [B, KV, NS, G, D] then their (m, d) [B, KV, NS, G, 2] (null at one
// split); counters [B*KV], zero between calls.
struct PagedArgs {
  const void* q;
  const int* lengths;
  const int* table;
  float* part_ctx;
  float* part_md;
  int* counters;
  void* out;
  int table_stride, npg, H, KV, page, R, BR;
};

// ---------------------------------------------------------------------------
// grid (NS, KV, B), THREADS threads: split blockIdx.x of R positions of kv
// head blockIdx.y of slot blockIdx.z, then (by the last of the slot's live
// splits) the combine.
// ---------------------------------------------------------------------------
template <int D, typename TQ, typename TK>
__global__ void __launch_bounds__(THREADS, 2)
paged_attn(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
           const PagedArgs a) {
  using GE = Geo<D, TK>;
  constexpr bool MMA = std::is_same<TK, __nv_bfloat16>::value;   // f32 pages: CUDA cores
  constexpr bool SPLIT_Q = std::is_same<TQ, float>::value;       // q has a low half
  constexpr int EPL = GE::EPL, NST = GE::NST, ESZ = GE::ESZ;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int NS = gridDim.x, KV = a.KV, G = a.H / KV, BR = a.BR;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int start = split * a.R, reach = a.npg * a.page;
  const int* trow = a.table + (size_t)b * a.table_stride;

  // producer lane j's box of a stage at position j0: rows j0 + j*BR ..
  // (j < 64 / BR, so at most two a lane); its page entry, read one stage
  // ahead (the first stage's beside the length read)
  auto entry = [&](int j0, int t) {
    const int p = j0 + (lane + 32 * t) * BR;
    return (lane + 32 * t) * BR < SR && p < reach ? max(__ldg(trow + p / a.page), 0) : 0;
  };
  int ent[2] = {0, 0};
  if (warp == CW) {
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" :: "l"(&kmap) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" :: "l"(&vmap) : "memory");
    }
    ent[0] = entry(start, 0);
    ent[1] = entry(start, 1);
  }
  const int len = min(max(a.lengths[b], 0), reach);
  const int live = max(1, (len + a.R - 1) / a.R);          // split 0 always runs
  if (split >= live) return;
  const int end = min(start + a.R, len);
  const int nst = (max(0, end - start) + SR - 1) / SR;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __shared__ __align__(16) float q_s[MAXG][D];
  __shared__ __align__(16) float e_s[MMA ? 1 : 2][SR][MAXG];   // (f32) a stage's weights
  __shared__ float red_s[CW][GPL];
  __shared__ float mw_s[CW][MAXG], dw_s[CW][MAXG];       // the warps' partials
  __shared__ float pm_s[MAXG], pd_s[MAXG], den_s[MAXG];
  __shared__ __align__(8) uint64_t full_k[NST], full_v[NST], empty[NST];
  __shared__ int last_s;

  if (tid == CW * 32) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this split's state: f32 (CUDA cores) a running max shared by the warps,
  // ctx partial sums a warp, d partial sums a lane; tensor cores: a running
  // max, d and ctx a warp (ctx's columns 0..1 the high weights', 2..3 the
  // low weights')
  float m_run[MAXG], ctx[MMA ? 1 : MAXG][EPL], dl[GPL];
  float mw = NEG_INF, dw = 0.f, cacc[MMA ? D / 8 : 1][4];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) m_run[g] = NEG_INF;
#pragma unroll
  for (int g = 0; g < (MMA ? 1 : MAXG); ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) ctx[g][e] = 0.f;
#pragma unroll
  for (int k = 0; k < GPL; ++k) dl[k] = 0.f;
#pragma unroll
  for (int j = 0; j < (MMA ? D / 8 : 1); ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) cacc[j][e] = 0.f;

  if (warp == CW) {                                      // producer
    for (int i = 0; i < nst; ++i) {
      const int s = i % NST, j0 = start + i * SR;
      const int nb = (min(SR, end - j0) + BR - 1) / BR;  // boxes that hold valid rows
      const int cur[2] = {ent[0], ent[1]};
      if (i + 1 < nst) {                                 // the next stage's entries
        ent[0] = entry(j0 + SR, 0);
        ent[1] = entry(j0 + SR, 1);
      }
      if (i >= NST) mbar_wait(&empty[s], (i / NST - 1) & 1);
      unsigned char* kt = ring + s * GE::STAGE;
      if (lane == 0) {
        mbar_expect_tx(&full_k[s], nb * BR * GE::ROW);
        mbar_expect_tx(&full_v[s], nb * BR * GE::ROW);
      }
      __syncwarp();
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = lane + 32 * t;
        if (j < nb) {
          const int row = (j0 + j * BR) % a.page;
#pragma unroll
          for (int pn = 0; pn < GE::NP; ++pn) {
            const int off = pn * SR * PB + j * BR * PB;
            tma_load_4d(kt + off, &kmap, &full_k[s], pn * (PB / ESZ), row, cur[t], h);
            tma_load_4d(kt + GE::TILE + off, &vmap, &full_v[s], pn * (PB / ESZ), row, cur[t], h);
          }
        }
      }
    }
    __syncwarp();
  } else {                                               // consumers
    const TQ* qb = static_cast<const TQ*>(a.q) + ((size_t)b * a.H + (size_t)h * G) * D;
    for (int i = tid; i < G * D; i += CW * 32) q_s[i / D][i % D] = load_f32(qb, i);
    consumers_sync();

    if constexpr (MMA) {
      // lane (gr, t4) holds head gr's scores of rows 8nb + 2t4 + {0, 1}
      // (high half in the accumulator's columns 0..1, low half in 2..3) and
      // its ctx at d = 8j + 2t4 + {0, 1}; the reduction index d is permuted
      // alike in q's and k's fragments (4 consecutive elements a lane)
      constexpr int KS = D / 16;
      const int gr = lane >> 2, t4 = lane & 3, rw = warp * PV_ROWS;
      uint32_t qa[KS][4];
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        const float* qq = &q_s[gr < G ? gr : 0][16 * k + 4 * t4];
        split_frag<SPLIT_Q>(qa[k], qq[0], qq[1], qq[2], qq[3]);
        if (gr >= G) qa[k][0] = qa[k][1] = qa[k][2] = qa[k][3] = 0u;
      }
      for (int i = 0; i < nst; ++i) {
        const int s = i % NST, par = (i / NST) & 1;
        const int nv = min(SR, end - (start + i * SR));  // the stage's valid rows
        unsigned char* kt = ring + s * GE::STAGE;
        if (rw < nv) {                   // (only a slot's last stage has rows past nv)
          mbar_wait(&full_k[s], par);
          uint32_t kb[2][KS][2];
#pragma unroll
          for (int nb = 0; nb < 2; ++nb)
#pragma unroll
            for (int k = 0; k < KS; ++k) {
              const uint2 v = *reinterpret_cast<const uint2*>(
                  kt + tile_off(rw + 8 * nb + gr, (16 * k + 4 * t4) * 2));
              kb[nb][k][0] = v.x;
              kb[nb][k][1] = v.y;
            }
          float sacc[2][2][4];
#pragma unroll
          for (int nb = 0; nb < 2; ++nb)
#pragma unroll
            for (int c = 0; c < 2; ++c)
#pragma unroll
              for (int e = 0; e < 4; ++e) sacc[nb][c][e] = 0.f;
#pragma unroll
          for (int k = 0; k < KS; ++k)
#pragma unroll
            for (int nb = 0; nb < 2; ++nb)
              mma16(sacc[nb][k & 1], qa[k], kb[nb][k][0], kb[nb][k][1]);
          float sc[4], mx = NEG_INF;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int nb = q >> 1, e = q & 1;
            float su = sacc[nb][0][e] + sacc[nb][1][e];
            if constexpr (SPLIT_Q) su += sacc[nb][0][e + 2] + sacc[nb][1][e + 2];
            sc[q] = rw + 8 * nb + 2 * t4 + e < nv ? su : NEG_INF;
            mx = fmaxf(mx, sc[q]);
          }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float mn = fmaxf(mw, mx), alpha = expf(mw - mn);
          mw = mn;
          float pe[4], es = 0.f;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            pe[q] = expf(sc[q] - mn);
            es += pe[q];
          }
          dw = dw * alpha + es;
          uint32_t pa[4];
          split_frag<true>(pa, pe[0], pe[1], pe[2], pe[3]);
#pragma unroll
          for (int j = 0; j < D / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) cacc[j][e] *= alpha;
          mbar_wait(&full_v[s], par);
          // the warp's v rows past nv zero (0 * garbage is no zero)
          unsigned char* vt = kt + GE::TILE;
          if (rw + PV_ROWS > nv) {
            constexpr int CPR = GE::ROW / 16;            // 16-byte chunks of a row
            for (int idx = lane; idx < PV_ROWS * CPR; idx += 32) {
              const int rr = idx / CPR, c = idx % CPR;
              if (rw + rr >= nv)
                *reinterpret_cast<uint4*>(vt + tile_off(rw + rr, c * 16)) =
                    make_uint4(0u, 0u, 0u, 0u);
            }
            __syncwarp();
          }
          const int lr = rw + (lane & 7) + 8 * ((lane >> 3) & 1);
          uint32_t bv[D / 16][4];
#pragma unroll
          for (int j = 0; j < D / 16; ++j)
            ldsm_x4_trans(bv[j], vt + tile_off(lr, (16 * j + 8 * (lane >> 4)) * 2));
#pragma unroll
          for (int j = 0; j < D / 16; ++j) {
            mma16(cacc[2 * j], pa, bv[j][0], bv[j][1]);
            mma16(cacc[2 * j + 1], pa, bv[j][2], bv[j][3]);
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
      dw += __shfl_xor_sync(0xffffffffu, dw, 1);
      dw += __shfl_xor_sync(0xffffffffu, dw, 2);
    } else {
      // f32 on the CUDA cores, nothing rounded: lanes own rows for the
      // scores (lane r of head group hg: heads hg, hg + HG, ...), the
      // stage's max meets in shared memory, lanes own D/32 elements of the
      // PV sum over their warp's 16 rows
      const int r = tid % SR, hg = tid / SR;
      for (int i = 0; i < nst; ++i) {
        const int s = i % NST, par = (i / NST) & 1;
        const int nv = min(SR, end - (start + i * SR));
        const unsigned char* kt = ring + s * GE::STAGE;
        mbar_wait(&full_k[s], par);
        float sc[GPL];
#pragma unroll
        for (int k = 0; k < GPL; ++k) sc[k] = 0.f;
#pragma unroll 4
        for (int c = 0; c < GE::ROW / 16; ++c) {
          const float4 kv = *reinterpret_cast<const float4*>(kt + tile_off(r, c * 16));
          const float kf[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
          for (int k = 0; k < GPL; ++k) {
            const int g = hg + HG * k;
            if (g < G) {
              const float4 qv = *reinterpret_cast<const float4*>(&q_s[g][c * 4]);
              sc[k] = fmaf(qv.x, kf[0], sc[k]);
              sc[k] = fmaf(qv.y, kf[1], sc[k]);
              sc[k] = fmaf(qv.z, kf[2], sc[k]);
              sc[k] = fmaf(qv.w, kf[3], sc[k]);
            }
          }
        }
#pragma unroll
        for (int k = 0; k < GPL; ++k) {
          sc[k] = r < nv ? sc[k] : NEG_INF;
          const float mx = warp_max(sc[k]);
          if (lane == 0) red_s[warp][k] = mx;
        }
        consumers_sync();
        // every consumer: the running max of every head and its rescale
        float alpha[MAXG];
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          alpha[g] = 1.f;
          if (g < G) {
            float ms = NEG_INF;
#pragma unroll
            for (int w = 0; w < WPG; ++w) ms = fmaxf(ms, red_s[(g % HG) * WPG + w][g / HG]);
            const float mn = fmaxf(m_run[g], ms);
            alpha[g] = expf(m_run[g] - mn);
            m_run[g] = mn;
          }
        }
        float* es = &e_s[MMA ? 0 : (i & 1)][0][0];
#pragma unroll
        for (int k = 0; k < GPL; ++k) {
          const int g = hg + HG * k;
          if (g < G) {
            float mg = m_run[0], ag = alpha[0];          // m_run[g], alpha[g]
#pragma unroll
            for (int gg = 1; gg < MAXG; ++gg) {
              mg = gg == g ? m_run[gg] : mg;
              ag = gg == g ? alpha[gg] : ag;
            }
            const float ev = expf(sc[k] - mg);
            dl[k] = dl[k] * ag + ev;
            es[r * MAXG + g] = ev;
          }
        }
        consumers_sync();
        mbar_wait(&full_v[s], par);
        const unsigned char* vt = kt + GE::TILE;
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
#pragma unroll
          for (int e = 0; e < EPL; ++e) ctx[g][e] *= alpha[g];
        const int r1 = min((warp + 1) * PV_ROWS, nv);
        for (int rr = warp * PV_ROWS; rr < r1; ++rr) {
          float vf[EPL];
          load_lane<EPL>(vt + tile_off(rr, lane * GE::BPL), vf);
          const float4 e0 = *reinterpret_cast<const float4*>(es + rr * MAXG);
          const float4 e1 = *reinterpret_cast<const float4*>(es + rr * MAXG + 4);
          const float ew[MAXG] = {e0.x, e0.y, e0.z, e0.w, e1.x, e1.y, e1.z, e1.w};
#pragma unroll
          for (int g = 0; g < MAXG; ++g)
            if (g < G) {
#pragma unroll
              for (int e = 0; e < EPL; ++e) ctx[g][e] = fmaf(ew[g], vf[e], ctx[g][e]);
            }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
#pragma unroll
      for (int k = 0; k < GPL; ++k) dl[k] = warp_sum(dl[k]);
    }
  }
  __syncthreads();                                       // the ring is free

  // this split's partial: the warps' (m, d, ctx) meet in shared memory,
  // rows CS floats apart (CS % 32 == 8: a half warp's float2 stores of four
  // heads' rows fall in distinct banks)
  constexpr int CS = D + 8;
  float* cs_s = reinterpret_cast<float*>(ring);          // [CW][MAXG][CS]
  if (warp < CW) {
    if constexpr (MMA) {
      const int gr = lane >> 2, t4 = lane & 3;
      if (gr < G) {
        if (t4 == 0) {
          mw_s[warp][gr] = mw;
          dw_s[warp][gr] = dw;
        }
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<float2*>(cs_s + (warp * MAXG + gr) * CS + 8 * j + 2 * t4) =
              make_float2(cacc[j][0] + cacc[j][2], cacc[j][1] + cacc[j][3]);
      }
    } else {                                             // one max for all warps
      const int hg = tid / SR;
      if (lane < MAXG) {
        float mg = m_run[0], dg = 0.f;
#pragma unroll
        for (int gg = 1; gg < MAXG; ++gg) mg = gg == lane ? m_run[gg] : mg;
#pragma unroll
        for (int k = 0; k < GPL; ++k) dg = hg + HG * k == lane ? dl[k] : dg;
        mw_s[warp][lane] = mg;
        dw_s[warp][lane] = dg;
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) {
#pragma unroll
          for (int e = 0; e < EPL; ++e) cs_s[(warp * MAXG + g) * CS + lane * EPL + e] = ctx[g][e];
        }
    }
  }
  __syncthreads();
  if (tid < G) {                                         // head tid's (m, d)
    float m = NEG_INF, dd = 0.f;
#pragma unroll
    for (int w = 0; w < CW; ++w) m = fmaxf(m, mw_s[w][tid]);
#pragma unroll
    for (int w = 0; w < CW; ++w) dd += dw_s[w][tid] * expf(mw_s[w][tid] - m);
    pm_s[tid] = m;
    pd_s[tid] = dd;
    if (live > 1)
      reinterpret_cast<float2*>(a.part_md)[((size_t)(b * KV + h) * NS + split) * G + tid] =
          make_float2(m, dd);
  }
  __syncthreads();
  // each thread merges 4 elements of a head: with one live split they are
  // the output, else this split's partial, which stays in the L2 for the
  // block that combines
  TQ* out = static_cast<TQ*>(a.out);
  const size_t pbase = (size_t)(b * KV + h) * NS * G;    // (b, h, split 0, g 0)
  for (int i = tid; i < G * (D / 4); i += THREADS) {
    const int g = i / (D / 4), d0 = (i % (D / 4)) * 4;
    const float m = pm_s[g];
    float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < CW; ++w) {
      const float4 x = *reinterpret_cast<const float4*>(cs_s + (w * MAXG + g) * CS + d0);
      const float f = expf(mw_s[w][g] - m);
      c.x += x.x * f;
      c.y += x.y * f;
      c.z += x.z * f;
      c.w += x.w * f;
    }
    if (live > 1) {
      *reinterpret_cast<float4*>(a.part_ctx + (pbase + (size_t)split * G + g) * D + d0) = c;
    } else {
      const float den = pd_s[g];
      const size_t o = ((size_t)b * a.H + h * G + g) * D + d0;
      store_f32(out, o, den > 0.f ? c.x / den : 0.f);
      store_f32(out, o + 1, den > 0.f ? c.y / den : 0.f);
      store_f32(out, o + 2, den > 0.f ? c.z / den : 0.f);
      store_f32(out, o + 3, den > 0.f ? c.w / den : 0.f);
    }
  }
  if (live == 1) return;

  // more than one live split: the last to arrive combines.  Every writer
  // fences its partial; one thread counts the block in (the acquire orders
  // the last block's loads below after every other block's stores)
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int prev;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                 : "=r"(prev) : "l"(a.counters + b * KV + h) : "memory");
    last_s = prev == live - 1;
    if (last_s) a.counters[b * KV + h] = 0;
  }
  __syncthreads();
  if (!last_s) return;

  // each head: the common max, the partials' weights w_s [G][live], the
  // denominator
  float* w_s = reinterpret_cast<float*>(ring) + CW * MAXG * CS;
  const float2* md = reinterpret_cast<const float2*>(a.part_md) + pbase;
  for (int g = warp; g < G; g += THREADS / 32) {
    float mx = NEG_INF;
    for (int sp = lane; sp < live; sp += 32) mx = fmaxf(mx, __ldcg(md + (size_t)sp * G + g).x);
    mx = warp_max(mx);
    float den = 0.f;
    for (int sp = lane; sp < live; sp += 32) {
      const float2 v = __ldcg(md + (size_t)sp * G + g);
      const float w = expf(v.x - mx);
      w_s[g * MAX_SPLITS + sp] = w;
      den += v.y * w;
    }
    den = warp_sum(den);
    if (lane == 0) den_s[g] = den;
  }
  __syncthreads();
  // out: a thread for each 4 elements of a head, the partials in split order
  for (int i = tid; i < G * (D / 4); i += THREADS) {
    const int g = i / (D / 4), d0 = (i % (D / 4)) * 4;
    float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int sp = 0; sp < live; ++sp) {
      const float w = w_s[g * MAX_SPLITS + sp];
      const float4 x = __ldcg(reinterpret_cast<const float4*>(
          a.part_ctx + (pbase + (size_t)sp * G + g) * D + d0));
      c.x += x.x * w;
      c.y += x.y * w;
      c.z += x.z * w;
      c.w += x.w * w;
    }
    const float den = den_s[g];
    const size_t o = ((size_t)b * a.H + h * G + g) * D + d0;
    store_f32(out, o, den > 0.f ? c.x / den : 0.f);
    store_f32(out, o + 1, den > 0.f ? c.y / den : 0.f);
    store_f32(out, o + 2, den > 0.f ? c.z / den : 0.f);
    store_f32(out, o + 3, den > 0.f ? c.w / den : 0.f);
  }
}

// the 4-D map of one layer's pages [KV, P, page, D] (strides in bytes),
// boxes of one 128-byte panel by BR rows of one page, 128-byte swizzle;
// what lies past the pool reads as zeros
template <typename C>
cudaError_t page_map(CUtensorMap* map, const void* base, int D, int page, int P, int KV,
                     long long s_kv, long long s_page, long long s_row, int BR) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  constexpr CUtensorMapDataType dt = std::is_same<C, float>::value
                                         ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)page, (cuuint64_t)P, (cuuint64_t)KV};
  const cuuint64_t strides[3] = {(cuuint64_t)s_row * sizeof(C), (cuuint64_t)s_page * sizeof(C),
                                 (cuuint64_t)s_kv * sizeof(C)};
  const cuuint32_t box[4] = {(cuuint32_t)(PB / sizeof(C)), (cuuint32_t)BR, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, dt, 4, const_cast<void*>(base), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

int gcd(int x, int y) { return y == 0 ? x : gcd(y, x % y); }

template <int D, typename TQ, typename TK>
cudaError_t launch(PagedArgs a, const void* kp, const void* vp, int B, int P, long long s_kv,
                   long long s_page, long long s_row, float* part, cudaStream_t stream) {
  using GE = Geo<D, TK>;
  const int NS = max(1, (a.npg * a.page + a.R - 1) / a.R);  // (an empty table: zeros)
  if (NS > MAX_SPLITS || (NS > 1 && part == nullptr)) return cudaErrorInvalidValue;
  a.BR = gcd(a.page, SR);
  const int G = a.H / a.KV;
  a.part_ctx = part;
  a.part_md = part == nullptr ? nullptr : part + (size_t)B * a.KV * NS * G * D;
  CUtensorMap kmap, vmap;
  cudaError_t e = page_map<TK>(&kmap, kp, D, a.page, P, a.KV, s_kv, s_page, s_row, a.BR);
  if (e == cudaSuccess) e = page_map<TK>(&vmap, vp, D, a.page, P, a.KV, s_kv, s_page, s_row, a.BR);
  if (e != cudaSuccess) return e;
  constexpr size_t smem = GE::RING + 1024;               // + alignment
  auto kern = paged_attn<D, TQ, TK>;
  static bool smem_set = false;                          // once, before any graph capture
  if (!smem_set) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)   // room for two blocks an SM
      e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  kern<<<dim3(NS, a.KV, B), THREADS, smem, stream>>>(kmap, vmap, a);
  return cudaGetLastError();
}

template <typename TQ, typename TK>
cudaError_t by_d(int D, const PagedArgs& a, const void* kp, const void* vp, int B, int P,
                 long long s_kv, long long s_page, long long s_row, float* part,
                 cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<64, TQ, TK>(a, kp, vp, B, P, s_kv, s_page, s_row, part, stream);
    case 128:
      return launch<128, TQ, TK>(a, kp, vp, B, P, s_kv, s_page, s_row, part, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B, H, D] (q_f32: f32, else bf16), contiguous; pages [KV, P, page, D]
// (kv_f32: f32, else bf16) with strides s_kv, s_page, s_row in elements
// (each a multiple of 16 bytes), D contiguous, 16-byte aligned; lengths [B]
// int32; table [B, npg] int32, rows table_stride apart; out like q.  R
// (positions a split) a power of two >= 64 with ceil(npg * page / R) <=
// 64 splits; part: B*KV*NS*G*(D+2) floats (16-byte aligned; null at one
// split); counters: B*KV ints, zero (every call leaves them zero).
int bn_paged_attention(const void* q, const void* kp, const void* vp, const int* lengths,
                       const int* table, int table_stride, int npg, int B, int H, int KV,
                       int D, int P, int page, long long s_kv, long long s_page,
                       long long s_row, int R, int q_f32, int kv_f32, void* out,
                       float* part, int* counters, cudaStream_t stream) {
  if (KV <= 0 || H % KV != 0 || H / KV > MAXG || R < SR || (R & (R - 1)) != 0 || page <= 0)
    return (int)cudaErrorInvalidValue;
  const PagedArgs a = {q, lengths, table, nullptr, nullptr, counters, out,
                       table_stride, npg, H, KV, page, R, 0};
  using bf = __nv_bfloat16;
  cudaError_t e;
  if (q_f32 && kv_f32)
    e = by_d<float, float>(D, a, kp, vp, B, P, s_kv, s_page, s_row, part, stream);
  else if (q_f32)
    e = by_d<float, bf>(D, a, kp, vp, B, P, s_kv, s_page, s_row, part, stream);
  else if (kv_f32)
    e = by_d<bf, float>(D, a, kp, vp, B, P, s_kv, s_page, s_row, part, stream);
  else
    e = by_d<bf, bf>(D, a, kp, vp, B, P, s_kv, s_page, s_row, part, stream);
  return (int)e;
}

const char* bn_paged_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
