// The fused W2A8 FFN for Hopper (sm_90a): gate|up GEMM with SiLU(gate) * up,
// per-token per-F-tile int8 requantization, down GEMM.
//
// Replaces the Pallas kernel of bitnet_tpu/ops/ffn_fused.py:
//   K24 bn_ffn_w2a8  <- ffn_w2a8_fused (:106, pallas_call :148), body
//                       _ffn_kernel (:34)
//
// Weights: K1's int32 words (ternary_common.cuh): the fused gate|up layer
// [Kp/16, 2F] (gate columns 0..F-1, up columns F..2F-1) and the down layer
// [F/16, Hp], with per-column f32 scales [2F] and [Hp].
//
// The function, as the Pallas kernel computes it (the tile width bf is part
// of it: the requantization groups are bf columns wide):
//   xq = int8(x / sx), sx = max|x| / 127 (per row), sumq = sum(xq)
//   for each F-tile f of width bf, in order:
//     g, u  = ((xq . W - 2 sumq) * sx) * s   over all of K (exact int32 dots)
//     act   = (g * sigmoid(g)) * u            (f32)
//     aq    = int8(act / sa), sa = max|act over the tile| / 127, sq2 = sum(aq)
//     y    += ((aq . Wd[tile] - 2 sq2) * sa) * sd
//   out = y in x's dtype (no residual)
// The f32 sum over tiles runs in tile order from zero, so the result is
// deterministic and equals the plain version wherever the integer parts
// agree.
//
// Four launches under one wrapper and one counter, each after the first a
// programmatic dependent of the one before: each lets the next start at
// once (griddepcontrol.launch_dependents), and the next waits for it
// (griddepcontrol.wait) only where it reads what the last one wrote, so a
// GEMM's first FG_PREFETCH stages of words stream in while the launch
// before it runs:
//   1. quantize_groups<T>     one block a row: xq [M, Kp] (zeros past K;
//                             x read unpadded, in its own dtype), sx, sumq
//   2. ffn_gemm<BT, false>    gate|up on wgmma with the SiLU * up epilogue:
//                             act f32 [M, F] (<= 1.8 MB at M = 32, F = 14336:
//                             it stays in the 50 MB L2)
//   3. quantize_groups<float> one block a (row, F-tile): aq, sa, sq2
//   4. ffn_gemm<BT, true>     down on wgmma over the tiles, each tile's
//                             exact dot held apart and the f32 terms added in
//                             tile order
// No block of launch 2 sees a whole F-tile of act (a tile spans bf/64
// blocks), so the requantization is its own small launch between the GEMMs;
// it reads act once from the L2.
//
// What bounds it.  The bytes: at the 8B shapes (K = H = 4096, F = 14336)
// the gate|up words are 4096/4 * 28672 = 29.36 MB and the down words
// 14336/4 * 4096 = 14.68 MB: 44.04 MB, 0.0131 ms at 3.35 TB/s; the int8
// operations (2*M*K*2F + 2*M*F*H = 11.3 G at M = 32) take 0.0057 ms at
// 1979 TOP/s.  Both GEMMs are K4's design (ternary_matmul.cu, w2a8_gemm):
// the product transposed, out^T = W^T . q^T, so the words' planes are
// wgmma's register A operand and the tokens its N; M <= BT <= 32 puts every
// row in one block, so each word is read once a call, by TMA, into a ring of
// stages under mbarriers.  On the H100 the TMA stream alone reaches about
// 2.3 TB/s; what holds the GEMMs to half that is the consumers' work a K
// tile (13 integer operations a word to decode its planes, eight wgmmas of
// N = BT, the wait), which an SM does no faster with two blocks than with
// one, then the chain of four dependent launches (PERF.md, K24's finding).

#include <cooperative_groups.h>

#include "ternary_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace bn;

// ---------------------------------------------------------------------------
// Launches 1 and 3: block (g, m) quantizes x[m, g*gw : (g+1)*gw] to int8
// with its own absmax scale; q[m, g*gw + k] for k < gw, zeros for
// gw <= k < qw (one group a row only), s[m*ng + g], sums[m*ng + g].
// ---------------------------------------------------------------------------
constexpr int QG_EPT = 16;                  // values a thread holds: groups <= 8192

template <typename T>
__global__ void __launch_bounds__(512)
quantize_groups(const T* __restrict__ x, int x_stride, int gw, int qw,
                int8_t* __restrict__ q, int q_stride, float* __restrict__ s,
                int* __restrict__ sums) {
  __shared__ float redf[32];
  __shared__ int redi[32];
  launch_dependents();
  grid_dependency_wait();                            // x may be the last launch's
  const int g = blockIdx.x, m = blockIdx.y, ng = gridDim.x;
  const T* xr = x + (size_t)m * x_stride + (size_t)g * gw;
  int8_t* qr = q + (size_t)m * q_stride + (size_t)g * gw;
  // one read of the group when it fits the registers, else two
  const bool held = gw <= QG_EPT * 512;
  float v[QG_EPT];
  float amax = 0.f;
  if (held) {
#pragma unroll
    for (int i = 0; i < QG_EPT; ++i) {
      const int k = threadIdx.x + 512 * i;
      v[i] = k < gw ? load_f32(xr, k) : 0.f;
      amax = fmaxf(amax, fabsf(v[i]));
    }
  } else {
    for (int k = threadIdx.x; k < gw; k += blockDim.x) amax = fmaxf(amax, fabsf(load_f32(xr, k)));
  }
  amax = block_reduce(amax, redf, true);
  const float sx = fmaxf(amax, 1e-8f) / 127.f;
  int sq = 0;
  auto quantize = [&](int k, float xv) {
    const float qv = fminf(fmaxf(rintf(xv / sx), -127.f), 127.f);
    qr[k] = (int8_t)qv;
    sq += (int)qv;
  };
  if (held) {
#pragma unroll
    for (int i = 0; i < QG_EPT; ++i) {
      const int k = threadIdx.x + 512 * i;
      if (k < gw) quantize(k, v[i]);
    }
  } else {
    for (int k = threadIdx.x; k < gw; k += blockDim.x) quantize(k, load_f32(xr, k));
  }
  for (int k = gw + threadIdx.x; k < qw; k += blockDim.x) qr[k] = 0;
  sq = block_reduce(sq, redi, false);
  if (threadIdx.x == 0) {
    s[(size_t)m * ng + g] = sx;
    sums[(size_t)m * ng + g] = sq;
  }
}

// ---------------------------------------------------------------------------
// Launches 2 and 4: the two GEMMs on wgmma, K4's transposed design.  384
// threads: warpgroup 0 is the producer (one thread issues the copies),
// warpgroups 1 and 2 each own 64 output columns.  A ring of stages, each
// one 256-row K tile: the BT int8 rows as two TMA boxes of 128 bytes a row
// with the 128-byte swizzle wgmma's B descriptor reads (rows past M are
// zero-filled by the TMA unit), and the words as four TMA boxes of 16 word
// rows x 32 columns, two a consumer warpgroup, also with the 128-byte
// swizzle.  Full barriers count the bytes, empty barriers the 8 consumer
// warps.
//
// The word boxes' layout.  Thread (g, t4) of warp w holds A rows 16w + g and
// 16w + g + 8 at the word rows t4 + 4i of a K tile; with dense 128-byte rows
// the four t4 of a column would share a bank (K4 pads its rows by 8 columns,
// 6 % more bytes).  Here A row g (or g + 8) of warp w is column
// 32*box + 4*kk + g (g < 4) or 32*box + 16 + 4*kk + g - 4 (g >= 4) of the
// warpgroup's 64, with k = 2w (or 2w + 1), box = k / 4, kk = k % 4: under
// the swizzle (16-byte chunk j of row r lands at chunk j ^ (r % 8)) the 32
// lanes of each load fall in 32 banks and no byte is read twice.  The
// partial tiles are stored by real column.
//
// DOWN = false (launch 2, gate|up): block x owns gate columns 64x .. 64x+63
// (warpgroup 1) and their up columns F + 64x .. (warpgroup 2).  K may be
// split over the z blocks of a cluster (up to 8) where the column blocks
// leave SMs idle: each block leaves its int32 partial tile in its shared
// memory, and after the cluster barrier block r adds those of its share of
// the rows from every rank (exact in any order) and writes
// act = (g * sigmoid(g)) * u in f32.
//
// DOWN = true (launch 4): block x owns output columns 128x .. 128x+127.
// Cluster rank r holds the exact int32 dots of the requantization tiles of
// down_span: a tile's dot is kept in a partial tile of its own, the last in
// the ring after the loop and the others in slots past the ring, filled
// when the loop crosses a tile's end (or, with more ranks than tiles, a
// tile's K tiles are split over ranks whose partials add as integers).
// After the cluster barrier each output element is summed in tile order
// from zero, y += ((dot_f - 2 sq2) * sa) * sd, with dot_f read through
// distributed shared memory from the rank(s) that hold it.
// ---------------------------------------------------------------------------
constexpr int FG_THREADS = 384;
constexpr int FG_BOX = (KT / 16) * 128;     // bytes of a word box: 16 rows x 32 ints
constexpr int FG_WTILE = 4 * FG_BOX;        // a stage's words
constexpr int FG_PLD = 128 + 4;             // ints a row of a partial tile
// stages whose words are in flight before the dependency wait: more slow
// the launch before (the row quantization, waiting on the same memory) by
// more than they save
constexpr int FG_PREFETCH = 2;
constexpr int FG_MAX_SPLIT = 8;             // the portable cluster size
constexpr int FG_MAX_SMEM = 232448;         // a block's shared memory on the H100

template <int BT>
struct FfnTile {
  // two blocks fit an SM at every BT (one tile a rank)
  static constexpr int STAGES = BT == 32 ? 6 : 8;
  static constexpr int XBOX = BT * 128;     // bytes of one TMA box of rows
  static constexpr int XTILE = 2 * XBOX;    // a K tile of BT int8 rows
  static constexpr int RING = STAGES * (XTILE + FG_WTILE);
  static constexpr int SLOT = BT * FG_PLD * 4;   // an int32 partial tile
  // + barriers, the rows' sums and scales, alignment; + SLOT per extra tile
  static constexpr int BASE = RING + 2 * STAGES * 8 + 8 * BT + 1024;
  static_assert(SLOT <= RING, "a partial tile fits the ring");
};

struct FfnGemmArgs {
  int M, nk;           // rows; 256-row K tiles of the product
  int F;               // gate|up: the up columns' offset and act's row stride
  int Np;              // word columns (2F or Hp)
  int nf, nb;          // down: requantization tiles, K tiles a tile
  const int* sums;     // gate|up: sumq [M]; down: sq2 [M, nf]
  const float* rs;     // gate|up: sx [M]; down: sa [M, nf]
  const float* cs;     // column scales [Np]
  void* out;           // gate|up: act f32 [M, F]; down: [M, N]
  int N, bf16_out;
};

// down: the requantization tiles [fa, fb) and K tiles [k0, k1) of cluster
// rank r of S.  S <= nf: whole tiles, r*nf/S .. (r+1)*nf/S; else S is a
// multiple of nf and each tile's K tiles are split over S / nf ranks.
struct Span {
  int fa, fb, k0, k1;
};
__device__ __forceinline__ Span down_span(int r, int S, int nf, int nb) {
  if (S <= nf) {
    const int fa = r * nf / S, fb = (r + 1) * nf / S;
    return {fa, fb, fa * nb, fb * nb};
  }
  const int R = S / nf, f = r / R, q = r % R;
  return {f, f + 1, f * nb + q * nb / R, f * nb + (q + 1) * nb / R};
}

// a consumer's accumulators into a partial tile [BT rows][128 columns]
template <int BT>
__device__ __forceinline__ void store_partial(int* part, const int (&acc)[BT / 2], int col0,
                                              const int (&colw)[2], int t4) {
#pragma unroll
  for (int j = 0; j < BT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      part[(8 * j + 2 * t4 + (e & 1)) * FG_PLD + col0 + colw[e >> 1]] = acc[4 * j + e];
}

template <int BT, bool DOWN>
__global__ void __launch_bounds__(FG_THREADS, 1)
ffn_gemm(const __grid_constant__ CUtensorMap xmap,
         const __grid_constant__ CUtensorMap wmap, const FfnGemmArgs a) {
  using Tile = FfnTile<BT>;
  constexpr int STAGES = Tile::STAGES;
  extern __shared__ uint8_t smem_raw[];
  launch_dependents();
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* xs = smem;                                     // STAGES x XTILE
  uint8_t* ws = smem + STAGES * Tile::XTILE;              // STAGES x WTILE
  int* part = reinterpret_cast<int*>(smem);               // over the ring, after the loop

  cg::cluster_group cluster = cg::this_cluster();
  const int S = gridDim.z, rank = blockIdx.z;             // cluster (1, 1, S)
  int kt0, kt1;
  if (DOWN) {
    const Span sp = down_span(rank, S, a.nf, a.nb);
    kt0 = sp.k0;
    kt1 = sp.k1;
  } else {
    kt0 = rank * a.nk / S;
    kt1 = (rank + 1) * a.nk / S;
  }
  // the slots of a rank's tiles before its last (down), then the barriers
  int* slots = reinterpret_cast<int*>(smem + Tile::RING);
  const int nslots = DOWN ? (S <= a.nf ? (a.nf + S - 1) / S - 1 : 0) : 0;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Tile::RING + nslots * Tile::SLOT);
  uint64_t* empty = full + STAGES;
  int* sumq_s = reinterpret_cast<int*>(empty + STAGES);
  float* sx_s = reinterpret_cast<float*>(sumq_s + BT);

  // the word columns of the two consumer warpgroups
  const int cb0 = DOWN ? 128 * blockIdx.x : 64 * blockIdx.x;
  const int cb1 = DOWN ? cb0 + 64 : a.F + cb0;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);                            // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int acc[BT / 2];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) acc[i] = 0;
  const int ct = threadIdx.x & 127, w = ct >> 5, lane = ct & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int c = wg - 1;                                   // consumer's column half
  const bool active = wg > 0 && (c == 0 ? cb0 : cb1) < a.Np;
  // A rows 16w + g (e = 0) and 16w + g + 8 (e = 1): their columns among the
  // warpgroup's 64, and the byte offsets of word rows t4 + 4i in a stage
  int colw[2], off[4][2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int k = 2 * w + e, box = k >> 2, kk = k & 3;
    const int chunk = g < 4 ? kk : 4 + kk;
    colw[e] = 32 * box + 4 * chunk + (g & 3);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = t4 + 4 * i;
      off[i][e] = (2 * c + box) * FG_BOX + r * 128 + ((chunk ^ (r & 7)) << 4) + ((g & 3) << 2);
    }
  }

  if (wg == 0) {                                          // producer
    if (threadIdx.x == 0) {
      // the words do not depend on the launch before: the first stages'
      // are in flight before the wait, the rows after it
      auto load_words = [&](int st, int kt) {
        mbar_expect_tx(&full[st], Tile::XTILE + FG_WTILE);
        uint8_t* wdst = ws + st * FG_WTILE;
        const int row = kt * (KT / 16);
        tma_load_2d(wdst, &wmap, &full[st], cb0, row);
        tma_load_2d(wdst + FG_BOX, &wmap, &full[st], cb0 + 32, row);
        tma_load_2d(wdst + 2 * FG_BOX, &wmap, &full[st], cb1, row);
        tma_load_2d(wdst + 3 * FG_BOX, &wmap, &full[st], cb1 + 32, row);
      };
      const int npre = min(FG_PREFETCH, kt1 - kt0);
      for (int i = 0; i < npre; ++i) load_words(i, kt0 + i);
      grid_dependency_wait();
      int st = 0, ph = 0;
      for (int kt = kt0; kt < kt1; ++kt) {
        if (kt - kt0 >= npre) {
          mbar_wait(&empty[st], ph ^ 1);
          load_words(st, kt);
        }
        uint8_t* xdst = xs + st * Tile::XTILE;
        tma_load_2d(xdst, &xmap, &full[st], kt * KT, 0);
        tma_load_2d(xdst + Tile::XBOX, &xmap, &full[st], kt * KT + 128, 0);
        if (++st == STAGES) { st = 0; ph ^= 1; }
      }
    }
    __syncwarp();                        // warp 0 meets the block barriers whole
  } else if (!active) {                // a column half past Np: keep the ring turning
    int st = 0, ph = 0;
    for (int kt = kt0; kt < kt1; ++kt) {
      mbar_wait(&full[st], ph);
      if (lane == 0) mbar_arrive(&empty[st]);
      if (++st == STAGES) { st = 0; ph ^= 1; }
    }
  } else {                                                // consumers
    grid_dependency_wait();
    if (!DOWN)                 // the epilogue's operands, read now behind the loop
      for (int i = ct + 128 * c; i < a.M; i += 256) {
        sumq_s[i] = a.sums[i];
        sx_s[i] = a.rs[i];
      }
    // the A fragments of the tile in stage st.  32-K step (p, h) covers K
    // rows p*64 + 32h ..: word rows 8h + t4 (K offsets 4t4 ..) and
    // 8h + 4 + t4 (16 + 4t4 ..)
    auto decode = [&](int st, uint32_t (&af)[8][4]) {
      const uint8_t* wt = ws + st * FG_WTILE;
      uint32_t pl[4][2][4];                 // [word][A row][plane]
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          biased_planes(*reinterpret_cast<const uint32_t*>(wt + off[i][e]), pl[i][e]);
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          af[2 * p + h][0] = pl[2 * h][0][p];
          af[2 * p + h][1] = pl[2 * h][1][p];
          af[2 * p + h][2] = pl[2 * h + 1][0][p];
          af[2 * p + h][3] = pl[2 * h + 1][1][p];
        }
    };
    // one K tile an iteration: its fragments decoded, its wgmmas issued
    // and waited for.  The fragments are rewritten only after the wait: a
    // wgmma reads its A registers asynchronously, and decoding the next
    // tile's during this one's wgmmas, as K4 does, gave wrong sums now and
    // then in the down GEMM (its wgmmas read fragments already overwritten)
    int st = 0, ph = 0;
    for (int kt = kt0; kt < kt1; ++kt) {
      uint32_t af[8][4];
      mbar_wait(&full[st], ph);
      decode(st, af);
      const uint32_t xb = smem_u32(xs + st * Tile::XTILE);
#pragma unroll
      for (int i = 0; i < BT / 2; ++i) fence_operand(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int h = 0; h < 2; ++h)                       // box p/2, bytes (p%2)*64 + 32h
          wgmma_s8(acc, af[2 * p + h],
                   sw128_desc(xb + (p >> 1) * Tile::XBOX + (p & 1) * 64 + 32 * h));
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < BT / 2; ++i) fence_operand(acc[i]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) fence_operand(af[i][e]);   // read until the wait
      if (lane == 0) mbar_arrive(&empty[st]);
      // down: a tile of the rank ends before its last: keep its dot apart
      if (DOWN && kt + 1 < kt1 && (kt + 1 - kt0) % a.nb == 0) {
        store_partial<BT>(slots + ((kt + 1 - kt0) / a.nb - 1) * (Tile::SLOT / 4), acc,
                          64 * c, colw, t4);
#pragma unroll
        for (int i = 0; i < BT / 2; ++i) acc[i] = 0;
      }
      if (++st == STAGES) { st = 0; ph ^= 1; }
    }
  }
  __syncthreads();                       // every wgmma has read its stage
  if (active) store_partial<BT>(part, acc, 64 * c, colw, t4);
  if (S > 1) cluster.sync();             // every block's partials are in place
  else __syncthreads();
  grid_dependency_wait();

  // block r of the cluster finishes rows [r0, r1)
  const int r0 = rank * BT / S, rend = min((rank + 1) * BT / S, a.M);
  if (!DOWN) {
    // a thread: two adjacent gate columns (and their up columns) of every
    // twelfth row
    const int nl = 2 * (threadIdx.x % 32);
    const int n = cb0 + nl;
    const float sg0 = a.cs[n], sg1 = a.cs[n + 1];
    const float su0 = a.cs[a.F + n], su1 = a.cs[a.F + n + 1];
    float* act = static_cast<float*>(a.out);
    for (int ml = r0 + threadIdx.x / 32; ml < rend; ml += FG_THREADS / 32) {
      const int* at = part + ml * FG_PLD + nl;
      int2 gv = *reinterpret_cast<const int2*>(at);
      int2 uv = *reinterpret_cast<const int2*>(at + 64);
      for (int q = 1; q < S; ++q) {
        const int* rt = cluster.map_shared_rank(at, (rank + q) % S);
        const int2 tg = *reinterpret_cast<const int2*>(rt);
        const int2 tu = *reinterpret_cast<const int2*>(rt + 64);
        gv.x += tg.x;
        gv.y += tg.y;
        uv.x += tu.x;
        uv.y += tu.y;
      }
      const int bq = 2 * sumq_s[ml];
      const float sxm = sx_s[ml];
      const float g0 = __fmul_rn(__fmul_rn((float)(gv.x - bq), sxm), sg0);
      const float g1 = __fmul_rn(__fmul_rn((float)(gv.y - bq), sxm), sg1);
      const float u0 = __fmul_rn(__fmul_rn((float)(uv.x - bq), sxm), su0);
      const float u1 = __fmul_rn(__fmul_rn((float)(uv.y - bq), sxm), su1);
      const float s0 = 1.f / (1.f + expf(-g0)), s1 = 1.f / (1.f + expf(-g1));
      *reinterpret_cast<float2*>(act + (size_t)ml * a.F + n) =
          make_float2(__fmul_rn(__fmul_rn(g0, s0), u0), __fmul_rn(__fmul_rn(g1, s1), u1));
    }
  } else {
    // a thread: two adjacent output columns of every sixth row
    const int nl = 2 * (threadIdx.x % 64);
    const int n = cb0 + nl;
    const float sd0 = n < a.Np ? a.cs[n] : 0.f, sd1 = n + 1 < a.Np ? a.cs[n + 1] : 0.f;
    const int R = S > a.nf ? S / a.nf : 1;                // ranks a tile
    const bool pair = a.N % 2 == 0 && n + 1 < a.N;
    for (int ml = r0 + threadIdx.x / 64; ml < rend; ml += FG_THREADS / 64) {
      float y0 = 0.f, y1 = 0.f;
      for (int f = 0; f < a.nf; ++f) {
        int2 v = make_int2(0, 0);
        for (int q = 0; q < R; ++q) {
          int owner = f * R + q;
          const int* base = part;
          if (R == 1) {                  // the rank whose span holds tile f
            owner = ((f + 1) * S - 1) / a.nf;
            const Span sp = down_span(owner, S, a.nf, a.nb);
            if (f < sp.fb - 1) base = slots + (f - sp.fa) * (Tile::SLOT / 4);
          }
          const int2 t = *reinterpret_cast<const int2*>(
              cluster.map_shared_rank(base + ml * FG_PLD + nl, owner));
          v.x += t.x;
          v.y += t.y;
        }
        const size_t mf = (size_t)ml * a.nf + f;
        const int bq = 2 * a.sums[mf];
        const float sa = a.rs[mf];
        y0 = __fadd_rn(y0, __fmul_rn(__fmul_rn((float)(v.x - bq), sa), sd0));
        y1 = __fadd_rn(y1, __fmul_rn(__fmul_rn((float)(v.y - bq), sa), sd1));
      }
      const size_t o = (size_t)ml * a.N + n;
      if (pair) {
        if (a.bf16_out)
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(a.out) + o) =
              __halves2bfloat162(__float2bfloat16_rn(y0), __float2bfloat16_rn(y1));
        else
          *reinterpret_cast<float2*>(static_cast<float*>(a.out) + o) = make_float2(y0, y1);
      } else {
        for (int e = 0; e < 2 && n + e < a.N; ++e) {
          if (a.bf16_out) store_f32(static_cast<__nv_bfloat16*>(a.out), o + e, e ? y1 : y0);
          else store_f32(static_cast<float*>(a.out), o + e, e ? y1 : y0);
        }
      }
    }
  }
  if (S > 1) cluster.sync();             // no block leaves while it is read
}

// the shared memory launch 4 needs for up to `tiles` requantization tiles a rank
template <int BT>
size_t down_smem(int tiles) {
  return (size_t)FfnTile<BT>::BASE + (size_t)(tiles - 1) * FfnTile<BT>::SLOT;
}

// a launch as a programmatic dependent of the stream's last, on a cluster of
// (1, 1, split) blocks
template <typename... Args>
cudaError_t launch_dependent(void (*kern)(Args...), dim3 grid, int threads, size_t smem,
                             int split, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = 1;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int BT, bool DOWN>
cudaError_t launch_gemm(const CUtensorMap& xmap, const CUtensorMap& wmap,
                        const FfnGemmArgs& a, int blocks, int split, size_t smem,
                        cudaStream_t stream) {
  auto kern = ffn_gemm<BT, DOWN>;
  static bool smem_set = false;           // once, before any graph capture
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, FG_MAX_SMEM);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  return launch_dependent(kern, dim3(blocks, 1, split), FG_THREADS, smem, split, stream,
                          xmap, wmap, a);
}

struct FfnCall {
  const void* x;
  int x_stride, M, K, Kp;
  const int* gu_words;
  int F;
  const float* gu_scale;
  const int* d_words;
  int Hp;
  const float* d_scale;
  void* out;
  int N, bf, split, dsplit;
  int8_t* xq;
  float* sx;
  int* sumq;
  float* act;
  int8_t* aq;
  float* sa;
  int* sq2;
};

template <typename T, int BT>
cudaError_t launch_ffn(const FfnCall& p, int bf16_out, cudaStream_t stream) {
  const int nf = p.F / p.bf;
  quantize_groups<T><<<dim3(1, p.M), 512, 0, stream>>>(
      static_cast<const T*>(p.x), p.x_stride, p.K, p.Kp, p.xq, p.Kp, p.sx, p.sumq);
  cudaError_t e = cudaGetLastError();
  // the int8 rows: boxes of 128 bytes x BT rows, 128-byte swizzle (rows past
  // M read as zeros); the words: boxes of 32 columns x 16 rows, 128-byte
  // swizzle
  CUtensorMap xmap, wmap, amap, dmap;
  if (e == cudaSuccess)
    e = tma_map_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.xq, p.Kp, p.M, p.Kp, 128, BT,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = tma_map_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_INT32, p.gu_words, 2 * (uint64_t)p.F,
                   p.Kp / 16, 8 * (uint64_t)p.F, 32, KT / 16, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = tma_map_2d(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.aq, p.F, p.M, p.F, 128, BT,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = tma_map_2d(&dmap, CU_TENSOR_MAP_DATA_TYPE_INT32, p.d_words, p.Hp, p.F / 16,
                   4 * (uint64_t)p.Hp, 32, KT / 16, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  FfnGemmArgs g = {p.M, p.Kp / KT, p.F, 2 * p.F, nf, p.bf / KT, p.sumq, p.sx, p.gu_scale,
                   p.act, p.F, 0};
  e = launch_gemm<BT, false>(xmap, wmap, g, p.F / 64, p.split, FfnTile<BT>::BASE, stream);
  if (e != cudaSuccess) return e;
  e = launch_dependent(quantize_groups<float>, dim3(nf, p.M), 512, 0, 1, stream,
                       static_cast<const float*>(p.act), p.F, p.bf, p.bf, p.aq, p.F,
                       p.sa, p.sq2);
  if (e != cudaSuccess) return e;
  const int tiles = p.dsplit <= nf ? (nf + p.dsplit - 1) / p.dsplit : 1;
  FfnGemmArgs d = {p.M, p.F / KT, p.F, p.Hp, nf, p.bf / KT, p.sq2, p.sa, p.d_scale,
                   p.out, p.N, bf16_out};
  return launch_gemm<BT, true>(amap, dmap, d, (p.Hp + 127) / 128, p.dsplit,
                               down_smem<BT>(tiles), stream);
}

template <typename T>
cudaError_t launch_rows(const FfnCall& p, int bt, int bf16_out, cudaStream_t stream) {
  switch (bt) {
    case 8: return launch_ffn<T, 8>(p, bf16_out, stream);
    case 16: return launch_ffn<T, 16>(p, bf16_out, stream);
    default: return launch_ffn<T, 32>(p, bf16_out, stream);
  }
}

size_t down_smem_rows(int bt, int tiles) {
  return bt == 8 ? down_smem<8>(tiles) : bt == 16 ? down_smem<16>(tiles) : down_smem<32>(tiles);
}

}  // namespace

extern "C" {

// x [M, K] with rows x_stride values apart (dtype 0 = float32, 1 =
// bfloat16; out shares it), K <= Kp; gu_words [Kp/16, 2F], gu_scale f32
// [2F]; d_words [F/16, Hp], d_scale f32 [Hp]; out [M, N], N <= Hp.  bf: the
// requantization tiles' width (F % bf == 0, bf % 256 == 0); bt: rows a block
// (8, 16 or 32, >= M); split: the gate|up GEMM's K split (1, 2, 4 or 8, at
// most Kp/256); dsplit: the down GEMM's cluster (1, 2, 4 or 8; at most F/bf,
// or a multiple of it with at least one K tile a rank).  Scratch: xq int8
// [M, Kp] and aq int8 [M, F], both 16-byte aligned; sx f32 [M], sumq int32
// [M], act f32 [M, F], sa f32 [M, F/bf], sq2 int32 [M, F/bf].  Four
// launches; returns the first error.
int bn_ffn_w2a8(const void* x, int x_stride, int M, int K, int Kp, const int* gu_words,
                int F, const float* gu_scale, const int* d_words, int Hp,
                const float* d_scale, void* out, int N, int bf, int bt, int split,
                int dsplit, int8_t* xq, float* sx, int* sumq, float* act, int8_t* aq,
                float* sa, int* sq2, int dtype, cudaStream_t stream) {
  const bool pow2 = split >= 1 && split <= FG_MAX_SPLIT && !(split & (split - 1))
                    && dsplit >= 1 && dsplit <= FG_MAX_SPLIT && !(dsplit & (dsplit - 1));
  if (M < 1 || M > 32 || (bt != 8 && bt != 16 && bt != 32) || bt < M || K < 1 || K > Kp
      || Kp % KT || bf <= 0 || bf % KT || F % bf || Hp % 64 || N < 1 || N > Hp || !pow2
      || split > Kp / KT || ((uintptr_t)xq | (uintptr_t)aq) % 16)
    return (int)cudaErrorInvalidValue;
  const int nf = F / bf;
  if (dsplit > nf && (dsplit % nf || dsplit / nf > bf / KT)) return (int)cudaErrorInvalidValue;
  const int tiles = dsplit <= nf ? (nf + dsplit - 1) / dsplit : 1;
  if (down_smem_rows(bt, tiles) > FG_MAX_SMEM) return (int)cudaErrorInvalidValue;
  const FfnCall p = {x, x_stride, M, K, Kp, gu_words, F, gu_scale, d_words, Hp, d_scale,
                     out, N, bf, split, dsplit, xq, sx, sumq, act, aq, sa, sq2};
  if (dtype == 1) return (int)launch_rows<__nv_bfloat16>(p, bt, 1, stream);
  return (int)launch_rows<float>(p, bt, 0, stream);
}

const char* bn_ffn_fused_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
