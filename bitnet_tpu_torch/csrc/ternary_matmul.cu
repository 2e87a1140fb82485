// Ternary matmuls for Hopper (sm_90a): int8 or bf16 activations x 2-bit codes.
//
// Replaces these Pallas kernels of bitnet_tpu/ops/ternary_matmul.py:
//   K1 bn_w2a8_normed  <- ternary_matmul_stacked (:316, pallas_call :375),
//                         body _qk256_w2a8_normed_kernel (:201): decode, M <= 64;
//                         also the unstacked w2a8_normed site of
//                         _ternary_matmul_2d (pallas_call :1073)
//   K4 bn_w2a8_gemm    <- ternary_matmul_stacked_prefill (:417, pallas_call
//                         :464), body _qk256_w2a8_kernel (:173): prefill GEMM;
//                         also its unstacked site in _ternary_matmul_2d (:1177)
//   K32 bn_w2a8_matmul <- experiments/exp_w2a8.py w2a8_matmul (:181, pallas_call
//                         :201): K4's two launches with one scale for the
//                         tensor (below)
// K6, the bf16 qk256 body of the same site (bitnet_tpu/ops/ternary_matmul.py:1177,
// _qk256_kernel), is a column-scale mode of K10's two forms in
// ternary_matmul_tl.cu.
//
// Weights: int32 words [Kp/16, Np] (one layer of the [L, Kp/16, Np] stack;
// the caller passes the layer's base pointer, so the TPU's scalar-prefetch
// layer index has no counterpart here).  Within each 256-row K tile, word s,
// byte j, plane p hold the code of K row p*64 + 4s + j, so
// t = (w >> 2p) & 0x03030303 is 4 consecutive K values; the biased code
// t + ((t >> 1) & 0x01010101) = c + (c >> 1) in {0,1,3,4} (LUT value + 2) is
// one dp4a operand / one 4-byte slice of an int8 MMA fragment.  The +2 bias
// is removed after the integer dot: y = (acc - 2*sumq) * sx * scale[n].
//
// What bounds them on the card, and what the design does about it:
//  - K1 (M = B <= 64) is bound by the weight bytes (Kp*Np/4 per call): a
//    GEMV where every word is read once by one thread, 32 columns per block
//    on coalesced 128-byte rows, 8 word rows in flight per thread, and the
//    int8 activations broadcast from shared memory.  The preamble (SwiGLU,
//    RMSNorm, absmax int8 quantization, row sums) needs the whole row before
//    the dot, and Hopper blocks cannot carry scratch across the grid as the
//    TPU grid did.  For M <= 2 (decode at B <= 2, the main path) every
//    block recomputes it from the x row in L2 while its first weight words
//    are in flight: one launch, and a call at M=1 is bound by launch latency
//    rather than by two dependent kernels.  Larger M runs a per-row quantize
//    kernel first and the GEMV reads its int8 rows (M*Kp bytes) from L2;
//    nothing in the engine sends M > 2 until decode pools of B > 2 are
//    ported (ROADMAP queue 1 #9), which will choose between the two designs.
//  - K4 (prefill, M = B*T rows, 8 to 16384 and more) is bound by int8
//    operations at M >= 128 and by the weight bytes below.  The product runs
//    on wgmma (the only way to the card's int8 rate), transposed so that the
//    ternary weights are its register-fed A operand: a thread reads each of
//    its words once a K tile and decodes all four planes from it (a few
//    integer ops a register, next to the asynchronous wgmma), and the tokens
//    are wgmma's N, so a prefill of 8 rows fills an 8-wide tile rather than
//    a 64-row one.  The int8 rows and the words arrive by TMA (128-byte
//    swizzle for the rows, rows past M zero-filled), in a ring of stages
//    under mbarriers fed by a producer warpgroup.  Where the column blocks
//    leave SMs idle, K is split over a thread block cluster and the int32
//    partials are added through distributed shared memory.  The row
//    quantization (the K1 preamble's kernel, without norm or SwiGLU) is the
//    first of the call's two launches; the GEMM is its programmatic
//    dependent.  On the H100 the GEMM runs at 25-46 % of the int8 peak
//    and the quantization adds 11-59 % to its time (PERF.md,
//    PR 10): at M = 512 each block has one tile of output, so the first
//    tile's latency and the epilogue are not hidden, and in the main loop
//    shared memory carries the int8 rows twice a tile (the TMA writes, then
//    each column half's wgmmas read them) beside the words.
// The integer accumulation is exact (|acc| <= 4*127*Kp < 2^31), so the
// results do not depend on the tiling; the float epilogue uses _rn
// intrinsics so it is never contracted into an FMA and rounds exactly as
// the plain PyTorch version does.

#include <cooperative_groups.h>
#include <cuda.h>

#include "ternary_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace bn;

// ---------------------------------------------------------------------------
// K1 preamble: one block per row m.  x is [M, K] (or [M, 2K] when glu).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void w2a8_quantize_rows(const T* __restrict__ x, int x_stride, int K,
                                   int glu, const float* __restrict__ gamma,
                                   float eps, int8_t* __restrict__ xq,
                                   float* __restrict__ sx_out,
                                   int* __restrict__ sumq_out) {
  extern __shared__ float row[];         // K floats
  __shared__ float redf[32];
  __shared__ int redi[32];
  const int m = blockIdx.x;
  const T* xr = x + (size_t)m * x_stride;
  float ss = 0.f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float v = load_f32(xr, k);
    if (glu) {                           // silu(gate) * up
      const float sig = 1.f / (1.f + expf(-v));
      v = __fmul_rn(__fmul_rn(v, sig), load_f32(xr, (size_t)K + k));
    }
    row[k] = v;
    ss += v * v;
  }
  if (gamma != nullptr) {                // RMSNorm: (x * rsqrt(mean + eps)) * g
    const float var = block_reduce(ss, redf, false) / (float)K;
    const float r = 1.f / sqrtf(var + eps);
    __syncthreads();
    for (int k = threadIdx.x; k < K; k += blockDim.x)
      row[k] = __fmul_rn(__fmul_rn(row[k], r), gamma[k]);
  }
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) amax = fmaxf(amax, fabsf(row[k]));
  amax = block_reduce(amax, redf, true);
  const float sx = fmaxf(amax, 1e-8f) / 127.f;
  int sq = 0;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float q = fminf(fmaxf(rintf(row[k] / sx), -127.f), 127.f);
    xq[(size_t)m * K + k] = (int8_t)q;
    sq += (int)q;
  }
  sq = block_reduce(sq, redi, false);
  if (threadIdx.x == 0) {
    sx_out[m] = sx;
    sumq_out[m] = sq;
  }
}

// ---------------------------------------------------------------------------
// K1 GEMV: 256 threads = 8 warps; block = 32 columns x MB rows of M.
// Stage = 1024 K values = 64 word rows, 8 per warp.
// ---------------------------------------------------------------------------
constexpr int GEMV_STAGE_K = 1024;

template <int MB, typename T>
__global__ void __launch_bounds__(256)
w2a8_gemv(const int8_t* __restrict__ xq, int M, int Kp,
          const int* __restrict__ words, int Np,
          const int* __restrict__ sumq, const float* __restrict__ sx,
          const float* __restrict__ scale, const T* __restrict__ resid,
          T* __restrict__ out, int N) {
  __shared__ int xs[MB][GEMV_STAGE_K / 4];
  __shared__ int red[MB][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * 32 + lane;
  const int m0 = blockIdx.y * MB;
  for (int i = threadIdx.x; i < MB * 32; i += blockDim.x) red[i / 32][i % 32] = 0;
  int acc[MB];
#pragma unroll
  for (int mm = 0; mm < MB; ++mm) acc[mm] = 0;

  for (int k0 = 0; k0 < Kp; k0 += GEMV_STAGE_K) {
    const int kc = min(GEMV_STAGE_K, Kp - k0);        // multiple of 256
    const int rows = kc / 16;
    int wv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = warp + 8 * i;
      wv[i] = r < rows ? __ldg(words + (size_t)(k0 / 16 + r) * Np + n) : 0;
    }
    __syncthreads();
    const int kc4 = kc / 4;
    for (int i = threadIdx.x; i < MB * kc4; i += blockDim.x) {
      const int mm = i / kc4, kk = i % kc4, m = m0 + mm;
      xs[mm][kk] = m < M
          ? reinterpret_cast<const int*>(xq + (size_t)m * Kp + k0)[kk] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = warp + 8 * i;
      if (r < rows) {
        const int base = (r / 16) * (KT / 4) + (r % 16);   // int index in stage
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int c = biased_plane(wv[i], p);
#pragma unroll
          for (int mm = 0; mm < MB; ++mm)
            acc[mm] = __dp4a(c, xs[mm][base + p * 16], acc[mm]);
        }
      }
    }
  }
#pragma unroll
  for (int mm = 0; mm < MB; ++mm) atomicAdd(&red[mm][lane], acc[mm]);
  __syncthreads();
  for (int i = threadIdx.x; i < MB * 32; i += blockDim.x) {
    const int mm = i / 32, m = m0 + mm, nc = blockIdx.x * 32 + (i % 32);
    if (m < M && nc < N) {
      float y = (float)(red[mm][i % 32] - 2 * sumq[m]);
      y = __fmul_rn(__fmul_rn(y, sx[m]), scale[nc]);
      if (resid != nullptr) y = __fadd_rn(y, load_f32(resid, (size_t)m * N + nc));
      store_f32(out, (size_t)m * N + nc, y);
    }
  }
}

// ---------------------------------------------------------------------------
// K1 for M <= FUSED_MAX_M (decode at B <= 2): ONE launch.  Every block
// recomputes the row preamble (the x row comes from L2: 5-27 KB) while its
// first 16 weight words per thread are already in flight, keeps the int8 rows
// in shared memory for all of K, and streams the words with the next
// stage's loads issued before the current stage's dp4a.  Block 0 also
// writes xq / sx / sumq out, so a test can hold them against the plain
// version.
// ---------------------------------------------------------------------------
constexpr int FUSED_PF = 16;                         // word rows in flight a thread
constexpr int FUSED_STAGE = FUSED_WARPS * FUSED_PF;  // word rows a stage

template <int MB, typename T>
__global__ void __launch_bounds__(FUSED_THREADS)
w2a8_gemv_fused(const T* __restrict__ x, int x_stride, int M, int Kp, int glu,
                const float* __restrict__ gamma, float eps,
                const int* __restrict__ words, int Np,
                const float* __restrict__ scale, const T* __restrict__ resid,
                T* __restrict__ out, int N, int8_t* __restrict__ xq_out,
                float* __restrict__ sx_out, int* __restrict__ sumq_out) {
  __shared__ int xs[MB][FUSED_MAX_K / 4];
  __shared__ int red[MB][32];
  __shared__ float sx_s[MB];
  __shared__ int sumq_s[MB];
  __shared__ float redf[32];
  __shared__ int redi[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * 32 + lane;
  const int rows = Kp / 16;                         // word rows
  int wv[FUSED_PF];
#pragma unroll
  for (int i = 0; i < FUSED_PF; ++i) {              // stage 0 in flight
    const int r = warp + FUSED_WARPS * i;
    wv[i] = r < rows ? __ldg(words + (size_t)r * Np + n) : 0;
  }
  for (int i = threadIdx.x; i < MB * 32; i += blockDim.x) red[i / 32][i % 32] = 0;

  fused_quantize_rows(x, x_stride, M, Kp, glu, gamma, eps, xs, sx_s, sumq_s,
                      nullptr, redf, redi, xq_out, sx_out, sumq_out);

  int acc[MB];
#pragma unroll
  for (int mm = 0; mm < MB; ++mm) acc[mm] = 0;
  for (int r0 = 0; r0 < rows; r0 += FUSED_STAGE) {
    int nx[FUSED_PF];
#pragma unroll
    for (int i = 0; i < FUSED_PF; ++i) {            // next stage in flight
      const int r = r0 + FUSED_STAGE + warp + FUSED_WARPS * i;
      nx[i] = r < rows ? __ldg(words + (size_t)r * Np + n) : 0;
    }
#pragma unroll
    for (int i = 0; i < FUSED_PF; ++i) {
      const int r = r0 + warp + FUSED_WARPS * i;
      if (r < rows) {
        const int base = (r / 16) * (KT / 4) + (r % 16);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int c = biased_plane(wv[i], p);
#pragma unroll
          for (int mm = 0; mm < MB; ++mm)
            acc[mm] = __dp4a(c, xs[mm][base + p * 16], acc[mm]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < FUSED_PF; ++i) wv[i] = nx[i];
  }
#pragma unroll
  for (int mm = 0; mm < MB; ++mm) atomicAdd(&red[mm][lane], acc[mm]);
  __syncthreads();
  for (int i = threadIdx.x; i < MB * 32; i += blockDim.x) {
    const int mm = i / 32, nc = blockIdx.x * 32 + (i % 32);
    if (mm < M && nc < N) {
      float y = (float)(red[mm][i % 32] - 2 * sumq_s[mm]);
      y = __fmul_rn(__fmul_rn(y, sx_s[mm]), scale[nc]);
      if (resid != nullptr) y = __fadd_rn(y, load_f32(resid, (size_t)mm * N + nc));
      store_f32(out, (size_t)mm * N + nc, y);
    }
  }
}

// ---------------------------------------------------------------------------
// K4 GEMM on wgmma.  The product is taken transposed, out^T[n, m] =
// W^T[n, k] . xq^T[k, m]: output columns are wgmma's 64-row M, whose A
// fragment comes from registers, and tokens are its N (BT = 8..128), whose
// B tile (the int8 rows, K-major) comes from shared memory.  Thread (g, t)
// of warp w holds A rows 16w+g and 16w+g+8 at K offsets 4t..4t+3 and
// 16+4t..16+4t+3 of each 32-K step, and word s, plane p of a column holds
// exactly such 4 K values (K rows p*64 + 4s + j): a thread reads its 8
// words of a 256-row K tile once and decodes all four planes from them.
//
// 384 threads: warpgroup 0 is the producer (one thread issues the copies),
// warpgroups 1 and 2 each own 64 of the block's 128 output columns.  A ring
// of stages, each one K tile: the BT int8 rows as two TMA boxes of 128
// bytes a row with the 128-byte swizzle wgmma's B descriptor reads (rows
// past M are zero-filled by the TMA unit), and the 16 word rows of the 128
// columns as one TMA box G4_WLD ints wide: its 8 extra columns pad each
// row, so the consumers' word reads are free of bank conflicts.  Three
// copies a stage: one thread issues them.  Full barriers count the bytes,
// empty barriers the 8 consumer warps.  A consumer decodes the next tile's
// A fragments while this tile's wgmmas run, into a second register set
// kept apart from the first until the wait (fence_operand).
//
// K may be split over the z blocks of a thread block cluster (up to 8):
// each block leaves its int32 partial tile in its shared memory, and after
// the cluster barrier block r adds the partials of its share of the rows
// from every rank and applies the epilogue.  Integer sums are exact in any
// order, so the split never changes a bit.
//
// The epilogue has two modes.  K4's, with one scale a column:
// ((acc - 2 sumq) * sx) * scale[n] in x's dtype.  K32's (scale == nullptr),
// with one scale for the tensor: (acc - 2 sumq) * (sx * tscale), the product
// sx * tscale rounded once in f32 before it multiplies, as the W2A8
// prototype rounds it, written as bf16 whatever x's dtype.  Nothing else
// differs: K32 at M = 1 reads each word once, 128 columns a block, through
// the TMA ring, and pads no row (rows past M read as zeros, never written).
// ---------------------------------------------------------------------------
constexpr int G4_COLS = 128;                  // output columns a block
constexpr int G4_WLD = G4_COLS + 8;           // ints a word row in shared memory
constexpr int G4_WTILE = (KT / 16) * G4_WLD * 4;   // bytes of a stage's words
constexpr int G4_PLD = G4_COLS + 4;           // ints a row of the partial tile
constexpr int G4_THREADS = 384;
constexpr int G4_MAX_SPLIT = 8;               // the portable cluster size

template <int BT>
struct G4Tile {
  static constexpr int STAGES = BT >= 64 ? 4 : 8;
  static constexpr int XBOX = BT * 128;       // bytes of one TMA box
  static constexpr int XTILE = 2 * XBOX;      // a K tile of BT int8 rows
  static constexpr int RING = STAGES * (XTILE + G4_WTILE);
  static constexpr int SMEM = RING + 2 * STAGES * 8 + 8 * BT + 1024;   // + alignment
  static_assert(BT * G4_PLD * 4 <= STAGES * XTILE, "partial tile fits the ring");
};

template <int BT>
__global__ void __launch_bounds__(G4_THREADS, 1)
w2a8_gemm(const __grid_constant__ CUtensorMap xmap,
          const __grid_constant__ CUtensorMap wmap, int M, int Kp, int Np,
          const int* __restrict__ sumq,
          const float* __restrict__ sx, const float* __restrict__ scale,
          float tscale, void* __restrict__ out, int N, int bf16_out) {
  using Tile = G4Tile<BT>;
  constexpr int STAGES = Tile::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* xs = smem;                                     // STAGES x XTILE
  int* ws = reinterpret_cast<int*>(smem + STAGES * Tile::XTILE);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Tile::RING);
  uint64_t* empty = full + STAGES;
  int* sumq_s = reinterpret_cast<int*>(empty + STAGES);   // the rows' sums and scales
  float* sx_s = reinterpret_cast<float*>(sumq_s + BT);

  cg::cluster_group cluster = cg::this_cluster();
  const int S = gridDim.z, rank = blockIdx.z;             // cluster (1, 1, S)
  const int nk = Kp / KT;
  const int kt0 = rank * nk / S, kt1 = (rank + 1) * nk / S;
  const int n0 = blockIdx.x * G4_COLS, m0 = blockIdx.y * BT;
  const int ncols = min(G4_COLS, Np - n0);                // 64 or 128
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);                            // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int nl = 2 * (threadIdx.x % (G4_COLS / 2));       // the epilogue's columns
  const int n = n0 + nl;
  const bool tensor_scale = scale == nullptr;             // K32's epilogue
  const float sc0 = !tensor_scale && n < N ? scale[n] : 0.f;
  const float sc1 = !tensor_scale && n + 1 < N ? scale[n + 1] : 0.f;
  __syncthreads();

  int acc[BT / 2];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) acc[i] = 0;
  const int ct = threadIdx.x & 127, w = ct >> 5, lane = ct & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int c = wg - 1;                                   // consumer's column half
  const bool active = wg > 0 && 64 * c < ncols;

  if (wg == 0) {                                          // producer
    if (threadIdx.x == 0) {
      int st = 0, ph = 0;
      for (int kt = kt0; kt < kt1; ++kt) {
        mbar_wait(&empty[st], ph ^ 1);
        mbar_expect_tx(&full[st], Tile::XTILE + G4_WTILE);
        uint8_t* xdst = xs + st * Tile::XTILE;
        tma_load_2d(ws + st * (G4_WTILE / 4), &wmap, &full[st], n0, kt * (KT / 16));
        if (kt == kt0) grid_dependency_wait();
        tma_load_2d(xdst, &xmap, &full[st], kt * KT, m0);
        tma_load_2d(xdst + Tile::XBOX, &xmap, &full[st], kt * KT + 128, m0);
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
    // the epilogue's operands, read now so that their latency hides behind
    // the main loop
    grid_dependency_wait();
    for (int i = ct + 128 * c; i < BT && m0 + i < M; i += 256) {
      sumq_s[i] = sumq[m0 + i];
      sx_s[i] = sx[m0 + i];
    }
    const int col = 64 * c + 16 * w + g;                  // A row g's column
    // the A fragments of the tile in stage st: word rows t4 + 4i of
    // columns col and col + 8.  32-K step (p, h) covers K rows p*64 + 32h
    // ..: words 8h + t4 (K offsets 4t4..) and 8h + 4 + t4 (16 + 4t4..)
    auto decode = [&](int st, uint32_t (&a)[8][4]) {
      const int* wt = ws + st * (G4_WTILE / 4);
      int wv[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wv[i][0] = wt[(t4 + 4 * i) * G4_WLD + col];
        wv[i][1] = wt[(t4 + 4 * i) * G4_WLD + col + 8];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          a[2 * p + h][0] = biased_plane(wv[2 * h][0], p);
          a[2 * p + h][1] = biased_plane(wv[2 * h][1], p);
          a[2 * p + h][2] = biased_plane(wv[2 * h + 1][0], p);
          a[2 * p + h][3] = biased_plane(wv[2 * h + 1][1], p);
        }
    };
    // the next tile's words are decoded while this tile's wgmmas run
    uint32_t a[8][4];
    int st = 0, ph = 0;
    if (kt0 < kt1) {
      mbar_wait(&full[0], 0);
      decode(0, a);
    }
    for (int kt = kt0; kt < kt1; ++kt) {
      const uint32_t xb = smem_u32(xs + st * Tile::XTILE);
#pragma unroll
      for (int i = 0; i < BT / 2; ++i) fence_operand(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int h = 0; h < 2; ++h)                       // box p/2, bytes (p%2)*64 + 32h
          wgmma_s8(acc, a[2 * p + h],
                   sw128_desc(xb + (p >> 1) * Tile::XBOX + (p & 1) * 64 + 32 * h));
      wgmma_commit();
      const int nst = st + 1 == STAGES ? 0 : st + 1, nph = nst == 0 ? ph ^ 1 : ph;
      uint32_t next[8][4];
      if (kt + 1 < kt1) {
        mbar_wait(&full[nst], nph);
        decode(nst, next);
      }
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < BT / 2; ++i) fence_operand(acc[i]);
      if (lane == 0) mbar_arrive(&empty[st]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          fence_operand(a[i][e]);          // the wgmmas above read a until the wait
          a[i][e] = next[i][e];
        }
      st = nst;
      ph = nph;
    }
  }
  __syncthreads();                       // every wgmma has read its stage

  // the int32 partial tile [BT tokens][128 columns], over the ring
  int* part = reinterpret_cast<int*>(smem);
  if (active) {
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 64 * c + 16 * w + g + (e & 2 ? 8 : 0);
        const int m = 8 * j + 2 * t4 + (e & 1);
        part[m * G4_PLD + r] = acc[4 * j + e];
      }
  }
  // block r of a split adds the partials of rows [r0, r1) over the ranks
  const int r0 = rank * BT / S, r1 = (rank + 1) * BT / S;
  if (S > 1) cluster.sync();             // every block's partial is in place
  else __syncthreads();
  // a thread stores two adjacent columns of every sixth row
  const bool pair = N % 2 == 0 && n + 1 < N;
  const int rend = min(r1, M - m0);
#pragma unroll 4
  for (int ml = r0 + threadIdx.x / (G4_COLS / 2); ml < rend;
       ml += G4_THREADS / (G4_COLS / 2)) {
    const int* at = part + ml * G4_PLD + nl;
    int2 v = *reinterpret_cast<const int2*>(at);
    for (int q = 1; q < S; ++q) {
      const int2 t = *reinterpret_cast<const int2*>(
          cluster.map_shared_rank(at, (rank + q) % S));
      v.x += t.x;
      v.y += t.y;
    }
    float y0, y1;
    if (tensor_scale) {
      const float s = __fmul_rn(sx_s[ml], tscale);
      y0 = __fmul_rn((float)(v.x - 2 * sumq_s[ml]), s);
      y1 = __fmul_rn((float)(v.y - 2 * sumq_s[ml]), s);
    } else {
      y0 = __fmul_rn(__fmul_rn((float)(v.x - 2 * sumq_s[ml]), sx_s[ml]), sc0);
      y1 = __fmul_rn(__fmul_rn((float)(v.y - 2 * sumq_s[ml]), sx_s[ml]), sc1);
    }
    const size_t o = (size_t)(m0 + ml) * N + n;
    if (pair) {
      if (bf16_out)
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + o) =
            __halves2bfloat162(__float2bfloat16_rn(y0), __float2bfloat16_rn(y1));
      else
        *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(y0, y1);
    } else {
      for (int e = 0; e < 2 && n + e < N; ++e) {
        if (bf16_out) store_f32(static_cast<__nv_bfloat16*>(out), o + e, e ? y1 : y0);
        else store_f32(static_cast<float*>(out), o + e, e ? y1 : y0);
      }
    }
  }
  if (S > 1) cluster.sync();             // no block leaves while it is read
}

template <typename T>
cudaError_t launch_quantize(const T* x, int x_stride, int M, int K, int glu,
                            const float* gamma, float eps, int8_t* xq, float* sx,
                            int* sumq, cudaStream_t stream) {
  const size_t smem = (size_t)K * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        w2a8_quantize_rows<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  w2a8_quantize_rows<T><<<M, 512, smem, stream>>>(x, x_stride, K, glu, gamma, eps,
                                                  xq, sx, sumq);
  return cudaGetLastError();
}

template <int BT>
cudaError_t launch_gemm(const CUtensorMap& xmap, const CUtensorMap& wmap, int M,
                        int Kp, int Np, const int* sumq, const float* sx,
                        const float* scale, float tscale, void* out, int N,
                        int bf16_out, int split, cudaStream_t stream) {
  auto kern = w2a8_gemm<BT>;
  static bool smem_set = false;           // once, before any graph capture
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         G4Tile<BT>::SMEM);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Np + G4_COLS - 1) / G4_COLS, (M + BT - 1) / BT, split);
  cfg.blockDim = dim3(G4_THREADS, 1, 1);
  cfg.dynamicSmemBytes = G4Tile<BT>::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, xmap, wmap, M, Kp, Np, sumq, sx,
                                     scale, tscale, out, N, bf16_out);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T>
cudaError_t launch_normed(const void* x, int x_stride, int M, int K, int glu,
                          const float* gamma, float eps, const int* words,
                          int Np, const float* scale, const void* resid,
                          void* out, int N, int8_t* xq, float* sx, int* sumq,
                          cudaStream_t stream) {
  const T* r = static_cast<const T*>(resid);
  T* o = static_cast<T*>(out);
  if (M <= FUSED_MAX_M && K <= FUSED_MAX_K) {
    const T* xt = static_cast<const T*>(x);
#define BN_FUSED(MBV)                                                          \
  w2a8_gemv_fused<MBV, T><<<Np / 32, FUSED_THREADS, 0, stream>>>(              \
      xt, x_stride, M, K, glu, gamma, eps, words, Np, scale, r, o, N, xq, sx,  \
      sumq)
    if (M == 1) BN_FUSED(1);
    else BN_FUSED(2);
#undef BN_FUSED
    return cudaGetLastError();
  }
  cudaError_t e = launch_quantize(static_cast<const T*>(x), x_stride, M, K, glu,
                                  gamma, eps, xq, sx, sumq, stream);
  if (e != cudaSuccess) return e;
  w2a8_gemv<8, T><<<dim3(Np / 32, (M + 7) / 8), 256, 0, stream>>>(
      xq, M, K, words, Np, sumq, sx, scale, r, o, N);
  return cudaGetLastError();
}

// The rows of x (dtype 0 = float32, 1 = bfloat16, row stride x_stride)
// quantized into xq [M, Kp] / sx [M] / sumq [M], then the GEMM with bt rows
// a block and K split over split blocks of a cluster; out [M, N] (bf16 if
// bf16_out, else f32), one scale a column or, with scale == nullptr, tscale
// for the tensor.  Two launches.
cudaError_t w2a8_two_launches(const void* x, int x_stride, int M, int Kp,
                              const int* words, int Np, const float* scale,
                              float tscale, void* out, int N, int8_t* xq, float* sx,
                              int* sumq, int dtype, int bf16_out, int bt, int split,
                              cudaStream_t stream) {
  if (split < 1 || split > G4_MAX_SPLIT || (split & (split - 1)) || split > Kp / KT)
    return cudaErrorInvalidValue;
  cudaError_t e = dtype == 1
      ? launch_quantize(static_cast<const __nv_bfloat16*>(x), x_stride, M, Kp, 0,
                        nullptr, 0.f, xq, sx, sumq, stream)
      : launch_quantize(static_cast<const float*>(x), x_stride, M, Kp, 0, nullptr,
                        0.f, xq, sx, sumq, stream);
  if (e != cudaSuccess) return e;
  // the int8 rows: boxes of 128 bytes x bt rows, 128-byte swizzle (rows past
  // M read as zeros); the words: 16 rows of G4_WLD columns, the 8 past the
  // block's 128 padding each row in shared memory (zeros past Np)
  CUtensorMap xmap, wmap;
  e = tma_map_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, Kp, M, Kp, 128, bt,
                 CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = tma_map_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_INT32, words, Np, Kp / 16,
                   (uint64_t)Np * 4, G4_WLD, KT / 16, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != cudaSuccess) return e;
#define BN_GEMM(BTV)                                                          \
  launch_gemm<BTV>(xmap, wmap, M, Kp, Np, sumq, sx, scale, tscale, out, N,     \
                   bf16_out, split, stream)
  switch (bt) {
    case 8: return BN_GEMM(8);
    case 16: return BN_GEMM(16);
    case 32: return BN_GEMM(32);
    case 64: return BN_GEMM(64);
    case 128: return BN_GEMM(128);
    default: return cudaErrorInvalidValue;
  }
#undef BN_GEMM
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, resid and out share it).
// Returns cudaGetLastError() after the launches.
int bn_w2a8_normed(const void* x, int x_stride, int M, int K, int glu,
                   const float* gamma, float eps, const int* words, int Np,
                   const float* scale, const void* resid, void* out, int N,
                   int8_t* xq, float* sx, int* sumq, int dtype,
                   cudaStream_t stream) {
  if (dtype == 1)
    return (int)launch_normed<__nv_bfloat16>(x, x_stride, M, K, glu, gamma, eps,
                                             words, Np, scale, resid, out, N,
                                             xq, sx, sumq, stream);
  return (int)launch_normed<float>(x, x_stride, M, K, glu, gamma, eps, words,
                                   Np, scale, resid, out, N, xq, sx, sumq,
                                   stream);
}

// K4: the rows of x (dtype 0 = float32, 1 = bfloat16, row stride x_stride)
// quantized into xq [M, Kp] / sx [M] / sumq [M], then the GEMM with bt rows
// a block (8, 16, 32, 64 or 128) and K split over split blocks of a cluster
// (1, 2, 4 or 8, at most Kp / 256); out [M, N] in x's dtype.  Two launches.
int bn_w2a8_gemm(const void* x, int x_stride, int M, int Kp, const int* words,
                 int Np, const float* scale, void* out, int N, int8_t* xq,
                 float* sx, int* sumq, int dtype, int bt, int split,
                 cudaStream_t stream) {
  if (M < 1 || Kp % KT || Np % 64 || N > Np) return (int)cudaErrorInvalidValue;
  return (int)w2a8_two_launches(x, x_stride, M, Kp, words, Np, scale, 0.f, out, N,
                                xq, sx, sumq, dtype, dtype == 1, bt, split, stream);
}

// K32: x [M, K] (dtype as above, rows contiguous) times words [K/16, N]
// (K % 256 == 0, N % 8 == 0) with one scale for the tensor: the same two
// launches, out [M, N] bf16 = f32(acc - 2 sumq) * (sx * scale).
int bn_w2a8_matmul(const void* x, int M, int K, const int* words, int N, float scale,
                   void* out, int8_t* xq, float* sx, int* sumq, int dtype, int bt,
                   int split, cudaStream_t stream) {
  if (M < 1 || K < KT || K % KT || N < 8 || N % 8) return (int)cudaErrorInvalidValue;
  return (int)w2a8_two_launches(x, K, M, K, words, N, nullptr, scale, out, N, xq, sx,
                                sumq, dtype, 1, bt, split, stream);
}

const char* bn_ternary_matmul_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
