// Ternary matmuls with per-32-row block scales (bitnet32 and TL1/TL2 weights)
// for Hopper (sm_90a).
//
// Replaces these Pallas kernels of bitnet_tpu/ops/ternary_matmul.py:
//   K10 bn_blockscale_bf16  <- the _bitnet32_kernel body (:138) of
//                              _ternary_matmul_2d (pallas_call :1177) and of
//                              ternary_matmul_stacked_tl (:502, pallas_call :555)
//   K11 bn_tl_w2a8_normed   <- ternary_matmul_stacked_tl_w2a8 (:890,
//                              pallas_call :960), body _tl_w2a8_fused_kernel (:753)
//   K12 bn_tl_bf16_normed   <- ternary_matmul_stacked_tl_fused (:669,
//                              pallas_call :733), body _bitnet32_fused_kernel (:573)
//
// Weights: K1's int32 words [Kp/16, Np] (ternary_common.cuh) plus f32 block
// scales s [Kp/32, Np] of the same layer, zero-padded.  LUT_BIAS picks the
// biased value of a code c: c + (c >> 1) in {0,1,3,4} (bitnet32, the LUT
// {-2,-1,1,2} plus 2) or c in {0..3} (TL levels {-2,-1,0,1} plus 2).
//
// What bounds them on the card, and what the design does about it:
//  - K10 has two forms: the decode form (below) for up to 16 rows, and for
//    more (prefill; the wrapper's M > MB) the GEMM it shares with K12
//    (pools, M = 3..64): K6's 64x64 block tile of bf16
//    mma.sync.m16n8k16 with a two-stage cp.async pipeline, the block scales
//    of the K tile (8 rows x 64 columns) streamed beside the words.  Each
//    B fragment register holds two K values of one 32-row block, so a
//    thread builds, per (column, block), a 4-entry table of the bf16 weight
//    of each code, bf16(v(c) * s) (K10: biased v, as :156) or
//    bf16((v(c) - 2) * s) (K12: unbiased, as :633), and expands the 2-bit
//    planes through it.  Decode is bound by the bytes of words and scales
//    (the scales are half the words' bytes), prefill by bf16 operations.
//    The GEMM's bias correction 2 * (sum32 @ s) is an f32 matmul outside,
//    as it is in XLA; padded K rows hold code 0, whose biased value is 0, so
//    a zero-padded scale never meets a nonzero weight.  K12 runs its row
//    preamble (SwiGLU, RMSNorm, bf16 rows) as a first launch.
//  - K10's decode form (M <= 16: the generic path's seven projections and
//    the stacked loop's four at decode rows): one lane per output column
//    reads K11's coalesced word rows, so every word and scale is read once
//    per call whatever M is; K is split over a thread block cluster (up to 8
//    blocks) where the column blocks alone leave the SMs idle (k / v: 20
//    column blocks on 132 SMs), and the cluster's partials are added in rank
//    order through distributed shared memory (one launch, no scratch, no
//    atomics: two runs give the same bits).  Each warp stages its half
//    tile's rows of x in its own slice of shared memory, rounded to bf16 (so
//    x comes in its own dtype, unpadded), and forms their 32-row sums there;
//    the correction 2 * sum32 * s[b, n] is kept beside the dot and
//    subtracted at the end, as the JAX epilogue subtracts corr.  The weight
//    of a code is looked up with two byte permutes from two registers that
//    hold the low and high bytes of the four bf16 weights bf16(v * s) of the
//    (column, block), the code-0 entry +0 (byte 0 of both is the zero the
//    lookup places in the f32's low half); x * w is exact in f32 and summed
//    there.  The generic seven at M = 1 take 8x their byte bound together
//    (PERF.md, Findings).
//  - K11 (decode, M <= 2) is bound by the bytes of words and scales: K1's
//    one-launch design (every block recomputes the int8 row preamble, the
//    same code as K1's, so the rows are K1's bit for bit) with the K
//    reduction factored over the scale blocks; rows longer than 8192 (the
//    8B down projection) take K1's two-kernel design instead (a row
//    preamble launch that also writes the 32-row block sums, then the
//    GEMV).  In the KT=256 word layout, scale block b of a tile is plane
//    p = b/2, words 8(b%2) .. 8(b%2)+7, so a thread owns a half tile (8
//    word rows) of one column: per plane, 8 dp4a give the block's exact
//    int32 partial, minus twice the block's activation sum (from the
//    preamble), then one f32 fma with s[b, n].
//    The Pallas kernel's [32, Kp] block-masked activation matrix (a Mosaic
//    lane-slicing workaround, :766-776) has no counterpart.  Per-warp f32
//    sums are added in a fixed order (no float atomics: runs repeat).

#include <cooperative_groups.h>

#include "ternary_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace bn;

// ---------------------------------------------------------------------------
// K10 / K12 GEMM
// ---------------------------------------------------------------------------
constexpr int GB_M = 64, GB_N = 64;
constexpr int XB_LD = KT + 8;         // bf16; conflict-free A fragment reads
constexpr int WS_LD = GB_N + 8;       // ints;  conflict-free B fragment reads
constexpr int SB = KT / 32;           // scale rows a K tile
constexpr size_t GEMM_SMEM =
    2 * (GB_M * XB_LD * sizeof(__nv_bfloat16) + (KT / 16) * WS_LD * sizeof(int) +
         SB * GB_N * sizeof(float));

// the bf16 bits of each code's weight under scale s, code c in bits 16c..16c+15
template <bool LUT_BIAS, bool UNBIASED>
__device__ __forceinline__ unsigned long long scaled_table(float s) {
  unsigned long long t = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int v = (LUT_BIAS ? c + (c >> 1) : c) - (UNBIASED ? 2 : 0);
    const __nv_bfloat16 b = __float2bfloat16_rn(__fmul_rn((float)v, s));
    t |= (unsigned long long)__bfloat16_as_ushort(b) << (16 * c);
  }
  return t;
}

// two consecutive K values (bytes j, j+1 of plane p of word w) through the
// table, as a bf16x2 fragment register, the lower K index in the low half
__device__ __forceinline__ unsigned table_pair(int w, int p, int j,
                                               unsigned long long tbl) {
  const int c0 = (w >> (8 * j + 2 * p)) & 3;
  const int c1 = (w >> (8 * (j + 1) + 2 * p)) & 3;
  return (unsigned)((tbl >> (16 * c0)) & 0xFFFFu) |
         ((unsigned)((tbl >> (16 * c1)) & 0xFFFFu) << 16);
}

// out[m, n] = sum_k x[m, k] * w[k, n] (- corr[m, n]) (+ resid[m, n]) for
// n < N; x bf16 [M, Kp]; corr f32 [M, Np] or null; resid [M, N] or null.
template <bool LUT_BIAS, bool UNBIASED, typename T>
__global__ void __launch_bounds__(128)
blockscale_gemm(const __nv_bfloat16* __restrict__ x, int M, int Kp,
                const int* __restrict__ words, int Np,
                const float* __restrict__ scales, const float* __restrict__ corr,
                const T* __restrict__ resid, T* __restrict__ out, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  typedef __nv_bfloat16 XTile[GB_M][XB_LD];
  typedef int WTile[KT / 16][WS_LD];
  typedef float STile[SB][GB_N];
  XTile* xs = reinterpret_cast<XTile*>(smem_raw);
  WTile* ws = reinterpret_cast<WTile*>(smem_raw + 2 * sizeof(XTile));
  STile* ss = reinterpret_cast<STile*>(smem_raw + 2 * sizeof(XTile) + 2 * sizeof(WTile));
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * GB_M, n0 = blockIdx.x * GB_N;
  const int nk = Kp / KT;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  auto load_tile = [&](int st, int kt) {
    const int k0 = kt * KT;
#pragma unroll
    for (int i = 0; i < 16; ++i) {            // 64 rows x 512 B of activations
      const int idx = tid + 128 * i, r = idx >> 5, c8 = (idx & 31) * 8;
      const bool ok = m0 + r < M;             // rows past M are zero-filled
      cp_async16(&xs[st][r][c8], x + (size_t)(ok ? m0 + r : 0) * Kp + k0 + c8, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {             // 16 word rows x 64 columns
      const int idx = tid + 128 * i, r = idx >> 4, c4 = (idx & 15) * 4;
      cp_async16(&ws[st][r][c4], words + (size_t)(k0 / 16 + r) * Np + n0 + c4, true);
    }
    {                                         // 8 scale rows x 64 columns
      const int r = tid >> 4, c4 = (tid & 15) * 4;
      cp_async16(&ss[st][r][c4], scales + (size_t)(kt * SB + r) * Np + n0 + c4, true);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  load_tile(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {
      load_tile(st ^ 1, kt + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < 4; ++p) {
#pragma unroll
      for (int hb = 0; hb < 2; ++hb) {         // scale block 2p + hb: K rows p*64 + 32hb ..
        unsigned long long tbl[4];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          tbl[ni] = scaled_table<LUT_BIAS, UNBIASED>(
              ss[st][2 * p + hb][wn * 32 + ni * 8 + g]);
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {       // K rows p*64 + 16h .. +15
          const int h = 2 * hb + h2;
          const int kb = p * 64 + 16 * h;
          unsigned a[2][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const int r = wm * 32 + mi * 16 + g;
            a[mi][0] = *reinterpret_cast<const unsigned*>(&xs[st][r][kb + t4 * 2]);
            a[mi][1] = *reinterpret_cast<const unsigned*>(&xs[st][r + 8][kb + t4 * 2]);
            a[mi][2] = *reinterpret_cast<const unsigned*>(&xs[st][r][kb + 8 + t4 * 2]);
            a[mi][3] = *reinterpret_cast<const unsigned*>(&xs[st][r + 8][kb + 8 + t4 * 2]);
          }
          // K row kb + 2*t4 (+1) is byte 2*(t4&1) (+1) of word row 4h + t4/2;
          // kb + 8 + 2*t4 (+1) the same bytes of word row 4h + 2 + t4/2
          const int j = (t4 & 1) * 2;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            const int col = wn * 32 + ni * 8 + g;
            const unsigned b0 = table_pair(ws[st][4 * h + (t4 >> 1)][col], p, j, tbl[ni]);
            const unsigned b1 = table_pair(ws[st][4 * h + 2 + (t4 >> 1)][col], p, j, tbl[ni]);
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][ni], a[mi], b0, b1);
          }
        }
      }
    }
    __syncthreads();                           // stage st is refilled next
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * 32 + mi * 16 + g + (e >= 2 ? 8 : 0);
        const int n = n0 + wn * 32 + ni * 8 + t4 * 2 + (e & 1);
        if (m < M && n < N) {
          float y = acc[mi][ni][e];
          if (corr != nullptr) y = __fsub_rn(y, corr[(size_t)m * Np + n]);
          if (resid != nullptr) y = __fadd_rn(y, load_f32(resid, (size_t)m * N + n));
          store_f32(out, (size_t)m * N + n, y);
        }
      }
}

template <bool LUT_BIAS, bool UNBIASED, typename T>
cudaError_t launch_gemm(const __nv_bfloat16* x, int M, int Kp, const int* words,
                        int Np, const float* scales, const float* corr,
                        const void* resid, void* out, int N, cudaStream_t stream) {
  static bool smem_set = false;           // once, before any graph capture
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(blockscale_gemm<LUT_BIAS, UNBIASED, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)GEMM_SMEM);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  dim3 grid(Np / GB_N, (M + GB_M - 1) / GB_M);
  blockscale_gemm<LUT_BIAS, UNBIASED, T><<<grid, 128, GEMM_SMEM, stream>>>(
      x, M, Kp, words, Np, scales, corr, static_cast<const T*>(resid),
      static_cast<T*>(out), N);
  return cudaGetLastError();
}

template <bool UNBIASED, typename T>
cudaError_t launch_gemm_lut(int lut_bias, const __nv_bfloat16* x, int M, int Kp,
                            const int* words, int Np, const float* scales,
                            const float* corr, const void* resid, void* out,
                            int N, cudaStream_t stream) {
  return lut_bias
      ? launch_gemm<true, UNBIASED, T>(x, M, Kp, words, Np, scales, corr, resid, out, N, stream)
      : launch_gemm<false, UNBIASED, T>(x, M, Kp, words, Np, scales, corr, resid, out, N, stream);
}

// ---------------------------------------------------------------------------
// K12 preamble: one block per row m, 512 threads: silu(gate) * up, RMSNorm,
// bf16 rows [M, K].  x is [M, K] (or [M, 2K] when glu).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(512)
bf16_rows(const T* __restrict__ x, int x_stride, int K, int glu,
          const float* __restrict__ gamma, float eps,
          __nv_bfloat16* __restrict__ xb) {
  extern __shared__ float row[];         // K floats
  __shared__ float redf[32];
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
  float r = 1.f;
  if (gamma != nullptr) {                // RMSNorm: (x * rsqrt(mean + eps)) * g
    const float var = block_reduce(ss, redf, false) / (float)K;
    r = 1.f / sqrtf(var + eps);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float v = gamma != nullptr ? __fmul_rn(__fmul_rn(row[k], r), gamma[k]) : row[k];
    xb[(size_t)m * K + k] = __float2bfloat16_rn(v);
  }
}

// ---------------------------------------------------------------------------
// K11: 512 threads = 16 warps; block = 32 columns (a lane each).  Warp w
// takes half tiles w, w + 16, ... (8 word rows each); the next half tile's
// words and scales are in flight while this one computes.  Rows up to
// FUSED_MAX_K take one launch (tl_w2a8_fused: every block runs the row
// preamble); longer rows (the 8B down projection, K = 14336) take two, as
// K1 does (tl_quantize_rows, then tl_w2a8_gemv reading the int8 rows and
// their 32-row block sums from L2 into shared memory).  Both end in the
// same block-partial dot and epilogue (tl_dot_epilogue).
// ---------------------------------------------------------------------------
__device__ __forceinline__ void tl_load_half(int ht, int halves, const int* __restrict__ words,
                                             const float* __restrict__ scales, int Np, int n,
                                             int (&w)[8], float (&s)[4]) {
  const int t = ht >> 1, h = ht & 1;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i] = ht < halves ? __ldg(words + (size_t)(t * 16 + 8 * h + i) * Np + n) : 0;
#pragma unroll
  for (int p = 0; p < 4; ++p)
    s[p] = ht < halves ? __ldg(scales + (size_t)(t * 8 + 2 * p + h) * Np + n) : 0.f;
}

// xs: MB int8 rows as ints, row stride xs_ld ints; sumqb: their 32-row block
// sums, row stride sb_ld; wv / sv: the warp's first half tile, in flight.
template <int MB, bool LUT_BIAS, typename T>
__device__ __forceinline__ void tl_dot_epilogue(
    const int* xs, int xs_ld, const int* sumqb, int sb_ld, const float* sx_s,
    float (*red)[MB][32], const int* __restrict__ words, int Np,
    const float* __restrict__ scales, int M, int Kp, const T* __restrict__ resid,
    T* __restrict__ out, int N, int (&wv)[8], float (&sv)[4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * 32 + lane;
  const int halves = Kp / 128;                      // 8 word rows each
  float y[MB];
#pragma unroll
  for (int mm = 0; mm < MB; ++mm) y[mm] = 0.f;
  for (int ht = warp; ht < halves; ht += FUSED_WARPS) {
    int wn[8];
    float sn[4];
    tl_load_half(ht + FUSED_WARPS, halves, words, scales, Np, n, wn, sn);
    const int t = ht >> 1, h = ht & 1;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int xi = t * 64 + p * 16 + 8 * h;       // int index of K row t*256 + p*64 + 32h
      const int b = t * 8 + 2 * p + h;              // the 32-row scale block
#pragma unroll
      for (int mm = 0; mm < MB; ++mm) {
        int acc = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          acc = __dp4a(biased_plane<LUT_BIAS>(wv[i], p), xs[mm * xs_ld + xi + i], acc);
        y[mm] = fmaf((float)(acc - 2 * sumqb[mm * sb_ld + b]), sv[p], y[mm]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) wv[i] = wn[i];
#pragma unroll
    for (int p = 0; p < 4; ++p) sv[p] = sn[p];
  }
#pragma unroll
  for (int mm = 0; mm < MB; ++mm) red[warp][mm][lane] = y[mm];
  __syncthreads();
  for (int i = threadIdx.x; i < MB * 32; i += blockDim.x) {
    const int mm = i / 32, nc = blockIdx.x * 32 + (i % 32);
    if (mm < M && nc < N) {
      float acc = 0.f;
      for (int w = 0; w < FUSED_WARPS; ++w) acc = __fadd_rn(acc, red[w][mm][i % 32]);
      float v = __fmul_rn(acc, sx_s[mm]);
      if (resid != nullptr) v = __fadd_rn(v, load_f32(resid, (size_t)mm * N + nc));
      store_f32(out, (size_t)mm * N + nc, v);
    }
  }
}

template <int MB, bool LUT_BIAS, typename T>
__global__ void __launch_bounds__(FUSED_THREADS)
tl_w2a8_fused(const T* __restrict__ x, int x_stride, int M, int Kp, int glu,
              const float* __restrict__ gamma, float eps,
              const int* __restrict__ words, int Np,
              const float* __restrict__ scales, const T* __restrict__ resid,
              T* __restrict__ out, int N, int8_t* __restrict__ xq_out,
              float* __restrict__ sx_out, int* __restrict__ sumq_out) {
  __shared__ int xs[MB][FUSED_MAX_K / 4];
  __shared__ int sumqb[MB][FUSED_MAX_K / 32];
  __shared__ float red[FUSED_WARPS][MB][32];
  __shared__ float sx_s[MB];
  __shared__ int sumq_s[MB];
  __shared__ float redf[32];
  __shared__ int redi[32];
  const int n = blockIdx.x * 32 + (threadIdx.x & 31);
  int wv[8];
  float sv[4];
  tl_load_half(threadIdx.x >> 5, Kp / 128, words, scales, Np, n, wv, sv);  // in flight

  fused_quantize_rows(x, x_stride, M, Kp, glu, gamma, eps, xs, sx_s, sumq_s,
                      sumqb, redf, redi, xq_out, sx_out, sumq_out);
  tl_dot_epilogue<MB, LUT_BIAS, T>(&xs[0][0], FUSED_MAX_K / 4, &sumqb[0][0],
                                   FUSED_MAX_K / 32, sx_s, red, words, Np, scales,
                                   M, Kp, resid, out, N, wv, sv);
}

// Launch 1 of K11's two-kernel path: one block of 512 threads per row m,
// K1's preamble (silu(gate) * up, RMSNorm, absmax int8 quantization, the
// same arithmetic as fused_quantize_rows, k = threadIdx.x + 512 i) plus the
// sums of each 32-row block (32 consecutive k are one warp's lanes).
template <typename T>
__global__ void __launch_bounds__(FUSED_THREADS)
tl_quantize_rows(const T* __restrict__ x, int x_stride, int K, int glu,
                 const float* __restrict__ gamma, float eps, int8_t* __restrict__ xq,
                 float* __restrict__ sx_out, int* __restrict__ sumq_out,
                 int* __restrict__ sumqb) {
  extern __shared__ float row[];         // K floats
  __shared__ float redf[32];
  __shared__ int redi[32];
  const int m = blockIdx.x;
  const T* xr = x + (size_t)m * x_stride;
  float ss = 0.f;
  for (int k = threadIdx.x; k < K; k += FUSED_THREADS) {
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
    for (int k = threadIdx.x; k < K; k += FUSED_THREADS)
      row[k] = __fmul_rn(__fmul_rn(row[k], r), gamma[k]);
  }
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += FUSED_THREADS) amax = fmaxf(amax, fabsf(row[k]));
  amax = block_reduce(amax, redf, true);
  const float sx = fmaxf(amax, 1e-8f) / 127.f;
  int sq = 0;
  for (int k = threadIdx.x; k < K; k += FUSED_THREADS) {   // K % 32 == 0: whole warps
    const int qi = (int)fminf(fmaxf(rintf(row[k] / sx), -127.f), 127.f);
    xq[(size_t)m * K + k] = (int8_t)qi;
    sq += qi;
    int bs = qi;
    for (int o = 16; o > 0; o >>= 1) bs += __shfl_xor_sync(0xffffffffu, bs, o);
    if ((threadIdx.x & 31) == 0) sumqb[(size_t)m * (K / 32) + (k >> 5)] = bs;
  }
  sq = block_reduce(sq, redi, false);
  if (threadIdx.x == 0) {
    sx_out[m] = sx;
    sumq_out[m] = sq;
  }
}

// Launch 2: the rows, their scales and block sums from L2 into dynamic
// shared memory (MB * Kp * 9/8 bytes), then K11's dot and epilogue.
template <int MB, bool LUT_BIAS, typename T>
__global__ void __launch_bounds__(FUSED_THREADS)
tl_w2a8_gemv(const int8_t* __restrict__ xq, const float* __restrict__ sx,
             const int* __restrict__ sumqb_g, int M, int Kp,
             const int* __restrict__ words, int Np, const float* __restrict__ scales,
             const T* __restrict__ resid, T* __restrict__ out, int N) {
  extern __shared__ int smem[];
  int* xs = smem;                                   // [MB][Kp / 4]
  int* sumqb = smem + MB * (Kp / 4);                // [MB][Kp / 32]
  __shared__ float red[FUSED_WARPS][MB][32];
  __shared__ float sx_s[MB];
  const int n = blockIdx.x * 32 + (threadIdx.x & 31);
  int wv[8];
  float sv[4];
  tl_load_half(threadIdx.x >> 5, Kp / 128, words, scales, Np, n, wv, sv);  // in flight
  for (int i = threadIdx.x; i < MB * (Kp / 4); i += FUSED_THREADS) {
    const int mm = i / (Kp / 4), kk = i % (Kp / 4);
    xs[i] = mm < M ? reinterpret_cast<const int*>(xq + (size_t)mm * Kp)[kk] : 0;
  }
  for (int i = threadIdx.x; i < MB * (Kp / 32); i += FUSED_THREADS) {
    const int mm = i / (Kp / 32);
    sumqb[i] = mm < M ? sumqb_g[(size_t)mm * (Kp / 32) + i % (Kp / 32)] : 0;
  }
  if (threadIdx.x < MB) sx_s[threadIdx.x] = (int)threadIdx.x < M ? sx[threadIdx.x] : 0.f;
  __syncthreads();
  tl_dot_epilogue<MB, LUT_BIAS, T>(xs, Kp / 4, sumqb, Kp / 32, sx_s, red, words, Np,
                                   scales, M, Kp, resid, out, N, wv, sv);
}

template <bool LUT_BIAS, typename T>
cudaError_t launch_tl_w2a8(const void* x, int x_stride, int M, int K, int glu,
                           const float* gamma, float eps, const int* words, int Np,
                           const float* scales, const void* resid, void* out,
                           int N, int8_t* xq, float* sx, int* sumq, int* sumqb,
                           cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* r = static_cast<const T*>(resid);
  T* o = static_cast<T*>(out);
  if (K <= FUSED_MAX_K) {
    if (M == 1)
      tl_w2a8_fused<1, LUT_BIAS, T><<<Np / 32, FUSED_THREADS, 0, stream>>>(
          xt, x_stride, M, K, glu, gamma, eps, words, Np, scales, r, o, N, xq, sx, sumq);
    else
      tl_w2a8_fused<2, LUT_BIAS, T><<<Np / 32, FUSED_THREADS, 0, stream>>>(
          xt, x_stride, M, K, glu, gamma, eps, words, Np, scales, r, o, N, xq, sx, sumq);
    return cudaGetLastError();
  }
  const size_t rsmem = (size_t)K * sizeof(float);
  if (rsmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        tl_quantize_rows<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rsmem);
    if (e != cudaSuccess) return e;
  }
  tl_quantize_rows<T><<<M, FUSED_THREADS, rsmem, stream>>>(xt, x_stride, K, glu, gamma,
                                                          eps, xq, sx, sumq, sumqb);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
#define BN_GEMV(MBV)                                                                \
  {                                                                                 \
    const size_t gsmem = (size_t)MBV * (K / 4 + K / 32) * sizeof(int);              \
    if (gsmem > 48 * 1024) {                                                        \
      e = cudaFuncSetAttribute(tl_w2a8_gemv<MBV, LUT_BIAS, T>,                      \
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)gsmem); \
      if (e != cudaSuccess) return e;                                               \
    }                                                                               \
    tl_w2a8_gemv<MBV, LUT_BIAS, T><<<Np / 32, FUSED_THREADS, gsmem, stream>>>(      \
        xq, sx, sumqb, M, K, words, Np, scales, r, o, N);                           \
  }
  if (M == 1) BN_GEMV(1) else BN_GEMV(2)
#undef BN_GEMV
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K10 decode form: grid (split, Np / 32), cluster (split, 1, 1); W warps a
// block.  Block s of a cluster takes half tiles [h0, h1) of its 32 columns
// (the split of Kp / 128 half tiles); warp w takes half tiles h0 + w,
// h0 + w + W, ... (8 word rows = 4 scale blocks of 32 K rows, as K11's),
// the next one's words, scales and rows of x in flight while it computes
// one.  A warp stages its half tile's rows of x in its own slice of shared
// memory (bf16-rounded f32; rows past M and K are 0) and forms their 32-row
// sums there, so warps never wait for each other until the end: the warps'
// partials are added in warp order, then the cluster's in rank order, each
// block adding a share of the outputs through distributed shared memory.
// ---------------------------------------------------------------------------
constexpr int DEC_MAX_M = 16;
constexpr int DEC_MAX_WARPS = 8;
constexpr int DEC_MAX_SPLIT = 8;          // the portable cluster size

__host__ __device__ constexpr size_t decode_smem(int warps, int mr) {
  return (size_t)warps * mr * (128 + 4 + 32) * sizeof(float) + (size_t)mr * 32 * sizeof(float);
}

// lo / hi: byte c holds the low / high byte of the bf16 weight of code c,
// bf16(v(c) * s); code 0 (biased value 0) is +0
template <bool LUT_BIAS>
__device__ __forceinline__ void weight_bytes(float s, unsigned& lo, unsigned& hi) {
  unsigned b[4];
#pragma unroll
  for (int c = 1; c < 4; ++c)
    b[c] = __bfloat16_as_ushort(
        __float2bfloat16_rn(__fmul_rn((float)(LUT_BIAS ? c + (c >> 1) : c), s)));
  const unsigned p12 = b[1] | (b[2] << 16);
  lo = __byte_perm(p12, b[3], 0x4206);    // {0, b1.lo, b2.lo, b3.lo}
  hi = __byte_perm(p12, b[3], 0x5316);    // {0, b1.hi, b2.hi, b3.hi}
}

// the lane's 4 * MR values of x for half tile ht: K row (ht/2)*256 + p*64 +
// 32*(ht%2) + lane of row m in xv[m * 4 + p]
template <int MR, typename T>
__device__ __forceinline__ void load_x_half(const T* __restrict__ x, int M, int K, int ht,
                                            int h1, int lane, float (&xv)[4 * MR]) {
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int k = (ht >> 1) * KT + p * 64 + 32 * (ht & 1) + lane;
      xv[m * 4 + p] = ht < h1 && m < M && k < K ? load_f32(x, (size_t)m * K + k) : 0.f;
    }
}

template <int MR, bool LUT_BIAS, typename T>
__global__ void __launch_bounds__(DEC_MAX_WARPS * 32)
blockscale_decode(const T* __restrict__ x, int M, int K, int Kp,
                  const int* __restrict__ words, int Np,
                  const float* __restrict__ scales, T* __restrict__ out, int N) {
  extern __shared__ __align__(16) float dsm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int W = blockDim.x >> 5, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* xw = dsm + warp * MR * 128;                // this warp's rows [MR][128]
  float* sw = dsm + W * MR * 128 + warp * MR * 4;   // their 32-row sums [MR][4]
  float* red = dsm + W * MR * 132;                  // the warps' partials [W][MR][32]
  float* part = red + W * MR * 32;                  // the block's [MR][32]
  const int S = gridDim.x, units = Kp / 128;
  const int h0 = (int)((long long)blockIdx.x * units / S);
  const int h1 = (int)((long long)(blockIdx.x + 1) * units / S);
  const int n = blockIdx.y * 32 + lane;
  constexpr bool X_AHEAD = MR <= 8;                 // 16 rows ahead would spill
  float y[MR], corr[MR];
#pragma unroll
  for (int m = 0; m < MR; ++m) y[m] = corr[m] = 0.f;
  int wv[8];
  float sv[4], xv[4 * MR];
  tl_load_half(h0 + warp, h1, words, scales, Np, n, wv, sv);    // in flight
  if constexpr (X_AHEAD) load_x_half<MR>(x, M, K, h0 + warp, h1, lane, xv);

  for (int ht = h0 + warp; ht < h1; ht += W) {
    int wn[8];
    float sn[4], xn[4 * MR];
    tl_load_half(ht + W, h1, words, scales, Np, n, wn, sn);
    if constexpr (X_AHEAD) load_x_half<MR>(x, M, K, ht + W, h1, lane, xn);
    else load_x_half<MR>(x, M, K, ht, h1, lane, xv);
#pragma unroll
    for (int i = 0; i < 4 * MR; ++i)
      xw[i * 32 + lane] = __bfloat162float(__float2bfloat16_rn(xv[i]));
    __syncwarp();
    for (int l = lane; l < 4 * MR; l += 32) {   // 32-row sums, a fixed order
      const float* b = xw + l * 32;               // (rotated: no bank conflicts)
      float a = 0.f;
#pragma unroll 8
      for (int j = 0; j < 32; ++j) a = __fadd_rn(a, b[(j + l) & 31]);
      sw[l] = a;
    }
    __syncwarp();
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      unsigned lo, hi;
      weight_bytes<LUT_BIAS>(sv[p], lo, hi);
#pragma unroll
      for (int m = 0; m < MR; ++m) corr[m] = fmaf(sw[m * 4 + p], sv[p], corr[m]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        // byte j of u: the selector nibbles (c, c + 4) of code c of K row
        // 4i + j of the block
        const unsigned u =
            ((((unsigned)wv[i] >> (2 * p)) & 0x03030303u) * 0x11u) + 0x40404040u;
        float wf[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wf[j] = __uint_as_float(__byte_perm(lo, hi, __byte_perm(u, 0u, 0x4404u | (j << 4))));
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          const float4 x4 = *reinterpret_cast<const float4*>(xw + m * 128 + p * 32 + 4 * i);
          y[m] = fmaf(x4.x, wf[0], y[m]);
          y[m] = fmaf(x4.y, wf[1], y[m]);
          y[m] = fmaf(x4.z, wf[2], y[m]);
          y[m] = fmaf(x4.w, wf[3], y[m]);
        }
      }
    }
    __syncwarp();                                   // xw is restaged next
#pragma unroll
    for (int i = 0; i < 8; ++i) wv[i] = wn[i];
#pragma unroll
    for (int p = 0; p < 4; ++p) sv[p] = sn[p];
    if constexpr (X_AHEAD) {
#pragma unroll
      for (int i = 0; i < 4 * MR; ++i) xv[i] = xn[i];
    }
  }
#pragma unroll
  for (int m = 0; m < MR; ++m)
    red[(warp * MR + m) * 32 + lane] = __fsub_rn(y[m], 2.f * corr[m]);
  __syncthreads();
  for (int i = threadIdx.x; i < MR * 32; i += blockDim.x) {
    float a = 0.f;
    for (int w = 0; w < W; ++w) a = __fadd_rn(a, red[(w * MR + i / 32) * 32 + (i & 31)]);
    part[i] = a;
  }
  cluster.sync();                                   // every block's partial is in place
  // output i = m * 32 + column is added by rank i % S, in rank order
  const int rank = (int)cluster.block_rank();
  for (int i = threadIdx.x * S + rank; i < M * 32; i += blockDim.x * S) {
    float v[DEC_MAX_SPLIT];
#pragma unroll
    for (int r = 0; r < DEC_MAX_SPLIT; ++r)
      v[r] = r < S ? cluster.map_shared_rank(part, r)[i] : 0.f;
    float a = v[0];
#pragma unroll
    for (int r = 1; r < DEC_MAX_SPLIT; ++r)
      if (r < S) a = __fadd_rn(a, v[r]);
    const int nc = blockIdx.y * 32 + (i & 31);
    if (nc < N) store_f32(out, (size_t)(i / 32) * N + nc, a);
  }
  cluster.sync();                                   // no block leaves while read
}

// split (cluster size) and warps a block for Kp x Np: split K only while
// the column blocks leave fewer than two blocks an SM; rounds of at most
// DEC_MAX_WARPS half tiles, balanced
void decode_plan(int Kp, int Np, int sms, int* split, int* warps) {
  const int units = Kp / 128, cb = Np / 32;
  int s = 1;
  while (s < DEC_MAX_SPLIT && cb * s < 2 * sms && units >= 2 * s) s *= 2;
  const int per = (units + s - 1) / s;
  const int rounds = (per + DEC_MAX_WARPS - 1) / DEC_MAX_WARPS;
  *split = s;
  *warps = (per + rounds - 1) / rounds;
}

template <int MR, bool LUT_BIAS, typename T>
cudaError_t launch_decode(const void* x, int M, int K, int Kp, const int* words,
                          int Np, const float* scales, void* out, int N, int split,
                          int warps, cudaStream_t stream) {
  auto kern = blockscale_decode<MR, LUT_BIAS, T>;
  static bool smem_set = false;           // once, before any graph capture
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)decode_smem(DEC_MAX_WARPS, MR));
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, Np / 32, 1);
  cfg.blockDim = dim3(32 * warps, 1, 1);
  cfg.dynamicSmemBytes = decode_smem(warps, MR);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(x), M, K, Kp,
                                     words, Np, scales, static_cast<T*>(out), N);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <bool LUT_BIAS, typename T>
cudaError_t launch_decode_rows(const void* x, int M, int K, int Kp, const int* words,
                               int Np, const float* scales, void* out, int N,
                               cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  int split, warps;
  decode_plan(Kp, Np, sms, &split, &warps);
#define BN_DEC(MRV) \
  return launch_decode<MRV, LUT_BIAS, T>(x, M, K, Kp, words, Np, scales, out, N, split, warps, stream)
  if (M <= 1) BN_DEC(1);
  if (M <= 2) BN_DEC(2);
  if (M <= 4) BN_DEC(4);
  if (M <= 8) BN_DEC(8);
  BN_DEC(16);
#undef BN_DEC
}

template <typename T>
cudaError_t launch_tl_bf16(const void* x, int x_stride, int M, int K, int glu,
                           const float* gamma, float eps, const int* words, int Np,
                           const float* scales, const void* resid, void* out,
                           int N, __nv_bfloat16* xb, int lut_bias,
                           cudaStream_t stream) {
  const size_t smem = (size_t)K * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bf16_rows<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  bf16_rows<T><<<M, 512, smem, stream>>>(static_cast<const T*>(x), x_stride, K,
                                         glu, gamma, eps, xb);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_gemm_lut<true, T>(lut_bias, xb, M, K, words, Np, scales, nullptr,
                                  resid, out, N, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, resid and out share it).  Each entry
// returns cudaGetLastError() after its launches.

// K10's GEMM (more rows than the decode form takes): xb bf16 [M, Kp]
// (rounded, zero-padded); scales f32 [Kp/32, Np] of the layer; corr f32
// [M, Np] = 2 * (sum32 @ scales); out [M, N].
int bn_blockscale_bf16(const __nv_bfloat16* xb, int M, int Kp, const int* words,
                       int Np, const float* scales, const float* corr, void* out,
                       int N, int lut_bias, int dtype, cudaStream_t stream) {
  if (dtype == 1)
    return (int)launch_gemm_lut<false, __nv_bfloat16>(
        lut_bias, xb, M, Kp, words, Np, scales, corr, nullptr, out, N, stream);
  return (int)launch_gemm_lut<false, float>(lut_bias, xb, M, Kp, words, Np, scales,
                                            corr, nullptr, out, N, stream);
}

// K10's decode form: x [M, K] in its own dtype (rounded to bf16 here, rows
// past K read as 0), M <= 16; the correction inside; out [M, N].  One launch.
int bn_blockscale_decode(const void* x, int M, int K, int Kp, const int* words,
                         int Np, const float* scales, void* out, int N, int lut_bias,
                         int dtype, cudaStream_t stream) {
  if (M < 1 || M > DEC_MAX_M || Kp % KT || K < 1 || K > Kp || Np % 32 || N > Np)
    return (int)cudaErrorInvalidValue;
#define BN_D(LB, TT)   return (int)launch_decode_rows<LB, TT>(x, M, K, Kp, words, Np, scales, out, N, stream)
  if (dtype == 1) {
    if (lut_bias) BN_D(true, __nv_bfloat16);
    BN_D(false, __nv_bfloat16);
  }
  if (lut_bias) BN_D(true, float);
  BN_D(false, float);
#undef BN_D
}

// K11: M <= 2, K == Kp (a multiple of 256); xq / sx / sumq receive the int8
// rows, their scales and sums (as K1's); sumqb [M, K/32] is the two-kernel
// path's scratch for the 32-row block sums (K > FUSED_MAX_K).
int bn_tl_w2a8_normed(const void* x, int x_stride, int M, int K, int glu,
                      const float* gamma, float eps, const int* words, int Np,
                      const float* scales, const void* resid, void* out, int N,
                      int8_t* xq, float* sx, int* sumq, int* sumqb, int lut_bias,
                      int dtype, cudaStream_t stream) {
  if (M < 1 || M > FUSED_MAX_M || K % KT) return (int)cudaErrorInvalidValue;
#define BN_TL(LB, TT)                                                            \
  return (int)launch_tl_w2a8<LB, TT>(x, x_stride, M, K, glu, gamma, eps, words,  \
                                     Np, scales, resid, out, N, xq, sx, sumq,    \
                                     sumqb, stream)
  if (dtype == 1) {
    if (lut_bias) BN_TL(true, __nv_bfloat16);
    BN_TL(false, __nv_bfloat16);
  }
  if (lut_bias) BN_TL(true, float);
  BN_TL(false, float);
#undef BN_TL
}

// K12: M <= 64, K == Kp; xb bf16 [M, K] scratch for the preamble's rows.
int bn_tl_bf16_normed(const void* x, int x_stride, int M, int K, int glu,
                      const float* gamma, float eps, const int* words, int Np,
                      const float* scales, const void* resid, void* out, int N,
                      __nv_bfloat16* xb, int lut_bias, int dtype,
                      cudaStream_t stream) {
  if (dtype == 1)
    return (int)launch_tl_bf16<__nv_bfloat16>(x, x_stride, M, K, glu, gamma, eps,
                                              words, Np, scales, resid, out, N,
                                              xb, lut_bias, stream);
  return (int)launch_tl_bf16<float>(x, x_stride, M, K, glu, gamma, eps, words, Np,
                                    scales, resid, out, N, xb, lut_bias, stream);
}

const char* bn_ternary_matmul_tl_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
