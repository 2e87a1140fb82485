// W2A8 ternary matmuls for Hopper (sm_90a): int8 activations x 2-bit codes.
//
// Replaces two Pallas kernels of bitnet_tpu/ops/ternary_matmul.py:
//   K1 bn_w2a8_normed  <- ternary_matmul_stacked (:316, pallas_call :375),
//                         body _qk256_w2a8_normed_kernel (:201): decode, M <= 64
//   K4 bn_w2a8_gemm    <- ternary_matmul_stacked_prefill (:417, pallas_call
//                         :464), body _qk256_w2a8_kernel (:173): prefill GEMM
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
//  - K4 (M = B*T >= 128) is bound by int8 operations: a 64x64 block tile of
//    mma.sync.m16n8k32 s8*s8->s32 (tensor cores), the 2-bit planes expanded
//    to B fragments in registers straight from shared-memory words, the
//    next K tile streaming in by cp.async while this one computes (two
//    stages).  No TMA, no wgmma yet: that is later work.
// The integer accumulation is exact (|acc| <= 4*127*Kp < 2^31), so the
// results do not depend on the tiling; the float epilogue uses _rn
// intrinsics so it is never contracted into an FMA and rounds exactly as
// the plain PyTorch version does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KT = 256;

__device__ __forceinline__ float load_f32(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int biased_plane(int w, int p) {
  int t = (w >> (2 * p)) & 0x03030303;
  return t + ((t >> 1) & 0x01010101);
}

template <typename V>
__device__ __forceinline__ V block_reduce(V v, V* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    V u = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? (u > v ? u : v) : v + u;
  }
  __syncthreads();                       // red may still be read by a prior call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int nw = blockDim.x >> 5;
  v = lane < nw ? red[lane] : (is_max ? red[0] : V(0));
  for (int o = 16; o > 0; o >>= 1) {
    V u = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? (u > v ? u : v) : v + u;
  }
  return v;
}

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
constexpr int FUSED_MAX_M = 2;
constexpr int FUSED_MAX_K = 8192;
constexpr int FUSED_THREADS = 512;                   // 16 warps
constexpr int FUSED_WARPS = FUSED_THREADS / 32;
constexpr int FUSED_PF = 16;                         // word rows in flight a thread
constexpr int FUSED_STAGE = FUSED_WARPS * FUSED_PF;  // word rows a stage
constexpr int FUSED_EPT = FUSED_MAX_K / FUSED_THREADS;

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

  for (int mm = 0; mm < M; ++mm) {                  // the preamble, per row
    const T* xr = x + (size_t)mm * x_stride;
    float v[FUSED_EPT];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < FUSED_EPT; ++i) {
      const int k = threadIdx.x + FUSED_THREADS * i;
      float t = 0.f;
      if (k < Kp) {
        t = load_f32(xr, k);
        if (glu) {
          const float sig = 1.f / (1.f + expf(-t));
          t = __fmul_rn(__fmul_rn(t, sig), load_f32(xr, (size_t)Kp + k));
        }
      }
      v[i] = t;
      ss += t * t;
    }
    if (gamma != nullptr) {
      const float var = block_reduce(ss, redf, false) / (float)Kp;
      const float r = 1.f / sqrtf(var + eps);
#pragma unroll
      for (int i = 0; i < FUSED_EPT; ++i) {
        const int k = threadIdx.x + FUSED_THREADS * i;
        if (k < Kp) v[i] = __fmul_rn(__fmul_rn(v[i], r), gamma[k]);
      }
    }
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < FUSED_EPT; ++i) amax = fmaxf(amax, fabsf(v[i]));
    amax = block_reduce(amax, redf, true);
    const float sx = fmaxf(amax, 1e-8f) / 127.f;
    int8_t* xrow = reinterpret_cast<int8_t*>(&xs[mm][0]);
    int sq = 0;
#pragma unroll
    for (int i = 0; i < FUSED_EPT; ++i) {
      const int k = threadIdx.x + FUSED_THREADS * i;
      if (k < Kp) {
        const float q = fminf(fmaxf(rintf(v[i] / sx), -127.f), 127.f);
        xrow[k] = (int8_t)q;
        sq += (int)q;
        if (blockIdx.x == 0) xq_out[(size_t)mm * Kp + k] = (int8_t)q;
      }
    }
    sq = block_reduce(sq, redi, false);
    if (threadIdx.x == 0) {
      sx_s[mm] = sx;
      sumq_s[mm] = sq;
      if (blockIdx.x == 0) {
        sx_out[mm] = sx;
        sumq_out[mm] = sq;
      }
    }
  }
  __syncthreads();

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
// K4 GEMM: 128 threads = 4 warps (2x2), block tile 64x64, warp tile 32x32
// (2 m16 x 4 n8 mma tiles), one 256-row K tile per stage.
// ---------------------------------------------------------------------------
constexpr int GB_M = 64, GB_N = 64;
constexpr int XS_LD = KT + 16;        // bytes; conflict-free A fragment reads
constexpr int WS_LD = GB_N + 8;       // ints;  conflict-free B fragment reads

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4], int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(pred ? 16 : 0));
}

template <typename T>
__global__ void __launch_bounds__(128)
w2a8_gemm(const int8_t* __restrict__ xq, int M, int Kp,
          const int* __restrict__ words, int Np,
          const int* __restrict__ sumq, const float* __restrict__ sx,
          const float* __restrict__ scale, T* __restrict__ out, int N) {
  // two stages: the next K tile streams in (cp.async) while this one computes
  __shared__ __align__(16) int8_t xs[2][GB_M][XS_LD];
  __shared__ __align__(16) int ws[2][KT / 16][WS_LD];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * GB_M, n0 = blockIdx.x * GB_N;
  const int nk = Kp / KT;
  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  auto load_tile = [&](int st, int k0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {             // 64 rows x 256 B of activations
      const int idx = tid + 128 * i, r = idx >> 4, c16 = idx & 15;
      const bool ok = m0 + r < M;             // rows past M are zero-filled
      cp_async16(&xs[st][r][c16 * 16],
                 xq + (size_t)(ok ? m0 + r : 0) * Kp + k0 + c16 * 16, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {             // 16 word rows x 64 columns
      const int idx = tid + 128 * i, r = idx >> 4, c4 = (idx & 15) * 4;
      cp_async16(&ws[st][r][c4], words + (size_t)(k0 / 16 + r) * Np + n0 + c4, true);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  load_tile(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nk) {
      load_tile(st ^ 1, (kt + 1) * KT);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < 4; ++p) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {            // 32 K = words 8h..8h+7 of plane p
        const int kb = p * 64 + 32 * h;
        int a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int r = wm * 32 + mi * 16 + g;
          a[mi][0] = *reinterpret_cast<const int*>(&xs[st][r][kb + t4 * 4]);
          a[mi][1] = *reinterpret_cast<const int*>(&xs[st][r + 8][kb + t4 * 4]);
          a[mi][2] = *reinterpret_cast<const int*>(&xs[st][r][kb + 16 + t4 * 4]);
          a[mi][3] = *reinterpret_cast<const int*>(&xs[st][r + 8][kb + 16 + t4 * 4]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int col = wn * 32 + ni * 8 + g;
          const int b0 = biased_plane(ws[st][8 * h + t4][col], p);
          const int b1 = biased_plane(ws[st][8 * h + 4 + t4][col], p);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_s8(acc[mi][ni], a[mi], b0, b1);
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
          float y = (float)(acc[mi][ni][e] - 2 * sumq[m]);
          y = __fmul_rn(__fmul_rn(y, sx[m]), scale[n]);
          store_f32(out, (size_t)m * N + n, y);
        }
      }
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
  const size_t smem = (size_t)K * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        w2a8_quantize_rows<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  w2a8_quantize_rows<T><<<M, 512, smem, stream>>>(
      static_cast<const T*>(x), x_stride, K, glu, gamma, eps, xq, sx, sumq);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  w2a8_gemv<8, T><<<dim3(Np / 32, (M + 7) / 8), 256, 0, stream>>>(
      xq, M, K, words, Np, sumq, sx, scale, r, o, N);
  return cudaGetLastError();
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

int bn_w2a8_gemm(const int8_t* xq, int M, int Kp, const int* words, int Np,
                 const int* sumq, const float* sx, const float* scale,
                 void* out, int N, int dtype, cudaStream_t stream) {
  dim3 grid(Np / GB_N, (M + GB_M - 1) / GB_M);
  if (dtype == 1)
    w2a8_gemm<__nv_bfloat16><<<grid, 128, 0, stream>>>(
        xq, M, Kp, words, Np, sumq, sx, scale,
        static_cast<__nv_bfloat16*>(out), N);
  else
    w2a8_gemm<float><<<grid, 128, 0, stream>>>(
        xq, M, Kp, words, Np, sumq, sx, scale, static_cast<float*>(out), N);
  return (int)cudaGetLastError();
}

const char* bn_ternary_matmul_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
