// Device helpers shared by the ternary matmul kernels (ternary_matmul.cu:
// K1, K4, K6; ternary_matmul_tl.cu: K10, K11, K12).
//
// Weights are int32 words [Kp/16, Np].  Within each 256-row K tile, word s,
// byte j, plane p hold the code of K row p*64 + 4s + j, so
// t = (w >> 2p) & 0x03030303 is 4 consecutive K values.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bn {

constexpr int KT = 256;

__device__ __forceinline__ float load_f32(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// 4 biased values of plane p of word w, one per byte: c + (c >> 1) in
// {0,1,3,4} (the LUT {-2,-1,1,2} plus 2) or, without the LUT bias (TL), c.
template <bool LUT_BIAS = true>
__device__ __forceinline__ int biased_plane(int w, int p) {
  const int t = (w >> (2 * p)) & 0x03030303;
  return LUT_BIAS ? t + ((t >> 1) & 0x01010101) : t;
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// The W2A8 row preamble of the one-launch decode kernels (K1 at M <= 2, K11),
// run by every block: silu(gate) * up, RMSNorm, absmax int8 quantization.
// 512 threads; x is [M, K] (or [M, 2K] when glu), K <= FUSED_MAX_K.
// Leaves the int8 rows in xs, their scales in sx_s and sums in sumq_s and,
// when sumqb is not null, the sums of each 32-row block in sumqb[m][b]
// (32 consecutive k are the 32 lanes of one warp).  Block 0 also writes
// the rows, scales and sums out, so a check can hold them against the
// plain version.
// ---------------------------------------------------------------------------
constexpr int FUSED_MAX_M = 2;
constexpr int FUSED_MAX_K = 8192;
constexpr int FUSED_THREADS = 512;                   // 16 warps
constexpr int FUSED_WARPS = FUSED_THREADS / 32;
constexpr int FUSED_EPT = FUSED_MAX_K / FUSED_THREADS;

template <typename T>
__device__ __forceinline__ void fused_quantize_rows(
    const T* __restrict__ x, int x_stride, int M, int Kp, int glu,
    const float* __restrict__ gamma, float eps, int (*xs)[FUSED_MAX_K / 4],
    float* sx_s, int* sumq_s, int (*sumqb)[FUSED_MAX_K / 32], float* redf,
    int* redi, int8_t* __restrict__ xq_out, float* __restrict__ sx_out,
    int* __restrict__ sumq_out) {
  for (int mm = 0; mm < M; ++mm) {
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
      int qi = 0;
      if (k < Kp) {
        qi = (int)fminf(fmaxf(rintf(v[i] / sx), -127.f), 127.f);
        xrow[k] = (int8_t)qi;
        sq += qi;
        if (blockIdx.x == 0) xq_out[(size_t)mm * Kp + k] = (int8_t)qi;
      }
      if (sumqb != nullptr) {              // k < Kp is uniform over the warp
        int bs = qi;
        for (int o = 16; o > 0; o >>= 1) bs += __shfl_xor_sync(0xffffffffu, bs, o);
        if ((threadIdx.x & 31) == 0 && k < Kp) sumqb[mm][k >> 5] = bs;
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
}

}  // namespace bn
