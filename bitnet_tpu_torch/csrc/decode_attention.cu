// Rope-fused decode attention and the KV row scatter for Hopper (sm_90a).
//
// Replaces two Pallas kernels of bitnet_tpu/ops/decode_attention_v2.py:
//   K2 bn_decode_attention_qkv <- decode_attention_qkv_v2_stacked (:859,
//      pallas_call :922), body _v2_qkv_kernel (:318) with quant=False
//   K3 bn_scatter_kv_rows      <- scatter_kv_rows (:1068, pallas_call :1113),
//      body _scatter_rows_kernel (:1048)
//
// K2 takes the raw fused projection row qkv [B, H+2KV, D], applies split-
// layout RoPE to q and k, and runs flash-decode over the PRE-write flat
// cache layer [B, S, KV*D] (bf16) for rows < pos[b], with the new token
// folded into the softmax as the JAX kernel does: m = (q_f32 . k_f32)/sqrt(D),
// d = 1, ctx = v_f32 (f32 roped rows, not the bf16 rows written to the
// cache); q is rounded to bf16 before the cache dot and the softmax weights
// e to bf16 before the PV dot.  It returns attn [B, H, D] and the roped k
// row and the v row [B, KV, D] in bf16.
//
// What bounds it on the card: the cache bytes (2 * pos * KV * D * 2 per
// layer).  The TPU ran the chunks of S one after another on one core; here
// each (split of 64 cache rows, kv head, b) gets its own block, so a 4k
// cache spreads over 64 * KV * B blocks.  Each of 4 warps streams 16 rows,
// the loads of 4 rows issued together (8 bytes a lane per row), and keeps all
// G = H/KV query heads of its kv head in registers (GQA: each cache row is
// read once for G heads).  A second, small kernel folds the new token and
// the per-split partials (m, d, ctx) against their common max — the second
// pass a split-S design needs; one block per query head, its 8 warps
// taking the splits in turn, so no thread waits on a chain of loads.  Splits at or past pos exit at once; the
// grid is sized by S so no host sync reads pos.
//
// K3 writes the L new rows per batch slot in place at min(pos[b], S-1): a
// pos >= S overwrites row S-1 of that slot (the JAX package's clamped
// write).  It moves 2*L*B rows; it is bound by launch latency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int SPLIT = 64;        // cache rows per split block
constexpr int WARPS = 4;         // pass 1
constexpr int ROWS_PER_WARP = SPLIT / WARPS;
constexpr int COMBINE_WARPS = 8; // pass 2
constexpr int UNROLL = 4;        // cache rows whose loads a warp issues at once
constexpr int MAXG = 8;

__device__ __forceinline__ float load_f32(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// split-layout RoPE of element d of a head row (f32 math, as the JAX kernel:
// x*cos + rot*sin with rot = [-x[half:], x[:half]])
template <typename T>
__device__ __forceinline__ float rope_at(const T* row, int d, int half,
                                         const float* sn, const float* cs) {
  if (d < half)
    return __fadd_rn(__fmul_rn(load_f32(row, d), cs[d]),
                     __fmul_rn(-load_f32(row, d + half), sn[d]));
  return __fadd_rn(__fmul_rn(load_f32(row, d), cs[d - half]),
                   __fmul_rn(load_f32(row, d - half), sn[d - half]));
}

// ---------------------------------------------------------------------------
// pass 1: grid (NS, KV, B), 128 threads; lane owns EPL = D/32 elements.
// Each warp walks ROWS_PER_WARP consecutive cache rows, UNROLL at a time
// with all their loads issued first; the softmax state is rescaled once per
// UNROLL rows (the JAX kernel rescales once per chunk of S the same way).
// partial m/d: [B, KV, NS, G, 2]; partial ctx: [B, KV, NS, G, D]
// ---------------------------------------------------------------------------
template <int D, typename T>
__global__ void __launch_bounds__(WARPS * 32)
attn_split(const T* __restrict__ qkv, const float* __restrict__ sin_rows,
           const float* __restrict__ cos_rows,
           const __nv_bfloat16* __restrict__ kc,
           const __nv_bfloat16* __restrict__ vc, const int* __restrict__ pos,
           int H, int KV, int S, float scale, float* __restrict__ part_md,
           float* __restrict__ part_ctx) {
  constexpr int EPL = D / 32;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int NS = gridDim.x, G = H / KV, KVD = KV * D, half = D / 2;
  const int p = min(pos[b], S);
  const int start = split * SPLIT;
  if (start >= p) return;                  // the combine pass skips it too
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w0 = start + warp * ROWS_PER_WARP;
  const int w1 = min(w0 + ROWS_PER_WARP, p);
  const float* sn = sin_rows + (size_t)b * half;
  const float* cs = cos_rows + (size_t)b * half;
  const T* row_b = qkv + (size_t)b * (H + 2 * KV) * D;

  // roped q of the G heads, rounded to the cache dtype: once per block
  __shared__ float q_s[MAXG][D];
  for (int i = threadIdx.x; i < G * D; i += blockDim.x)
    q_s[i / D][i % D] = bf16_round(rope_at(row_b + (size_t)(h * G + i / D) * D,
                                           i % D, half, sn, cs));
  __syncthreads();
  float q[MAXG][EPL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) q[g][e] = g < G ? q_s[g][lane * EPL + e] : 0.f;
  float m[MAXG], dsum[MAXG], ctx[MAXG][EPL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = NEG_INF;
    dsum[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) ctx[g][e] = 0.f;
  }
  const size_t base = (size_t)b * S * KVD + (size_t)h * D + lane * EPL;
  for (int j0 = w0; j0 < w1; j0 += UNROLL) {
    float kf[UNROLL][EPL], vf[UNROLL][EPL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {     // all the group's loads first
      const int j = min(j0 + u, w1 - 1);
      const __nv_bfloat16* kr = kc + base + (size_t)j * KVD;
      const __nv_bfloat16* vr = vc + base + (size_t)j * KVD;
#pragma unroll
      for (int e = 0; e < EPL; e += 2) {
        const __nv_bfloat162 k2 = *reinterpret_cast<const __nv_bfloat162*>(kr + e);
        const __nv_bfloat162 v2 = *reinterpret_cast<const __nv_bfloat162*>(vr + e);
        kf[u][e] = __low2float(k2);
        kf[u][e + 1] = __high2float(k2);
        vf[u][e] = __low2float(v2);
        vf[u][e + 1] = __high2float(v2);
      }
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        float s[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          float t = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) t += q[g][e] * kf[u][e];
          s[u] = t;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
          for (int u = 0; u < UNROLL; ++u)
            s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          s[u] = j0 + u < w1 ? s[u] * scale : NEG_INF;
          mx = fmaxf(mx, s[u]);
        }
        const float alpha = expf(m[g] - mx);
        float dd = dsum[g] * alpha;
#pragma unroll
        for (int e = 0; e < EPL; ++e) ctx[g][e] *= alpha;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const float ev = expf(s[u] - mx);
          dd += ev;
          const float eb = bf16_round(ev);
#pragma unroll
          for (int e = 0; e < EPL; ++e) ctx[g][e] += eb * vf[u][e];
        }
        dsum[g] = dd;
        m[g] = mx;
      }
    }
  }
  // merge the warps' partials in shared memory
  __shared__ float sm_m[WARPS][MAXG], sm_d[WARPS][MAXG];
  __shared__ float sm_c[WARPS][MAXG][D];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
    if (g < G) {
      if (lane == 0) {
        sm_m[warp][g] = m[g];
        sm_d[warp][g] = dsum[g];
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e) sm_c[warp][g][lane * EPL + e] = ctx[g][e];
    }
  __syncthreads();
  const size_t pbase = (((size_t)b * KV + h) * NS + split) * G;
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    float mx = NEG_INF;
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float dd = 0.f, cc = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(sm_m[w][g] - mx);
      dd += sm_d[w][g] * f;
      cc += sm_c[w][g][d] * f;
    }
    part_ctx[(pbase + g) * D + d] = cc;
    if (d == 0) {
      part_md[(pbase + g) * 2] = mx;
      part_md[(pbase + g) * 2 + 1] = dd;
    }
  }
}

// ---------------------------------------------------------------------------
// pass 2: grid (H, B), 8 warps.  Folds the new token (the softmax init) and
// the live splits of query head (kv head h/G, g = h%G) against their common
// max: warp w takes splits w, w+8, ..., lane owns EPL elements of D, so a
// thread issues live/8 independent loads; the warps' sums meet in shared
// memory.  The block of g == 0 also writes the roped k row and the v row.
// ---------------------------------------------------------------------------
template <int D, typename T>
__global__ void __launch_bounds__(COMBINE_WARPS * 32)
attn_combine(const T* __restrict__ qkv, const float* __restrict__ sin_rows,
             const float* __restrict__ cos_rows, const int* __restrict__ pos,
             int H, int KV, int S, int NS, float scale,
             const float* __restrict__ part_md,
             const float* __restrict__ part_ctx, T* __restrict__ out,
             __nv_bfloat16* __restrict__ k_out,
             __nv_bfloat16* __restrict__ v_out) {
  constexpr int EPL = D / 32;
  const int G = H / KV, half = D / 2;
  const int hq = blockIdx.x, b = blockIdx.y, h = hq / G, g = hq % G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* sn = sin_rows + (size_t)b * half;
  const float* cs = cos_rows + (size_t)b * half;
  const T* row_b = qkv + (size_t)b * (H + 2 * KV) * D;
  __shared__ float kr_s[D], vr_s[D], m0_s;
  __shared__ float c_s[COMBINE_WARPS][D], d_s[COMBINE_WARPS];
  const int live = (min(pos[b], S) + SPLIT - 1) / SPLIT;
  extern __shared__ float smd[];                 // this head's [live] (m, d)
  const float* md = part_md + ((size_t)b * KV + h) * NS * G * 2;
  for (int sp = threadIdx.x; sp < live; sp += blockDim.x) {
    smd[2 * sp] = md[(sp * G + g) * 2];
    smd[2 * sp + 1] = md[(sp * G + g) * 2 + 1];
  }
  if (threadIdx.x < D) {                         // new token: roped k, raw v
    const int d = threadIdx.x;
    const float kr = rope_at(row_b + (size_t)(H + h) * D, d, half, sn, cs);
    const float vr = load_f32(row_b + (size_t)(H + KV + h) * D, d);
    kr_s[d] = kr;
    vr_s[d] = vr;
    if (g == 0) {
      k_out[((size_t)b * KV + h) * D + d] = __float2bfloat16_rn(kr);
      v_out[((size_t)b * KV + h) * D + d] = __float2bfloat16_rn(vr);
    }
  }
  __syncthreads();
  if (warp == 0) {                               // m0 = (q_f32 . k_f32) * scale
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = lane * EPL + e;
      s += rope_at(row_b + (size_t)hq * D, d, half, sn, cs) * kr_s[d];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) m0_s = s * scale;
  }
  __syncthreads();
  const float m0 = m0_s;
  float mx = m0;
  for (int sp = 0; sp < live; ++sp) mx = fmaxf(mx, smd[2 * sp]);
  float c[EPL], den = 0.f;
#pragma unroll
  for (int e = 0; e < EPL; ++e) c[e] = 0.f;
  const float* ctx = part_ctx + (((size_t)b * KV + h) * NS * G + g) * D + lane * EPL;
  for (int sp = warp; sp < live; sp += COMBINE_WARPS) {
    const float w = expf(smd[2 * sp] - mx);
    den += smd[2 * sp + 1] * w;
#pragma unroll
    for (int e = 0; e < EPL; ++e) c[e] += ctx[(size_t)sp * G * D + e] * w;
  }
#pragma unroll
  for (int e = 0; e < EPL; ++e) c_s[warp][lane * EPL + e] = c[e];
  if (lane == 0) d_s[warp] = den;
  __syncthreads();
  if (threadIdx.x < D) {
    const int d = threadIdx.x;
    const float a0 = expf(m0 - mx);
    float dd = a0, cc = vr_s[d] * a0;
    for (int w = 0; w < COMBINE_WARPS; ++w) {
      dd += d_s[w];
      cc += c_s[w][d];
    }
    store_f32(out, ((size_t)b * H + hq) * D + d, cc / dd);
  }
}

// ---------------------------------------------------------------------------
// K3: grid (L, B); copies one row of KVD bf16 per cache, 16 bytes a thread.
// ---------------------------------------------------------------------------
__global__ void scatter_rows(__nv_bfloat16* __restrict__ kc,
                             __nv_bfloat16* __restrict__ vc,
                             const __nv_bfloat16* __restrict__ kr,
                             const __nv_bfloat16* __restrict__ vr,
                             const int* __restrict__ pos, int B, int S, int KVD) {
  const int l = blockIdx.x, b = blockIdx.y;
  const int p = min(pos[b], S - 1);
  const size_t dst = (((size_t)l * B + b) * S + p) * KVD;
  const size_t src = ((size_t)l * B + b) * KVD;
  const int n16 = KVD / 8;
  for (int i = threadIdx.x; i < n16; i += blockDim.x) {
    reinterpret_cast<int4*>(kc + dst)[i] = reinterpret_cast<const int4*>(kr + src)[i];
    reinterpret_cast<int4*>(vc + dst)[i] = reinterpret_cast<const int4*>(vr + src)[i];
  }
}

template <int D, typename T>
cudaError_t launch_attn(const void* qkv, const float* sin_rows,
                        const float* cos_rows, const void* kc, const void* vc,
                        const int* pos, int B, int H, int KV, int S,
                        float scale, void* out,
                        void* k_out, void* v_out, float* part_md,
                        float* part_ctx, cudaStream_t stream) {
  const int NS = (S + SPLIT - 1) / SPLIT;
  attn_split<D, T><<<dim3(NS, KV, B), WARPS * 32, 0, stream>>>(
      static_cast<const T*>(qkv), sin_rows, cos_rows,
      static_cast<const __nv_bfloat16*>(kc), static_cast<const __nv_bfloat16*>(vc),
      pos, H, KV, S, scale, part_md, part_ctx);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t smem = (size_t)NS * 2 * sizeof(float);
  if (smem > 40 * 1024) {
    e = cudaFuncSetAttribute(attn_combine<D, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  attn_combine<D, T><<<dim3(H, B), COMBINE_WARPS * 32, smem, stream>>>(
      static_cast<const T*>(qkv), sin_rows, cos_rows, pos, H, KV, S, NS, scale,
      part_md,
      part_ctx, static_cast<T*>(out), static_cast<__nv_bfloat16*>(k_out),
      static_cast<__nv_bfloat16*>(v_out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype (qkv and out): 0 = float32, 1 = bfloat16.  The caches are bf16.
// scale = D**-0.5 rounded to f32 by the caller (as the JAX kernel takes it).
// D must be 64 or 128 and H / KV <= 8.  part_md: B*KV*NS*G*2 floats,
// part_ctx: B*KV*NS*G*D floats, NS = ceil(S / 64).
int bn_decode_attention_qkv(const void* qkv, const float* sin_rows,
                            const float* cos_rows, const void* kc,
                            const void* vc, const int* pos, int B, int H,
                            int KV, int D, int S, float scale, void* out,
                            void* k_out,
                            void* v_out, float* part_md, float* part_ctx,
                            int dtype, cudaStream_t stream) {
  if (H % KV != 0 || H / KV > MAXG) return (int)cudaErrorInvalidValue;
#define BN_ATTN(DD, TT)                                                        \
  return (int)launch_attn<DD, TT>(qkv, sin_rows, cos_rows, kc, vc, pos, B, H, \
                                  KV, S, scale, out, k_out, v_out, part_md,    \
                                  part_ctx,                                    \
                                  stream)
  if (D == 128 && dtype == 1) BN_ATTN(128, __nv_bfloat16);
  if (D == 128 && dtype == 0) BN_ATTN(128, float);
  if (D == 64 && dtype == 1) BN_ATTN(64, __nv_bfloat16);
  if (D == 64 && dtype == 0) BN_ATTN(64, float);
#undef BN_ATTN
  return (int)cudaErrorInvalidValue;
}

int bn_scatter_kv_rows(void* kc, void* vc, const void* k_rows,
                       const void* v_rows, const int* pos, int L, int B, int S,
                       int KVD, cudaStream_t stream) {
  if (KVD % 8 != 0) return (int)cudaErrorInvalidValue;
  scatter_rows<<<dim3(L, B), 128, 0, stream>>>(
      static_cast<__nv_bfloat16*>(kc), static_cast<__nv_bfloat16*>(vc),
      static_cast<const __nv_bfloat16*>(k_rows),
      static_cast<const __nv_bfloat16*>(v_rows), pos, B, S, KVD);
  return (int)cudaGetLastError();
}

const char* bn_decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
