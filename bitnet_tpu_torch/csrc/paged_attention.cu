// K33: paged decode attention for Hopper (sm_90a).
//
// Replaces JAX's stock Pallas kernel
// jax.experimental.pallas.ops.tpu.paged_attention (its pallas_call sits in
// the JAX library; the repo calls it at experiments/exp_r4_attn.py:63-88)
// and serves the paged scheduler's decode step (models/bitnet.py, plan
// "paged").  The function is the stock kernel's:
//   q [B, H, D]; k / v pages [KV, P, page, D] (any strides but D's);
//   lengths [B]; page_indices [B, pages_per_seq];
//   out[b, h] = softmax_p(q[b, h] . k[h / G, p]) . v[h / G, p] over the
//   positions p < min(lengths[b], pages_per_seq * page), position p read
//   from page page_indices[b, p / page] at row p % page, a negative
//   (unassigned) entry reading page 0 as the JAX paged gather does
//   (bitnet_tpu/engine/paged_cache.py:225): a scheduler's K-step window
//   runs a slot past the pages it was grown for when it will stop sooner.
//   No scale (the caller scales q); masked positions weigh nothing (the
//   stock kernel adds mask_value, which underflows to 0 once a position is
//   valid); a length of 0 gives 0.
//
// Design (a simple split-S kernel; PR 15's attn_decode is the fast pattern):
//   paged_attn_split: grid (splits, KV, B), 4 warps.  Split s owns positions
//     [s*R, (s+1)*R) clipped to the slot's length.  A warp takes 4 positions
//     an iteration (its loads first, then the dots), each lane EPL = D/32
//     values of a row; the G heads of the kv head are dotted with the row in
//     f32 and reduced across the warp; an online softmax per (warp, head).
//     The four warps meet in shared memory; with one split the block writes
//     the output, else its (m, l, acc) partial in f32.
//   paged_attn_combine: grid (B*H), D threads: folds the splits' partials.
// Pages are bf16 or f32; q and out bf16 or f32.  Every sum is in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int ROWS = 4;      // positions a warp loads before it computes
constexpr int G_MAX = 8;     // query heads a kv head

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// EPL consecutive values at p, widened to f32 (aligned: D % 32 == 0 and the
// strides of every row a multiple of D)
template <typename T, int EPL>
__device__ __forceinline__ void load_row(const T* p, float (&out)[EPL]) {
#pragma unroll
  for (int e = 0; e < EPL; ++e) out[e] = to_f32(p[e]);
}

template <typename TQ, typename TK, int EPL>
__global__ void __launch_bounds__(WARPS * 32)
paged_attn_split(const TQ* __restrict__ q, const TK* __restrict__ kp,
                 const TK* __restrict__ vp, const int* __restrict__ lengths,
                 const int* __restrict__ table, int table_stride, int npg, int H,
                 int KV, long long s_kv, long long s_page, long long s_row, int page,
                 int R, TQ* __restrict__ out, float* __restrict__ part_m,
                 float* __restrict__ part_l, float* __restrict__ part_acc) {
  constexpr int D = EPL * 32;
  const int split = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int G = H / KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = min(lengths[b], npg * page);
  const int start = split * R;
  const int end = min(start + R, len);

  float qr[G_MAX][EPL];
#pragma unroll
  for (int g = 0; g < G_MAX; ++g) {
    if (g < G) {
      const TQ* qp = q + ((long long)b * H + kv * G + g) * D + lane * EPL;
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[g][e] = to_f32(qp[e]);
    }
  }
  float m[G_MAX], l[G_MAX], acc[G_MAX][EPL];
#pragma unroll
  for (int g = 0; g < G_MAX; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }
  const TK* kbase = kp + kv * s_kv + lane * EPL;
  const TK* vbase = vp + kv * s_kv + lane * EPL;
  const int* trow = table + (long long)b * table_stride;

  for (int r0 = start + warp * ROWS; r0 < end; r0 += WARPS * ROWS) {
    float kr[ROWS][EPL], vr[ROWS][EPL];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int p = r0 + j;
      if (p < end) {
        const long long off =
            max(trow[p / page], 0) * s_page + (long long)(p % page) * s_row;
        load_row<TK, EPL>(kbase + off, kr[j]);
        load_row<TK, EPL>(vbase + off, vr[j]);
      }
    }
#pragma unroll
    for (int g = 0; g < G_MAX; ++g) {
      if (g >= G) continue;
      float s[ROWS];
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d = fmaf(qr[g][e], kr[j][e], d);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
        s[j] = (r0 + j < end) ? d : -INFINITY;
      }
      float mc = s[0];
#pragma unroll
      for (int j = 1; j < ROWS; ++j) mc = fmaxf(mc, s[j]);
      const float mn = fmaxf(m[g], mc);      // finite: row r0 is valid
      const float alpha = expf(m[g] - mn);
      float lsum = 0.f, w[ROWS];
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        w[j] = (r0 + j < end) ? expf(s[j] - mn) : 0.f;
        lsum += w[j];
      }
      l[g] = l[g] * alpha + lsum;
      m[g] = mn;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float a = acc[g][e] * alpha;
#pragma unroll
        for (int j = 0; j < ROWS; ++j) a = fmaf(w[j], (r0 + j < end) ? vr[j][e] : 0.f, a);
        acc[g][e] = a;
      }
    }
  }

  // the four warps' states meet in shared memory
  __shared__ float sm_m[WARPS][G_MAX], sm_l[WARPS][G_MAX];
  __shared__ float sm_acc[WARPS][G_MAX][D];
#pragma unroll
  for (int g = 0; g < G_MAX; ++g) {
    if (g >= G) continue;
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][g][lane * EPL + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += WARPS * 32) {
    const int g = i / D, d = i % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w][g]);
    float Ls = 0.f, A = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float f = expf(sm_m[w][g] - M);
        Ls = fmaf(sm_l[w][g], f, Ls);
        A = fmaf(sm_acc[w][g][d], f, A);
      }
    }
    const int h = kv * G + g;
    if (splits == 1) {
      out[((long long)b * H + h) * D + d] = from_f32<TQ>(Ls > 0.f ? A / Ls : 0.f);
    } else {
      const long long ps = ((long long)b * H + h) * splits + split;
      part_acc[ps * D + d] = A;
      if (d == 0) {
        part_m[ps] = M;
        part_l[ps] = Ls;
      }
    }
  }
}

template <typename TQ>
__global__ void paged_attn_combine(const float* __restrict__ part_m,
                                   const float* __restrict__ part_l,
                                   const float* __restrict__ part_acc, int splits,
                                   int D, TQ* __restrict__ out) {
  const long long bh = blockIdx.x;
  const int d = threadIdx.x;
  if (d >= D) return;
  const float* pm = part_m + bh * splits;
  const float* pl = part_l + bh * splits;
  float M = -INFINITY;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, pm[s]);
  float Ls = 0.f, A = 0.f;
  if (M != -INFINITY) {
    for (int s = 0; s < splits; ++s) {
      const float f = expf(pm[s] - M);
      Ls = fmaf(pl[s], f, Ls);
      A = fmaf(part_acc[(bh * splits + s) * D + d], f, A);
    }
  }
  out[bh * D + d] = from_f32<TQ>(Ls > 0.f ? A / Ls : 0.f);
}

template <typename TQ, typename TK, int EPL>
int launch(const void* q, const void* kp, const void* vp, const int* lengths,
           const int* table, int table_stride, int npg, int B, int H, int KV,
           long long s_kv, long long s_page, long long s_row, int page, int splits,
           int R, void* out, float* pm, float* pl, float* pacc, cudaStream_t stream) {
  dim3 grid(splits, KV, B);
  paged_attn_split<TQ, TK, EPL><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TK*>(kp), static_cast<const TK*>(vp),
      lengths, table, table_stride, npg, H, KV, s_kv, s_page, s_row, page, R,
      static_cast<TQ*>(out), pm, pl, pacc);
  if (splits > 1)
    paged_attn_combine<TQ><<<B * H, EPL * 32, 0, stream>>>(pm, pl, pacc, splits, EPL * 32,
                                                           static_cast<TQ*>(out));
  return (int)cudaGetLastError();
}

template <typename TQ, typename TK>
int by_d(int D, const void* q, const void* kp, const void* vp, const int* lengths,
         const int* table, int table_stride, int npg, int B, int H, int KV, long long s_kv,
         long long s_page, long long s_row, int page, int splits, int R, void* out,
         float* pm, float* pl, float* pacc, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<TQ, TK, 2>(q, kp, vp, lengths, table, table_stride, npg, B, H, KV, s_kv,
                               s_page, s_row, page, splits, R, out, pm, pl, pacc, stream);
    case 128:
      return launch<TQ, TK, 4>(q, kp, vp, lengths, table, table_stride, npg, B, H, KV, s_kv,
                               s_page, s_row, page, splits, R, out, pm, pl, pacc, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B, H, D] (q_f32: f32, else bf16), contiguous; pages (kv_f32: f32, else
// bf16) with strides s_kv, s_page, s_row in elements, D contiguous; lengths
// [B] int32; table [B, npg] int32, rows table_stride apart; out like q; the partials
// [B*H*splits] f32 (m, l) and [B*H*splits*D] f32 (acc), unused at splits 1.
int bn_paged_attention(const void* q, const void* kp, const void* vp, const int* lengths,
                       const int* table, int table_stride, int npg, int B, int H, int KV,
                       int D,
                       long long s_kv, long long s_page, long long s_row, int page,
                       int splits, int R, int q_f32, int kv_f32, void* out, float* pm,
                       float* pl, float* pacc, cudaStream_t stream) {
  if (H % KV != 0 || H / KV > G_MAX) return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  if (q_f32 && kv_f32)
    return by_d<float, float>(D, q, kp, vp, lengths, table, table_stride, npg, B, H, KV, s_kv,
                              s_page, s_row, page, splits, R, out, pm, pl, pacc, stream);
  if (q_f32)
    return by_d<float, bf>(D, q, kp, vp, lengths, table, table_stride, npg, B, H, KV, s_kv,
                           s_page, s_row, page, splits, R, out, pm, pl, pacc, stream);
  if (kv_f32)
    return by_d<bf, float>(D, q, kp, vp, lengths, table, table_stride, npg, B, H, KV, s_kv,
                           s_page, s_row, page, splits, R, out, pm, pl, pacc, stream);
  return by_d<bf, bf>(D, q, kp, vp, lengths, table, table_stride, npg, B, H, KV, s_kv, s_page,
                      s_row, page, splits, R, out, pm, pl, pacc, stream);
}

const char* bn_paged_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
