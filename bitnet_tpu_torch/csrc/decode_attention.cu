// Decode attention and the KV row scatter for Hopper (sm_90a).
//
// Replaces six Pallas kernels:
//   K2 bn_decode_attention_qkv <- decode_attention_qkv_v2_stacked
//      (bitnet_tpu/ops/decode_attention_v2.py:859, pallas_call :922), body
//      _v2_qkv_kernel (:318) with quant=False
//   K3 bn_scatter_kv_rows      <- scatter_kv_rows (decode_attention_v2.py:1068,
//      pallas_call :1113), body _scatter_rows_kernel (:1048)
//   K5 bn_decode_attention     <- decode_attention (bitnet_tpu/ops/
//      decode_attention.py:922, pallas_call :960), body _decode_attn_kernel
//      (:75-145): the v1 flash decode of the generic block_forward; the same
//      entry point is K8 <- decode_attention_batched_v2_stacked
//      (decode_attention_v2.py:675, pallas_call :735, body _v2_kernel :87),
//      the whole-batch decode of pools B = 3..64, whose function is K5's
//   K7 bn_decode_attention_qkv_quant <- decode_attention_qkv_quant_v2_stacked
//      (decode_attention_v2.py:949, pallas_call :1021): K2 over an int8 or
//      fp8-e4m3 cache, _v2_qkv_kernel with quant=True
//   K9 bn_decode_attention_quant <- decode_attention_quant_batched_v2_stacked
//      (decode_attention_v2.py:754, pallas_call :820): K8 over an int8 or
//      fp8-e4m3 cache, _v2_kernel with quant=True
//
// and the eleven other decode-attention sites, each under its own wrapper
// and launch counter (ops/decode_attention.py, ops/decode_attention_v2.py),
// since every one computes K2's function or K5's and the TPU kernels differ
// only in their grids (per b or whole batch, a layer slice or the stack),
// their bodies (v1 or v2) and the chunks of cache rows against whose running
// maxima they round the softmax weights (which this pair replaces with its
// own 4-row groups and 64-row splits, as for K2 and K5):
//   bn_decode_attention_qkv (K2's entry point) <- decode_attention_qkv
//      (decode_attention.py:488) K13, decode_attention_qkv_batched (:1421)
//      K18, decode_attention_qkv_batched_v2 (decode_attention_v2.py:487) K20
//   bn_decode_attention_qkv_quant <- decode_attention_qkv_quant
//      (decode_attention.py:859) K14, decode_attention_qkv_quant_batched
//      (:1609) K19, decode_attention_qkv_quant_batched_v2
//      (decode_attention_v2.py:582) K21
//   bn_decode_attention <- decode_attention_batched (decode_attention.py:1114)
//      K16, decode_attention_batched_v2 (decode_attention_v2.py:1193) K22,
//      decode_attention_stacked (decode_attention.py:149, pallas_call :204)
//      K25, decode_attention_stacked_inplace (:271, pallas_call :334) K26,
//      decode_attention_perb_v2 (decode_attention_v2.py:249, pallas_call
//      :278) K27
//   bn_decode_attention_quant <- decode_attention_quant
//      (decode_attention.py:655) K15, decode_attention_quant_batched (:1262)
//      K17, decode_attention_quant_batched_v2 (decode_attention_v2.py:1291)
//      K23
// The v1 kernels keep the roped k row and the v row in f32 for the new
// token's init, apply the k scales after the dot and the v scales before the
// weights' bf16 rounding, and return the rows in the cache dtype: as K2, K7
// and K9 do, so no template flag tells them apart.
//
// K2 takes the raw fused projection row qkv [B, H+2KV, D], applies split-
// layout RoPE to q and k, and runs flash-decode over the PRE-write flat
// cache layer [B, S, KV*D] (bf16, or f32 below) for rows < pos[b], with the new token
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
// K5 is the same two passes without RoPE (template flag ROPE = false): q
// [B, H, D] arrives roped, and q, k_new and v_new are rounded to the cache
// dtype first, so the softmax starts from m = (q_bf16 . k_bf16)/sqrt(D),
// d = 1, ctx = v_bf16 (decode_attention.py:941-943, :96-119); it writes
// nothing (the generic path writes the cache rows itself).  Bound: the same
// cache bytes as K2.  The TPU kernel rounds e to bf16 against the running
// max over chunks of min(1024, S) rows, this one against its warps' 4-row
// groups and 64-row splits: a bf16-level difference, as for K2.  K8 is K5
// launched over a pool: the grid's z axis is the batch, so B = 3..64 (and
// the TPU's batch groups above 16, a VMEM limit the card does not have)
// need nothing new; an idle slot (pos = 0) skips every split and its
// output is the new token's v.
//
// Over an f32 cache (C = float, cache code 3; the JAX kernels take any float
// dtype and cast q and the new rows to it) nothing rounds to bf16: q, the new
// rows and the softmax weights stay f32 (CacheKind::ROUND), lanes load 16 (8)
// bytes a row, and the bound is twice the bf16 cache bytes.  K2, K5, K8,
// K13, K16, K18, K20, K22, K25–K27 take it; K3 copies its 4-byte rows.
//
// K25 is K5 on layer l of the 5-D stack [L, B, S, KV, D], whose memory is the
// flat stack's; K27 is K5 over a 4-D cache [B, S, KV, D] (a one-layer stack).
// K26 is K25 that also writes the new rows: the split pass reads the
// PRE-write cache (no split block may write, since every one reads the whole
// layer), then the combine pass casts k_new / v_new to the cache dtype and
// its g == 0 blocks store them at row wpos[b] of layer l, dropped outside
// [0, S) as the JAX mask drops them.  Two launches, as K5; bound: K5's bytes
// plus the 2*B rows written.
//
// K7 and K9 are K2 and K5 over a quantized cache: the cache element type C
// (int8 or __nv_fp8_e4m3; QUANT = a 1-byte C) streams at one byte an
// element, converted exactly to f32, and the per-(row, kv head) f32 scales
// [B, S, KV] scale the scores after the dot (s = (q.k) * scale * k_scale)
// and the softmax weights before their bf16 rounding (e * v_scale), while d
// sums the unscaled e (decode_attention_v2.py:425-440).  K7's combine pass
// also quantizes the roped k row and the v row per kv head exactly as
// _quantize_kv does (absmax over D; s = max(absmax, 1e-8) / qmax with IEEE
// division; codes x / s rounded half to even and clipped to +-127 for int8,
// or converted to e4m3 with round-to-nearest and saturation), and starts the
// softmax from the round-tripped rows (code * s, :392-393).  Bound: half the
// bf16 cache bytes, plus 8 bytes of scales a cache row.
//
// K3 writes the L new rows per batch slot in place at min(pos[b], S-1): a
// pos >= S overwrites row S-1 of that slot (the JAX package's clamped
// write), and for a quantized cache the rows' KV scales beside them.  It
// moves 2*L*B rows; it is bound by launch latency.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// The cache element type C decides two things.  QUANT: a 1-byte cache
// (int8 or fp8-e4m3 codes with f32 scales).  ROUND: q, the new rows without
// RoPE and the softmax weights round to bf16 before their dots, as the JAX
// kernels cast them to the cache dtype (to bf16 over a quantized cache, whose
// codes they read as bf16); over an f32 cache nothing rounds.
template <typename C>
struct CacheKind {
  static constexpr bool QUANT = sizeof(C) == 1;
  static constexpr bool ROUND = !std::is_same<C, float>::value;
  static __device__ __forceinline__ float cast(float v) { return ROUND ? bf16_round(v) : v; }
};

// The quantized cache types: codes, their f32 values, and qmax.
template <typename C>
struct Quant;
template <>
struct Quant<int8_t> {
  static constexpr float qmax = 127.f;
  static __device__ __forceinline__ int8_t encode(float q) {  // round, clip
    return static_cast<int8_t>(max(-127, min(127, __float2int_rn(q))));
  }
  static __device__ __forceinline__ float value(int8_t c) { return static_cast<float>(c); }
  static __device__ __forceinline__ float byte_value(uint32_t b) {
    return static_cast<float>(static_cast<int8_t>(static_cast<uint8_t>(b)));
  }
};
template <>
struct Quant<__nv_fp8_e4m3> {
  static constexpr float qmax = 448.f;
  static __device__ __forceinline__ __nv_fp8_e4m3 encode(float q) {
    __nv_fp8_e4m3 r;
    r.__x = __nv_cvt_float_to_fp8(q, __NV_SATFINITE, __NV_E4M3);
    return r;
  }
  static __device__ __forceinline__ float value(__nv_fp8_e4m3 c) {
    return static_cast<float>(c);
  }
  static __device__ __forceinline__ float byte_value(uint32_t b) {
    __nv_fp8_e4m3 r;
    r.__x = static_cast<__nv_fp8_storage_t>(b);
    return static_cast<float>(r);
  }
};

// EPL consecutive cache elements of one lane as f32: one 16- (8-) byte load
// of f32, bf16 pairs, or one 4- (2-) byte load of 1-byte codes
template <int EPL, typename C>
__device__ __forceinline__ void load_row(const C* p, float* out) {
  if constexpr (std::is_same<C, float>::value) {
    static_assert(EPL == 2 || EPL == 4, "f32 rows: D in (64, 128)");
    if constexpr (EPL == 4) {
      const float4 v = *reinterpret_cast<const float4*>(p);
      out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
    } else {
      const float2 v = *reinterpret_cast<const float2*>(p);
      out[0] = v.x; out[1] = v.y;
    }
  } else if constexpr (std::is_same<C, __nv_bfloat16>::value) {
#pragma unroll
    for (int e = 0; e < EPL; e += 2) {
      const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p + e);
      out[e] = __low2float(v);
      out[e + 1] = __high2float(v);
    }
  } else {
    static_assert(EPL == 2 || EPL == 4, "1-byte rows: D in (64, 128)");
    using W = typename std::conditional<EPL == 4, uint32_t, uint16_t>::type;
    const uint32_t w = *reinterpret_cast<const W*>(p);
#pragma unroll
    for (int e = 0; e < EPL; ++e) out[e] = Quant<C>::byte_value((w >> (8 * e)) & 0xffu);
  }
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
// ksc / vsc: the layer's scales [B, S, KV] (QUANT only).
// partial m/d: [B, KV, NS, G, 2]; partial ctx: [B, KV, NS, G, D]
// ---------------------------------------------------------------------------
template <int D, typename T, typename C, bool ROPE>
__global__ void __launch_bounds__(WARPS * 32)
attn_split(const T* __restrict__ q_rows, int q_bs,
           const float* __restrict__ sin_rows,
           const float* __restrict__ cos_rows,
           const C* __restrict__ kc, const C* __restrict__ vc,
           const float* __restrict__ ksc, const float* __restrict__ vsc,
           const int* __restrict__ pos,
           int H, int KV, int S, float scale, float* __restrict__ part_md,
           float* __restrict__ part_ctx) {
  using CK = CacheKind<C>;
  constexpr bool QUANT = CK::QUANT;
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
  const T* row_b = q_rows + (size_t)b * q_bs;

  // (roped) q of the G heads, cast to the cache dtype: once per block
  __shared__ float q_s[MAXG][D];
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const T* qr = row_b + (size_t)(h * G + i / D) * D;
    q_s[i / D][i % D] = CK::cast(ROPE ? rope_at(qr, i % D, half, sn, cs)
                                      : load_f32(qr, i % D));
  }
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
    float kf[UNROLL][EPL], vf[UNROLL][EPL], ks[UNROLL], vs[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {     // all the group's loads first
      const int j = min(j0 + u, w1 - 1);
      load_row<EPL>(kc + base + (size_t)j * KVD, kf[u]);
      load_row<EPL>(vc + base + (size_t)j * KVD, vf[u]);
      if constexpr (QUANT) {
        const size_t si = ((size_t)b * S + j) * KV + h;
        ks[u] = ksc[si];
        vs[u] = vsc[si];
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
          float su = __fmul_rn(s[u], scale);
          if constexpr (QUANT) su = __fmul_rn(su, ks[u]);   // after the dot
          s[u] = j0 + u < w1 ? su : NEG_INF;
          mx = fmaxf(mx, s[u]);
        }
        const float alpha = expf(m[g] - mx);
        float dd = dsum[g] * alpha;
#pragma unroll
        for (int e = 0; e < EPL; ++e) ctx[g][e] *= alpha;
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const float ev = expf(s[u] - mx);
          dd += ev;                                        // unscaled e
          const float eb = CK::cast(QUANT ? __fmul_rn(ev, vs[u]) : ev);
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
// memory.  With ROPE the new k row is roped in f32 and the block of g == 0
// writes it and the v row out (K2: in the cache dtype; K7: quantized, with
// their scales, and the softmax starts from the round-tripped rows); without,
// the new rows are cast to the cache dtype, and where wpos is given (K26) the
// block of g == 0 writes them into the layer's caches k_out / v_out [B, S,
// KV*D] at row wpos[b], dropped outside [0, S): every split block of pass 1
// has read the pre-write cache by then.
// ---------------------------------------------------------------------------
template <int D, typename T, typename C, bool ROPE>
__global__ void __launch_bounds__(COMBINE_WARPS * 32)
attn_combine(const T* __restrict__ q_rows, int q_bs,
             const T* __restrict__ k_new, const T* __restrict__ v_new,
             int kv_bs, const float* __restrict__ sin_rows,
             const float* __restrict__ cos_rows, const int* __restrict__ pos,
             int H, int KV, int S, int NS, float scale,
             const float* __restrict__ part_md,
             const float* __restrict__ part_ctx, T* __restrict__ out,
             C* __restrict__ k_out, C* __restrict__ v_out,
             float* __restrict__ ks_out, float* __restrict__ vs_out,
             const int* __restrict__ wpos) {
  using CK = CacheKind<C>;
  constexpr bool QUANT = CK::QUANT;
  constexpr int EPL = D / 32;
  const int G = H / KV, half = D / 2;
  const int hq = blockIdx.x, b = blockIdx.y, h = hq / G, g = hq % G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* sn = sin_rows + (size_t)b * half;
  const float* cs = cos_rows + (size_t)b * half;
  const T* row_b = q_rows + (size_t)b * q_bs;
  __shared__ float kr_s[D], vr_s[D], m0_s;
  __shared__ float am_s[2][D / 32];
  __shared__ float c_s[COMBINE_WARPS][D], d_s[COMBINE_WARPS];
  const int live = (min(pos[b], S) + SPLIT - 1) / SPLIT;
  extern __shared__ float smd[];                 // this head's [live] (m, d)
  const float* md = part_md + ((size_t)b * KV + h) * NS * G * 2;
  for (int sp = threadIdx.x; sp < live; sp += blockDim.x) {
    smd[2 * sp] = md[(sp * G + g) * 2];
    smd[2 * sp + 1] = md[(sp * G + g) * 2 + 1];
  }
  float kr = 0.f, vr = 0.f;                      // the new token's rows
  const size_t row_o = ((size_t)b * KV + h) * D;
  if (threadIdx.x < D) {
    const int d = threadIdx.x;
    const T* kn = k_new + (size_t)b * kv_bs + (size_t)h * D;
    const T* vn = v_new + (size_t)b * kv_bs + (size_t)h * D;
    kr = ROPE ? rope_at(kn, d, half, sn, cs) : CK::cast(load_f32(kn, d));
    vr = ROPE ? load_f32(vn, d) : CK::cast(load_f32(vn, d));
    if constexpr (ROPE && QUANT) {               // each row's absmax over D
      float ak = fabsf(kr), av = fabsf(vr);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        ak = fmaxf(ak, __shfl_xor_sync(0xffffffffu, ak, o));
        av = fmaxf(av, __shfl_xor_sync(0xffffffffu, av, o));
      }
      if (lane == 0) {
        am_s[0][warp] = ak;
        am_s[1][warp] = av;
      }
    }
  }
  if constexpr (ROPE && QUANT) __syncthreads();
  if (threadIdx.x < D) {
    const int d = threadIdx.x;
    if constexpr (ROPE && QUANT) {
      float ak = 0.f, av = 0.f;
#pragma unroll
      for (int w = 0; w < D / 32; ++w) {
        ak = fmaxf(ak, am_s[0][w]);
        av = fmaxf(av, am_s[1][w]);
      }
      const float sk = __fdiv_rn(fmaxf(ak, 1e-8f), Quant<C>::qmax);
      const float sv = __fdiv_rn(fmaxf(av, 1e-8f), Quant<C>::qmax);
      const C ck = Quant<C>::encode(__fdiv_rn(kr, sk));
      const C cv = Quant<C>::encode(__fdiv_rn(vr, sv));
      kr = __fmul_rn(Quant<C>::value(ck), sk);   // the round-tripped rows
      vr = __fmul_rn(Quant<C>::value(cv), sv);
      if (g == 0) {
        k_out[row_o + d] = ck;
        v_out[row_o + d] = cv;
        if (d == 0) {
          ks_out[(size_t)b * KV + h] = sk;
          vs_out[(size_t)b * KV + h] = sv;
        }
      }
    } else if constexpr (ROPE) {
      if (g == 0) {
        store_f32(k_out, row_o + d, kr);
        store_f32(v_out, row_o + d, vr);
      }
    } else if constexpr (!QUANT) {                // K26: kr, vr are cast already
      const int wp = wpos != nullptr && g == 0 ? wpos[b] : -1;
      if (wp >= 0 && wp < S) {
        const size_t o = ((size_t)b * S + wp) * KV * D + (size_t)h * D + d;
        store_f32(k_out, o, kr);
        store_f32(v_out, o, vr);
      }
    }
    kr_s[d] = kr;
    vr_s[d] = vr;
  }
  __syncthreads();
  if (warp == 0) {                               // m0 = (q . k_new) * scale
    float s = 0.f;
    const T* qr = row_b + (size_t)hq * D;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = lane * EPL + e;
      s += (ROPE ? rope_at(qr, d, half, sn, cs) : CK::cast(load_f32(qr, d))) * kr_s[d];
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
// K3: grid (L, B); copies one row of row_bytes per cache, 16 bytes a thread,
// and for a quantized cache the row's KV scales (ksc != nullptr).
// ---------------------------------------------------------------------------
__global__ void scatter_rows(char* __restrict__ kc, char* __restrict__ vc,
                             const char* __restrict__ kr,
                             const char* __restrict__ vr,
                             float* __restrict__ ksc, float* __restrict__ vsc,
                             const float* __restrict__ ksr,
                             const float* __restrict__ vsr,
                             const int* __restrict__ pos, int B, int S,
                             int row_bytes, int KV) {
  const int l = blockIdx.x, b = blockIdx.y;
  const int p = min(pos[b], S - 1);
  const size_t dst = ((size_t)l * B + b) * S + p;   // destination row
  const size_t src = (size_t)l * B + b;
  const int n16 = row_bytes / 16;
  int4* kd = reinterpret_cast<int4*>(kc + dst * row_bytes);
  int4* vd = reinterpret_cast<int4*>(vc + dst * row_bytes);
  const int4* ks = reinterpret_cast<const int4*>(kr + src * row_bytes);
  const int4* vs = reinterpret_cast<const int4*>(vr + src * row_bytes);
  for (int i = threadIdx.x; i < n16; i += blockDim.x) {
    kd[i] = ks[i];
    vd[i] = vs[i];
  }
  if (ksc != nullptr)
    for (int i = threadIdx.x; i < KV; i += blockDim.x) {
      ksc[dst * KV + i] = ksr[src * KV + i];
      vsc[dst * KV + i] = vsr[src * KV + i];
    }
}

// q_rows: head hq of batch b at q_rows + b*q_bs + hq*D; k_new / v_new: kv
// head h at k_new + b*kv_bs + h*D.  K2 and K7 point all three into the qkv
// rows.  ksc / vsc: the layer's cache scales (quantized caches); k_out ..
// vs_out: the new rows (ROPE only) and their scales (ROPE and quantized).
template <int D, typename T, typename C, bool ROPE>
cudaError_t launch_attn(const void* q_rows, int q_bs, const void* k_new,
                        const void* v_new, int kv_bs, const float* sin_rows,
                        const float* cos_rows, const void* kc, const void* vc,
                        const float* ksc, const float* vsc,
                        const int* pos, int B, int H, int KV, int S,
                        float scale, void* out, void* k_out, void* v_out,
                        float* ks_out, float* vs_out, float* part_md,
                        float* part_ctx, const int* wpos, cudaStream_t stream) {
  const int NS = (S + SPLIT - 1) / SPLIT;
  const T* q = static_cast<const T*>(q_rows);
  attn_split<D, T, C, ROPE><<<dim3(NS, KV, B), WARPS * 32, 0, stream>>>(
      q, q_bs, sin_rows, cos_rows, static_cast<const C*>(kc),
      static_cast<const C*>(vc), ksc, vsc, pos, H, KV, S, scale, part_md,
      part_ctx);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t smem = (size_t)NS * 2 * sizeof(float);
  if (smem > 40 * 1024) {
    e = cudaFuncSetAttribute(attn_combine<D, T, C, ROPE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  attn_combine<D, T, C, ROPE><<<dim3(H, B), COMBINE_WARPS * 32, smem, stream>>>(
      q, q_bs, static_cast<const T*>(k_new), static_cast<const T*>(v_new), kv_bs,
      sin_rows, cos_rows, pos, H, KV, S, NS, scale, part_md, part_ctx,
      static_cast<T*>(out), static_cast<C*>(k_out), static_cast<C*>(v_out),
      ks_out, vs_out, wpos);
  return cudaGetLastError();
}

// the cache codes of the entry points: 0 = int8, 1 = fp8 e4m3, 2 = bf16,
// 3 = f32
template <typename C>
constexpr int cache_code() {
  return std::is_same<C, int8_t>::value           ? 0
         : std::is_same<C, __nv_fp8_e4m3>::value  ? 1
         : std::is_same<C, __nv_bfloat16>::value  ? 2
                                                  : 3;
}

// the instance for (D, activation dtype: 0 = f32, 1 = bf16, cache code)
template <bool ROPE, typename... A>
int dispatch(int D, int dtype, int cache, A... a) {
#define BN_CASE(DD, TT, CC)                                                    \
  if (D == DD && dtype == (std::is_same<TT, float>::value ? 0 : 1) &&          \
      cache == cache_code<CC>())                                               \
    return (int)launch_attn<DD, TT, CC, ROPE>(a...);
#define BN_CASES(CC)                       \
  BN_CASE(128, __nv_bfloat16, CC)          \
  BN_CASE(128, float, CC)                  \
  BN_CASE(64, __nv_bfloat16, CC)           \
  BN_CASE(64, float, CC)
  BN_CASES(__nv_bfloat16)
  BN_CASES(float)
  BN_CASES(int8_t)
  BN_CASES(__nv_fp8_e4m3)
#undef BN_CASES
#undef BN_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype (qkv and out): 0 = float32, 1 = bfloat16; cache: 2 = bf16, 3 = f32.
// scale = D**-0.5 rounded to f32 by the caller (as the JAX kernel takes it).
// D must be 64 or 128 and H / KV <= 8.  part_md: B*KV*NS*G*2 floats,
// part_ctx: B*KV*NS*G*D floats, NS = ceil(S / 64).
int bn_decode_attention_qkv(const void* qkv, const float* sin_rows,
                            const float* cos_rows, const void* kc,
                            const void* vc, const int* pos, int B, int H,
                            int KV, int D, int S, float scale, void* out,
                            void* k_out,
                            void* v_out, float* part_md, float* part_ctx,
                            int dtype, int cache, cudaStream_t stream) {
  if (H % KV != 0 || H / KV > MAXG || cache < 2 || cache > 3)
    return (int)cudaErrorInvalidValue;
  const int bs = (H + 2 * KV) * D, esz = dtype == 1 ? 2 : 4;
  const char* base = static_cast<const char*>(qkv);
  return dispatch<true>(D, dtype, cache, qkv, bs, base + (size_t)H * D * esz,
                        base + (size_t)(H + KV) * D * esz, bs, sin_rows,
                        cos_rows, kc, vc, (const float*)nullptr,
                        (const float*)nullptr, pos, B, H, KV, S, scale, out,
                        k_out, v_out, (float*)nullptr, (float*)nullptr,
                        part_md, part_ctx, (const int*)nullptr, stream);
}

// K7: K2 over a quantized cache (cache: 0 = int8, 1 = fp8 e4m3) with its
// f32 scales ks / vs, the layer's [B, S, KV].  k_out / v_out [B, KV, D]
// receive the new rows' codes, ks_out / vs_out [B, KV] their scales.
int bn_decode_attention_qkv_quant(const void* qkv, const float* sin_rows,
                                  const float* cos_rows, const void* kc,
                                  const void* vc, const float* ks,
                                  const float* vs, const int* pos, int B,
                                  int H, int KV, int D, int S, float scale,
                                  void* out, void* k_out, void* v_out,
                                  float* ks_out, float* vs_out, float* part_md,
                                  float* part_ctx, int dtype, int cache,
                                  cudaStream_t stream) {
  if (H % KV != 0 || H / KV > MAXG || cache < 0 || cache > 1)
    return (int)cudaErrorInvalidValue;
  const int bs = (H + 2 * KV) * D, esz = dtype == 1 ? 2 : 4;
  const char* base = static_cast<const char*>(qkv);
  return dispatch<true>(D, dtype, cache, qkv, bs, base + (size_t)H * D * esz,
                        base + (size_t)(H + KV) * D * esz, bs, sin_rows,
                        cos_rows, kc, vc, ks, vs, pos, B, H, KV, S, scale, out,
                        k_out, v_out, ks_out, vs_out, part_md, part_ctx,
                        (const int*)nullptr, stream);
}

// K5 and K8 (and K25, K27): q [B, H, D] (roped), k_new / v_new [B, KV, D],
// all of one dtype (0 = float32, 1 = bfloat16; out has it too); kc / vc the
// layer [B, S, KV*D], bf16 (cache 2) or f32 (cache 3).  wpos null: the caches
// are read only.  wpos [B] (K26): the combine pass then writes the new rows,
// cast to the cache dtype, at row wpos[b] of kc / vc, dropping a row outside
// [0, S).  Partials as for bn_decode_attention_qkv.
int bn_decode_attention(const void* q, const void* k_new, const void* v_new,
                        void* kc, void* vc, const int* pos, const int* wpos,
                        int B, int H, int KV, int D, int S, float scale,
                        void* out, float* part_md, float* part_ctx, int dtype,
                        int cache, cudaStream_t stream) {
  if (H % KV != 0 || H / KV > MAXG || cache < 2 || cache > 3)
    return (int)cudaErrorInvalidValue;
  void* k_w = wpos != nullptr ? kc : nullptr;
  void* v_w = wpos != nullptr ? vc : nullptr;
  return dispatch<false>(D, dtype, cache, q, H * D, k_new, v_new, KV * D,
                         (const float*)nullptr, (const float*)nullptr,
                         (const void*)kc, (const void*)vc,
                         (const float*)nullptr, (const float*)nullptr, pos, B,
                         H, KV, S, scale, out, k_w, v_w, (float*)nullptr,
                         (float*)nullptr, part_md, part_ctx, wpos, stream);
}

// K9: K8 over a quantized cache (cache: 0 = int8, 1 = fp8 e4m3) with the
// layer's f32 scales ks / vs [B, S, KV]; k_new / v_new are the new rows
// after the quantization round trip.
int bn_decode_attention_quant(const void* q, const void* k_new,
                              const void* v_new, const void* kc,
                              const void* vc, const float* ks, const float* vs,
                              const int* pos, int B, int H, int KV, int D,
                              int S, float scale, void* out, float* part_md,
                              float* part_ctx, int dtype, int cache,
                              cudaStream_t stream) {
  if (H % KV != 0 || H / KV > MAXG || cache < 0 || cache > 1)
    return (int)cudaErrorInvalidValue;
  return dispatch<false>(D, dtype, cache, q, H * D, k_new, v_new, KV * D,
                         (const float*)nullptr, (const float*)nullptr, kc, vc,
                         ks, vs, pos, B, H, KV, S, scale, out, (void*)nullptr,
                         (void*)nullptr, (float*)nullptr, (float*)nullptr,
                         part_md, part_ctx, (const int*)nullptr, stream);
}

// K3: rows [L, B, 1, row_bytes] into caches [L, B, S, row_bytes]; ks .. vsr
// null for a bf16 cache, else the scale stacks [L, B, S, KV] and the rows'
// scales [L, B, 1, KV].
int bn_scatter_kv_rows(void* kc, void* vc, const void* k_rows,
                       const void* v_rows, float* ks, float* vs,
                       const float* ks_rows, const float* vs_rows,
                       const int* pos, int L, int B, int S, int row_bytes,
                       int KV, cudaStream_t stream) {
  if (row_bytes % 16 != 0) return (int)cudaErrorInvalidValue;
  scatter_rows<<<dim3(L, B), 128, 0, stream>>>(
      static_cast<char*>(kc), static_cast<char*>(vc),
      static_cast<const char*>(k_rows), static_cast<const char*>(v_rows), ks,
      vs, ks_rows, vs_rows, pos, B, S, row_bytes, KV);
  return (int)cudaGetLastError();
}

const char* bn_decode_attention_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
