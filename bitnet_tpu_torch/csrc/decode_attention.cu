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
// maxima they round the softmax weights (which this kernel replaces with
// its own 64-row stages, as for K2 and K5):
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
// one launch gives each (split of R cache rows, kv head, b) its own block,
// R a power of two >= 64 from attn_plan (ops/decode_attention.py) so that
// the blocks give each of the 132 SMs at most one (two over a 1-byte cache,
// whose stages the code conversions bound).  A block is one producer warp
// and CW = 4 consumer warps.  The producer's lane 0 streams the split's rows
// of kv head h through TMA, SR = 64 rows a stage, k and v each under their
// own mbarrier, into a ring of NST (2-4) stages, so a 4k split's whole slab
// is in flight before the first wait; the layer is the 2-D tensor [B*S,
// KV*D] of the cache dtype, its head rows cut in 128-byte panels (64 for an
// int8 / fp8 row of D = 64) with TMA's 128-byte (64-byte) swizzle, which
// keeps the fragment loads free of bank conflicts.  Meanwhile the consumers
// build q of the G = H/KV heads (roped for K2 / K7, cast to the cache dtype),
// the new token's rows and its score of each head.  Consumer warp w takes
// rows 16w .. 16w+15 of every stage with a softmax state of its own (no
// barrier a stage) and runs both products on the tensor cores, mma.sync
// m16n8k16 in bf16 with f32 sums: the G <= 8 heads are A's rows (8..15
// zero), so each cache row is read once for all G heads; scores = q . k_rows
// (K's rows as B's columns, 1-byte codes converted exactly to bf16 on the
// way), then the bf16 weights, as FlashAttention-2 does, stay in registers
// as PV's A operand, and v's rows reach B through ldmatrix.trans (1-byte
// codes first copied to bf16 a warp).  Blocks past a slot's pos exit at
// once; the grid is sized by S so no host sync reads pos.
//
// The combine runs in the same launch.  A slot whose rows fit one split
// folds its partial (m, d, ctx) from shared memory.  Otherwise each block
// writes its partial (it stays in the L2), fences, and counts itself in the
// (b, kv head) counter; the block that sees the last live split arrive
// resets the counter to 0 (so the next call and every CUDA-graph replay
// find it zeroed), folds the new token and every partial against their
// common max, writes out and the new rows.  Split 0 always runs, so at pos
// = 0 the output is still the new token's v and the new rows are written.
//
// K2 is the kernel with RoPE (template flag ROPE): q, k and v come raw from
// the qkv rows; its combine writes the roped k row and the v row in the
// cache dtype.  K5 is it without RoPE: q [B, H, D] arrives roped, and q,
// k_new and v_new are rounded to the cache dtype first, so the softmax
// starts from m = (q_bf16 . k_bf16)/sqrt(D), d = 1, ctx = v_bf16
// (decode_attention.py:941-943, :96-119); it writes nothing (the generic
// path writes the cache rows itself).  Bound: the same cache bytes as K2.
// The TPU kernel rounds e to bf16 against the running max over chunks of
// min(1024, S) rows, this one against the running max over its split's
// 64-row stages: a bf16-level difference, as for K2.  K8 is K5 launched over
// a pool: the grid's z axis is the batch, so B = 3..64 (and the TPU's batch
// groups above 16, a VMEM limit the card does not have) need nothing new;
// an idle slot (pos = 0) runs split 0 alone and its output is the new
// token's v.
//
// Over an f32 cache (C = float, cache code 3; the JAX kernels take any float
// dtype and cast q and the new rows to it) nothing rounds to bf16: q, the new
// rows and the softmax weights stay f32 (CacheKind::ROUND), so the products
// run on the CUDA cores (lanes own rows for the scores, the stage's max meets
// in shared memory, lanes own D/32 elements of the PV sum), the ring holds
// two stages, and the bound is twice the bf16 cache bytes.  K2, K5, K8,
// K13, K16, K18, K20, K22, K25–K27 take it; K3 copies its 4-byte rows.
//
// K25 is K5 on layer l of the 5-D stack [L, B, S, KV, D], whose memory is the
// flat stack's; K27 is K5 over a 4-D cache [B, S, KV, D] (a one-layer stack).
// K26 is K25 that also writes the new rows: every block reads the PRE-write
// cache, and the block that combines (b, kv head h) casts k_new / v_new to
// the cache dtype and stores them at row wpos[b] of layer l, dropped outside
// [0, S) as the JAX mask drops them: only the blocks of the same (b, h) read
// that slice, and all of them have arrived.  Bound: K5's bytes plus the 2*B
// rows written.
//
// K7 and K9 are K2 and K5 over a quantized cache: the cache element type C
// (int8 or __nv_fp8_e4m3; QUANT = a 1-byte C) streams at one byte an
// element, converted exactly to f32, and the per-(row, kv head) f32 scales
// [B, S, KV] scale the scores after the dot (s = (q.k) * scale * k_scale)
// and the softmax weights before their bf16 rounding (e * v_scale), while d
// sums the unscaled e (decode_attention_v2.py:425-440).  K7's combine also
// quantizes the roped k row and the v row per kv head exactly as
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ternary_common.cuh"

namespace {

using namespace bn;

constexpr float NEG_INF = -1e30f;
constexpr int CW = 4;                   // consumer warps
constexpr int THREADS = (CW + 1) * 32;  // and one producer warp
constexpr int SR = 64;                  // cache rows a stage
constexpr int WPG = SR / 32;            // warps of a head group (score pass)
constexpr int HG = CW / WPG;            // head groups
constexpr int MAXG = 8;                 // query heads of a kv head
constexpr int GPL = MAXG / HG;          // heads a lane scores
constexpr int PV_ROWS = SR / CW;        // rows of a stage a warp folds into ctx
constexpr int MAX_SPLITS = 256;
constexpr int SMEM_BUDGET = 98304;      // the ring: two blocks an SM at bf16, D = 128

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
  // the 4 codes of w: 2^23 + (x + 128) built by a byte permute, less
  // 2^23 + 128 (exact, and at the FP32 add's rate, not the conversion's)
  static __device__ __forceinline__ void values4(uint32_t w, float* f) {
    const uint32_t u = w ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i)) - 8388736.f;
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
  // the 4 codes of w, two at a time through f16 (exact: e4m3 is in f16)
  static __device__ __forceinline__ void values4(uint32_t w, float* f) {
    const float2 lo = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w & 0xffffu), __NV_E4M3)));
    const float2 hi = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(w >> 16), __NV_E4M3)));
    f[0] = lo.x;
    f[1] = lo.y;
    f[2] = hi.x;
    f[3] = hi.y;
  }
};

// The shape of a stage for head rows of D elements of C: ROW bytes, cut in
// NP panels of PB bytes (TMA's swizzle span: 128, or 64 for a 64-byte row),
// one TMA box [SR rows x PB] each; TILE bytes of k (and of v) a stage; NST
// stages in the ring, as many as SMEM_BUDGET holds (2 to 4).
template <int D, typename C>
struct Geo {
  static constexpr int ESZ = sizeof(C);
  static constexpr int ROW = D * ESZ;
  static constexpr int PB = ROW < 128 ? ROW : 128;
  static constexpr int NP = ROW / PB;
  static constexpr int TILE = SR * ROW;
  static constexpr int STAGE = 2 * TILE;
  static constexpr int NST = 4 * STAGE <= SMEM_BUDGET ? 4 : 3 * STAGE <= SMEM_BUDGET ? 3 : 2;
  static constexpr int RING = NST * STAGE;
  static constexpr int EPL = D / 32;            // elements of a lane in the PV sum
  static constexpr int BPL = EPL * ESZ;
  static_assert(PB == 64 || PB == 128, "head rows of 64 bytes or a multiple of 128");
};

// byte b of row r of a stage tile: panel b / PB, then TMA's swizzle, which
// XORs the 16-byte chunk with row bits (r & 7 for 128-byte panel rows,
// (r >> 1) & 3 for 64-byte ones; the panels are 1024-byte aligned)
template <int PB>
__device__ __forceinline__ int tile_off(int r, int b) {
  const int x = PB == 128 ? (r & 7) : ((r >> 1) & 3);
  const int c = b % PB;
  return (b / PB) * SR * PB + r * PB + ((((c >> 4) ^ x) << 4) | (c & 15));
}

// the EPL f32 elements of a lane (f32 caches; in one 16-byte chunk)
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

// 4 bytes global -> shared, asynchronously (cp.async), and an arrival on
// an mbarrier once this thread's copies so far have landed
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
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

// q_rows: head hq of batch b at q_rows + b*q_bs + hq*D; k_new / v_new: kv
// head h at k_new + b*kv_bs + h*D.  K2 and K7 point all three into the qkv
// rows.  ksc / vsc: the layer's cache scales [B, S, KV] (quantized caches);
// k_out .. vs_out: the new rows (ROPE only; K26: the layer's caches, with
// wpos) and their scales (ROPE and quantized).  part_md [B, KV, NS, G, 2],
// part_ctx [B, KV, NS, G, D]; counters [B*KV], zero between calls.
struct AttnArgs {
  const void* q_rows;
  const void* k_new;
  const void* v_new;
  const float* sin_rows;
  const float* cos_rows;
  const float* ksc;
  const float* vsc;
  const int* pos;
  const int* wpos;
  float* part_md;
  float* part_ctx;
  int* counters;
  void* out;
  void* k_out;
  void* v_out;
  float* ks_out;
  float* vs_out;
  int q_bs, kv_bs, H, KV, S, R;
  float scale;
};

// ---------------------------------------------------------------------------
// The tensor-core pieces of the bf16 and 1-byte instances: mma.sync
// m16n8k16 (bf16 in, f32 accumulate) with the query heads as A's rows 0..7
// (rows 8..15 zero), K's rows as B's columns for the scores and P's
// columns as A's k for PV (FlashAttention-2's register reuse).
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// the same for values bf16 holds exactly (1-byte codes): their top halves,
// one byte permute in place of two conversions
__device__ __forceinline__ uint32_t pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// c += [a0; 0 | a2; 0] (16 x 16, rows 8..15 zero) * [b0; b1] (16 x 8)
__device__ __forceinline__ void mma_heads(float (&c)[4], uint32_t a0, uint32_t a2,
                                          uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices, transposed (lane i names row i % 8 of matrix i / 8)
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// A score mma's B fragment: the 4 cache elements at p (k slots 2t, 2t+1 in
// b0, 8+2t, 9+2t in b1; q's A fragment takes the same 4 elements of d),
// bf16 as they are, 1-byte codes exactly in bf16
template <typename C>
__device__ __forceinline__ void load_kfrag(const unsigned char* p, uint32_t& b0,
                                           uint32_t& b1) {
  if constexpr (std::is_same<C, __nv_bfloat16>::value) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    b0 = v.x;
    b1 = v.y;
  } else {
    float f[4];
    Quant<C>::values4(*reinterpret_cast<const uint32_t*>(p), f);
    b0 = pack_exact(f[0], f[1]);
    b1 = pack_exact(f[2], f[3]);
  }
}

// byte b of row r of a warp's 16-row bf16 copy of its v rows (1-byte
// caches), swizzled as the stage tiles are
__device__ __forceinline__ int vrow_off(int r, int b) {
  return (b >> 7) * 16 * 128 + r * 128 + (((((b & 127) >> 4) ^ (r & 7))) << 4) + (b & 15);
}

// ---------------------------------------------------------------------------
// grid (NS, KV, B), THREADS threads: split blockIdx.x of R cache rows of kv
// head blockIdx.y of slot blockIdx.z, then (by the last of the slot's live
// splits) the combine.
// ---------------------------------------------------------------------------
template <int D, typename T, typename C, bool ROPE>
__global__ void __launch_bounds__(THREADS, 2)
attn_decode(const __grid_constant__ CUtensorMap kmap,
            const __grid_constant__ CUtensorMap vmap, const AttnArgs a) {
  using CK = CacheKind<C>;
  using GE = Geo<D, C>;
  constexpr bool QUANT = CK::QUANT, MMA = CK::ROUND;   // f32: CUDA cores
  constexpr int EPL = GE::EPL, NST = GE::NST, PB = GE::PB;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int NS = gridDim.x, KV = a.KV, S = a.S, G = a.H / KV, half = D / 2;
  if (threadIdx.x == CW * 32) {        // the maps' fetch overlaps the pos read
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(&kmap) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(&vmap) : "memory");
  }
  const int p = min(a.pos[b], S);
  const int live = max(1, (p + a.R - 1) / a.R);          // split 0 always runs
  if (split >= live) return;
  const int start = split * a.R;
  const int nst = (max(0, min(a.R, p - start)) + SR - 1) / SR;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* sn = a.sin_rows + (size_t)b * half;
  const float* cs = a.cos_rows + (size_t)b * half;
  const T* row_b = static_cast<const T*>(a.q_rows) + (size_t)b * a.q_bs;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __shared__ __align__(16) float q_s[MAXG][D];           // q of the cache dots
  __shared__ float qf_s[ROPE ? MAXG : 1][D];             // (ROPE) q roped, unrounded
  __shared__ __align__(16) float e_s[MMA ? 1 : 2][SR][MAXG];   // (f32) a stage's weights
  __shared__ float red_s[CW][GPL];
  __shared__ __align__(128) unsigned char vb_s[QUANT ? CW * 16 * D * 2 : 16];
  __shared__ float mw_s[CW][MAXG], dw_s[CW][MAXG];       // the warps' partials
  // (1-byte caches) a stage's k and v scales, beside its slot of the ring
  __shared__ float sc_s[QUANT ? NST : 1][2][SR];
  __shared__ __align__(16) float pc_s[MAXG][D];          // this split's partial
  __shared__ float pm_s[MAXG], pd_s[MAXG];
  __shared__ float kr_s[D], am_s[2][D / 32];
  __shared__ float vr_s[D];
  __shared__ float m0_s[MAXG], a0_s[MAXG], den_s[MAXG];
  __shared__ __align__(8) uint64_t full_k[NST], full_v[NST], full_s[NST], empty[NST];
  __shared__ int last_s;

  if (tid == CW * 32) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&full_s[s], 32);                         // (1-byte) the producer's lanes
      mbar_init(&empty[s], CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the new token's rows (threads < D keep them to the combine).  With ROPE
  // the k row is roped in f32 (K7: both rows quantized, the softmax starting
  // from the round-tripped rows); without, both are cast to the cache dtype
  float kr = 0.f, vr = 0.f, sk = 0.f, sv = 0.f;
  C ck{}, cv{};
  // this split's state: f32 (CUDA cores) a running max shared by the warps,
  // ctx partial sums a warp, d partial sums a lane; tensor cores: a running
  // max, d and ctx a warp
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
      const int s = i % NST;
      if (i >= NST) mbar_wait(&empty[s], (i / NST - 1) & 1);
      const int row = b * S + start + i * SR;
      if (lane == 0) {
        unsigned char* kt = ring + s * GE::STAGE;
        mbar_expect_tx(&full_k[s], GE::TILE);
#pragma unroll
        for (int pn = 0; pn < GE::NP; ++pn)
          tma_load_2d(kt + pn * SR * PB, &kmap, &full_k[s], h * D + pn * (PB / GE::ESZ), row);
        mbar_expect_tx(&full_v[s], GE::TILE);
#pragma unroll
        for (int pn = 0; pn < GE::NP; ++pn)
          tma_load_2d(kt + GE::TILE + pn * SR * PB, &vmap, &full_v[s],
                      h * D + pn * (PB / GE::ESZ), row);
      }
      if constexpr (QUANT) {             // the scales, too narrow for a TMA box
        const int nv = min(SR, p - start - i * SR);
#pragma unroll
        for (int r = lane; r < SR; r += 32)
          if (r < nv) {
            const size_t si = ((size_t)row + r) * KV + h;
            cp_async4(&sc_s[s][0][r], a.ksc + si);
            cp_async4(&sc_s[s][1][r], a.vsc + si);
          }
        cp_async_arrive(&full_s[s]);
      }
    }
    __syncwarp();
  } else {                                               // consumers
    // while the rows stream: (roped) q of the G heads cast to the cache
    // dtype, the new token's rows and its score m0 of each head
    for (int i = tid; i < G * D; i += CW * 32) {
      const T* qr = row_b + (size_t)(h * G + i / D) * D;
      const float qv = ROPE ? rope_at(qr, i % D, half, sn, cs) : load_f32(qr, i % D);
      q_s[i / D][i % D] = CK::cast(qv);
      if constexpr (ROPE) qf_s[i / D][i % D] = qv;
    }
    if (tid < D) {
      const T* kn = static_cast<const T*>(a.k_new) + (size_t)b * a.kv_bs + (size_t)h * D;
      const T* vn = static_cast<const T*>(a.v_new) + (size_t)b * a.kv_bs + (size_t)h * D;
      kr = ROPE ? rope_at(kn, tid, half, sn, cs) : CK::cast(load_f32(kn, tid));
      vr = ROPE ? load_f32(vn, tid) : CK::cast(load_f32(vn, tid));
      if constexpr (ROPE && QUANT) {                     // each row's absmax over D
        const float ak = warp_max(fabsf(kr)), av = warp_max(fabsf(vr));
        if (lane == 0) {
          am_s[0][warp] = ak;
          am_s[1][warp] = av;
        }
      }
    }
    if constexpr (ROPE && QUANT) {
      consumers_sync();
      if (tid < D) {
        float ak = 0.f, av = 0.f;
#pragma unroll
        for (int w = 0; w < D / 32; ++w) {
          ak = fmaxf(ak, am_s[0][w]);
          av = fmaxf(av, am_s[1][w]);
        }
        sk = __fdiv_rn(fmaxf(ak, 1e-8f), Quant<C>::qmax);
        sv = __fdiv_rn(fmaxf(av, 1e-8f), Quant<C>::qmax);
        ck = Quant<C>::encode(__fdiv_rn(kr, sk));
        cv = Quant<C>::encode(__fdiv_rn(vr, sv));
        kr = __fmul_rn(Quant<C>::value(ck), sk);         // the round-tripped rows
        vr = __fmul_rn(Quant<C>::value(cv), sv);
      }
    }
    if (tid < D) {
      kr_s[tid] = kr;
      vr_s[tid] = vr;
    }
    consumers_sync();
    for (int g = warp; g < G; g += CW) {                 // m0 = (q . k_new) * scale
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int d = lane * EPL + e;
        s += (ROPE ? qf_s[ROPE ? g : 0][d] : q_s[g][d]) * kr_s[d];
      }
      s = warp_sum(s);
      if (lane == 0) m0_s[g] = s * a.scale;
    }

    if constexpr (MMA) {
      // the tensor cores: warp w takes rows 16w .. 16w+15 of every stage
      // with a running softmax of its own; lane (gr, t4) holds head gr's
      // scores of rows 8nb + 2t4 + {0, 1} and its ctx at d = 8j + 2t4 + {0, 1}
      constexpr int KS = D / 16;
      const int gr = lane >> 2, t4 = lane & 3, rw = warp * PV_ROWS;
      uint32_t qa[KS][2];
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        const float* qq = &q_s[gr][16 * k + 4 * t4];
        qa[k][0] = gr < G ? pack_bf16(qq[0], qq[1]) : 0u;
        qa[k][1] = gr < G ? pack_bf16(qq[2], qq[3]) : 0u;
      }
      for (int i = 0; i < nst; ++i) {
        const int s = i % NST, par = (i / NST) & 1;
        const int j0 = start + i * SR, nv = min(SR, p - j0);   // the stage's valid rows
        unsigned char* kt = ring + s * GE::STAGE;
        if (rw < nv) {                   // (only a slot's last stage has rows past nv)
          float ks4[4], vs4[4];          // the lane's rows' scales (1 past nv)
          if constexpr (QUANT) mbar_wait(&full_s[s], par);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int rr = rw + 8 * (q >> 1) + 2 * t4 + (q & 1);
            const bool on = QUANT && rr < nv;
            ks4[q] = on ? sc_s[QUANT ? s : 0][0][rr] : 1.f;
            vs4[q] = on ? sc_s[QUANT ? s : 0][1][rr] : 1.f;
          }
          mbar_wait(&full_k[s], par);
          // every fragment of the warp's rows first, then the mmas in four
          // independent chains (two a column block of 8 rows)
          uint32_t kb[2][KS][2];
#pragma unroll
          for (int nb = 0; nb < 2; ++nb)
#pragma unroll
            for (int k = 0; k < KS; ++k)
              load_kfrag<C>(kt + tile_off<PB>(rw + 8 * nb + gr, (16 * k + 4 * t4) * GE::ESZ),
                            kb[nb][k][0], kb[nb][k][1]);
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
              mma_heads(sacc[nb][k & 1], qa[k][0], qa[k][1], kb[nb][k][0], kb[nb][k][1]);
          float sc[4], mx = NEG_INF;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float su = __fmul_rn(sacc[q >> 1][0][q & 1] + sacc[q >> 1][1][q & 1], a.scale);
            if constexpr (QUANT) su = __fmul_rn(su, ks4[q]);   // after the dot
            sc[q] = rw + 8 * (q >> 1) + 2 * t4 + (q & 1) < nv ? su : NEG_INF;
            mx = fmaxf(mx, sc[q]);
          }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float mn = fmaxf(mw, mx), alpha = expf(mw - mn);
          mw = mn;
          float pe[4], es = 0.f;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float ev = expf(sc[q] - mn);
            es += ev;                                    // unscaled e
            pe[q] = QUANT ? __fmul_rn(ev, vs4[q]) : ev;
          }
          dw = dw * alpha + es;
          const uint32_t pa0 = pack_bf16(pe[0], pe[1]), pa2 = pack_bf16(pe[2], pe[3]);
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            cacc[j][0] *= alpha;
            cacc[j][1] *= alpha;
          }
          mbar_wait(&full_v[s], par);
          // the warp's v rows as bf16 in ldmatrix's reach, rows past nv zero
          // (0 * garbage is no zero)
          unsigned char* vt = kt + GE::TILE;
          const unsigned char* vsrc = vt;
          int vrow0 = rw;
          constexpr int CPR = GE::ROW / 16;              // 16-byte chunks of a row
          if constexpr (QUANT) {
            // every chunk of the lane loaded first (one warp a scheduler has
            // no other warp to hide a chain of loads behind), then converted
            constexpr int NCH = 16 * CPR / 32;           // chunks a lane
            unsigned char* st = vb_s + warp * 16 * D * 2;
            uint4 raw[NCH];
#pragma unroll
            for (int it = 0; it < NCH; ++it) {
              const int idx = lane + 32 * it, rr = idx / CPR, c = idx % CPR;
              raw[it] = *reinterpret_cast<const uint4*>(vt + tile_off<PB>(rw + rr, c * 16));
            }
#pragma unroll
            for (int it = 0; it < NCH; ++it) {
              const int idx = lane + 32 * it, rr = idx / CPR, c = idx % CPR;
              const bool on = rw + rr < nv;
              const uint32_t w[4] = {raw[it].x, raw[it].y, raw[it].z, raw[it].w};
              uint32_t o[8];
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                float f[4];
                Quant<C>::values4(w[q], f);
                o[2 * q] = on ? pack_exact(f[0], f[1]) : 0u;
                o[2 * q + 1] = on ? pack_exact(f[2], f[3]) : 0u;
              }
              *reinterpret_cast<uint4*>(st + vrow_off(rr, c * 32)) = make_uint4(o[0], o[1], o[2], o[3]);
              *reinterpret_cast<uint4*>(st + vrow_off(rr, c * 32 + 16)) =
                  make_uint4(o[4], o[5], o[6], o[7]);
            }
            __syncwarp();
            vsrc = st;
            vrow0 = 0;
          } else if (rw + PV_ROWS > nv) {
            for (int idx = lane; idx < PV_ROWS * CPR; idx += 32) {
              const int rr = idx / CPR, c = idx % CPR;
              if (rw + rr >= nv)
                *reinterpret_cast<uint4*>(vt + tile_off<PB>(rw + rr, c * 16)) =
                    make_uint4(0u, 0u, 0u, 0u);
            }
            __syncwarp();
          }
          const int lr = vrow0 + (lane & 7) + 8 * ((lane >> 3) & 1);
          uint32_t bv[D / 16][4];
#pragma unroll
          for (int j = 0; j < D / 16; ++j) {
            const int byte = (16 * j + 8 * (lane >> 4)) * 2;
            ldsm_x4_trans(bv[j], vsrc + (QUANT ? vrow_off(lr, byte) : tile_off<PB>(lr, byte)));
          }
#pragma unroll
          for (int j = 0; j < D / 16; ++j) {
            mma_heads(cacc[2 * j], pa0, pa2, bv[j][0], bv[j][1]);
            mma_heads(cacc[2 * j + 1], pa0, pa2, bv[j][2], bv[j][3]);
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
        const int j0 = start + i * SR, nv = min(SR, p - j0);   // the stage's valid rows
        const unsigned char* kt = ring + s * GE::STAGE;
        mbar_wait(&full_k[s], par);
        float sc[GPL];
#pragma unroll
        for (int k = 0; k < GPL; ++k) sc[k] = 0.f;
#pragma unroll 4
        for (int c = 0; c < GE::ROW / 16; ++c) {
          const float4 kv = *reinterpret_cast<const float4*>(kt + tile_off<PB>(r, c * 16));
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
          const float su = __fmul_rn(sc[k], a.scale);
          sc[k] = r < nv ? su : NEG_INF;
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
        float* es = &e_s[i & 1][0][0];
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
          load_lane<EPL>(vt + tile_off<PB>(rr, lane * GE::BPL), vf);
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
              make_float2(cacc[j][0], cacc[j][1]);
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
  // each thread merges 4 elements of a head (and thread g < G head g's (m,
  // d)) and, past one split, publishes what it merged: the partial stays in
  // the L2 for the block that combines
  const size_t pbase = ((size_t)b * KV + h) * NS * G;    // (b, h, split 0, g 0)
  const size_t pb = pbase + (size_t)split * G;
  for (int i = tid; i < G * (D / 4); i += THREADS) {
    const int g = i / (D / 4), d0 = (i % (D / 4)) * 4;
    float m = NEG_INF;
#pragma unroll
    for (int w = 0; w < CW; ++w) m = fmaxf(m, mw_s[w][g]);
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
    *reinterpret_cast<float4*>(&pc_s[g][d0]) = c;
    if (live > 1) *reinterpret_cast<float4*>(a.part_ctx + (pb + g) * D + d0) = c;
  }
  if (tid < G) {
    float m = NEG_INF, dd = 0.f;
#pragma unroll
    for (int w = 0; w < CW; ++w) m = fmaxf(m, mw_s[w][tid]);
#pragma unroll
    for (int w = 0; w < CW; ++w) dd += dw_s[w][tid] * expf(mw_s[w][tid] - m);
    pm_s[tid] = m;
    pd_s[tid] = dd;
    if (live > 1) reinterpret_cast<float2*>(a.part_md)[pb + tid] = make_float2(m, dd);
  }
  __syncthreads();

  // more than one split: the last to arrive combines
  if (live > 1) {
    // one thread counts the block in: the release orders every thread's
    // stores above (after the barrier) before the count, the acquire the
    // last block's loads below after every other block's stores
    if (tid == 0) {
      int prev;
      asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
                   : "=r"(prev) : "l"(a.counters + b * KV + h) : "memory");
      last_s = prev == live - 1;
      if (last_s) a.counters[b * KV + h] = 0;
    }
    __syncthreads();
    if (!last_s) return;
  }
  // this thread's first four elements: the first PRE splits' partials, in
  // flight while the weights are formed
  constexpr int PRE = 16;
  float4 pre[PRE];
  // and the (m, d) pair of split lane of head warp, for the weights below
  const float2 md0 = live > 1 && warp < G && lane < live
      ? __ldcg(reinterpret_cast<const float2*>(a.part_md) + pbase + (size_t)lane * G + warp)
      : make_float2(pm_s[warp < G ? warp : 0], pd_s[warp < G ? warp : 0]);
  if (live > 1 && tid < G * (D / 4)) {
    const int g = tid / (D / 4), d0 = (tid % (D / 4)) * 4;
#pragma unroll
    for (int u = 0; u < PRE; ++u)
      if (u < live)
        pre[u] = __ldcg(reinterpret_cast<const float4*>(
            a.part_ctx + (pbase + (size_t)u * G + g) * D + d0));
  }
  auto part_md = [&](int sp, int g) {                   // (m, d) of split sp, head g
    return live > 1
        ? __ldcg(reinterpret_cast<const float2*>(a.part_md) + pbase + (size_t)sp * G + g)
        : make_float2(pm_s[g], pd_s[g]);
  };

  // the new rows out: K2 in the cache dtype; K7 its codes and scales; K26
  // (wpos given) into the layer's caches k_out / v_out [B, S, KV*D] at row
  // wpos[b], dropped outside [0, S) (every block of (b, h) has read them)
  C* k_out = static_cast<C*>(a.k_out);
  C* v_out = static_cast<C*>(a.v_out);
  if (tid < D) {
    const int d = tid;
    const size_t row_o = ((size_t)b * KV + h) * D;
    if constexpr (ROPE && QUANT) {
      k_out[row_o + d] = ck;
      v_out[row_o + d] = cv;
      if (d == 0) {
        a.ks_out[(size_t)b * KV + h] = sk;
        a.vs_out[(size_t)b * KV + h] = sv;
      }
    } else if constexpr (ROPE) {
      store_f32(k_out, row_o + d, kr);
      store_f32(v_out, row_o + d, vr);
    } else if constexpr (!QUANT) {                       // kr, vr are cast already
      const int wp = a.wpos != nullptr ? a.wpos[b] : -1;
      if (wp >= 0 && wp < S) {
        const size_t o = ((size_t)b * S + wp) * KV * D + (size_t)h * D + d;
        store_f32(k_out, o, kr);
        store_f32(v_out, o, vr);
      }
    }
  }
  // each head: the common max, the partials' weights w_s [G][live] (in the
  // ring, after their (m, d) pairs md_s), the denominator
  float* w_s = reinterpret_cast<float*>(ring);
  float2* md_s = reinterpret_cast<float2*>(w_s + MAXG * MAX_SPLITS);
  for (int g = warp; g < G; g += THREADS / 32) {
    const float m0 = m0_s[g];
    float mx = m0;
    for (int sp = lane; sp < live; sp += 32) {
      const float2 md = g == warp && sp == lane ? md0 : part_md(sp, g);
      md_s[g * live + sp] = md;
      mx = fmaxf(mx, md.x);
    }
    mx = warp_max(mx);
    float den = 0.f;
    for (int sp = lane; sp < live; sp += 32) {
      const float2 md = md_s[g * live + sp];
      const float w = expf(md.x - mx);
      w_s[g * live + sp] = w;
      den += md.y * w;
    }
    den = warp_sum(den);
    if (lane == 0) {
      const float a0 = expf(m0 - mx);
      a0_s[g] = a0;
      den_s[g] = a0 + den;
    }
  }
  __syncthreads();
  // out: a thread for each 4 elements of a head, the partials' loads in flight together
  T* out = static_cast<T*>(a.out);
  for (int i = tid; i < G * (D / 4); i += THREADS) {
    const int g = i / (D / 4), d0 = (i % (D / 4)) * 4;
    const float a0 = a0_s[g];
    float c[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] = vr_s[d0 + e] * a0;
    int sp = 0;
    if (live > 1 && i == tid) {                          // the prefetched splits
#pragma unroll
      for (int u = 0; u < PRE; ++u)
        if (u < live) {
          const float w = w_s[g * live + u];
          c[0] += pre[u].x * w;
          c[1] += pre[u].y * w;
          c[2] += pre[u].z * w;
          c[3] += pre[u].w * w;
        }
      sp = min(live, PRE);
    }
#pragma unroll 8
    for (; sp < live; ++sp) {
      const float w = w_s[g * live + sp];
      const float4 x = live > 1
          ? __ldcg(reinterpret_cast<const float4*>(a.part_ctx + (pbase + (size_t)sp * G + g) * D + d0))
          : *reinterpret_cast<const float4*>(&pc_s[g][d0]);
      c[0] += x.x * w;
      c[1] += x.y * w;
      c[2] += x.z * w;
      c[3] += x.w * w;
    }
    const float den = den_s[g];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      store_f32(out, ((size_t)b * a.H + h * G + g) * D + d0 + e, c[e] / den);
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

template <typename C>
constexpr CUtensorMapDataType tma_dtype() {
  return std::is_same<C, float>::value           ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
         : std::is_same<C, __nv_bfloat16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                 : CU_TENSOR_MAP_DATA_TYPE_UINT8;
}

// kc / vc: the layer [B, S, KV*D] of the cache dtype
template <int D, typename T, typename C, bool ROPE>
cudaError_t launch_attn(const AttnArgs& a, const void* kc, const void* vc, int B,
                        cudaStream_t stream) {
  using GE = Geo<D, C>;
  const int NS = (a.S + a.R - 1) / a.R;
  if (NS > MAX_SPLITS) return cudaErrorInvalidValue;
  const uint64_t cols = (uint64_t)a.KV * D, rows = (uint64_t)B * a.S;
  const CUtensorMapSwizzle sw = GE::PB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                              : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap kmap, vmap;
  cudaError_t e = tma_map_2d(&kmap, tma_dtype<C>(), kc, cols, rows, cols * GE::ESZ,
                             GE::PB / GE::ESZ, SR, sw);
  if (e == cudaSuccess)
    e = tma_map_2d(&vmap, tma_dtype<C>(), vc, cols, rows, cols * GE::ESZ, GE::PB / GE::ESZ,
                   SR, sw);
  if (e != cudaSuccess) return e;
  constexpr size_t smem = GE::RING + 1024;               // + alignment
  auto kern = attn_decode<D, T, C, ROPE>;
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
template <bool ROPE>
int dispatch(int D, int dtype, int cache, const AttnArgs& a, const void* kc,
             const void* vc, int B, cudaStream_t stream) {
#define BN_CASE(DD, TT, CC)                                                    \
  if (D == DD && dtype == (std::is_same<TT, float>::value ? 0 : 1) &&          \
      cache == cache_code<CC>())                                               \
    return (int)launch_attn<DD, TT, CC, ROPE>(a, kc, vc, B, stream);
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

// the arguments every entry point shares; R must be a power of two >= SR
bool bad_args(int H, int KV, int R) {
  return KV <= 0 || H % KV != 0 || H / KV > MAXG || R < SR || (R & (R - 1)) != 0;
}

}  // namespace

extern "C" {

// dtype (qkv and out): 0 = float32, 1 = bfloat16; cache: 2 = bf16, 3 = f32.
// scale = D**-0.5 rounded to f32 by the caller (as the JAX kernel takes it).
// D must be 64 or 128 and H / KV <= 8; R (cache rows a split) a power of
// two >= 64 with ceil(S / R) <= 256.  part_md: B*KV*NS*G*2 floats,
// part_ctx: B*KV*NS*G*D floats (16-byte aligned), NS = ceil(S / R);
// counters: B*KV ints, zero (every call leaves them zero).
int bn_decode_attention_qkv(const void* qkv, const float* sin_rows,
                            const float* cos_rows, const void* kc,
                            const void* vc, const int* pos, int B, int H,
                            int KV, int D, int S, int R, float scale, void* out,
                            void* k_out, void* v_out, float* part_md,
                            float* part_ctx, int* counters, int dtype, int cache,
                            cudaStream_t stream) {
  if (bad_args(H, KV, R) || cache < 2 || cache > 3) return (int)cudaErrorInvalidValue;
  const int bs = (H + 2 * KV) * D, esz = dtype == 1 ? 2 : 4;
  const char* base = static_cast<const char*>(qkv);
  const AttnArgs a = {qkv, base + (size_t)H * D * esz, base + (size_t)(H + KV) * D * esz,
                      sin_rows, cos_rows, nullptr, nullptr, pos, nullptr, part_md,
                      part_ctx, counters, out, k_out, v_out, nullptr, nullptr,
                      bs, bs, H, KV, S, R, scale};
  return dispatch<true>(D, dtype, cache, a, kc, vc, B, stream);
}

// K7: K2 over a quantized cache (cache: 0 = int8, 1 = fp8 e4m3) with its
// f32 scales ks / vs, the layer's [B, S, KV].  k_out / v_out [B, KV, D]
// receive the new rows' codes, ks_out / vs_out [B, KV] their scales.
int bn_decode_attention_qkv_quant(const void* qkv, const float* sin_rows,
                                  const float* cos_rows, const void* kc,
                                  const void* vc, const float* ks,
                                  const float* vs, const int* pos, int B,
                                  int H, int KV, int D, int S, int R, float scale,
                                  void* out, void* k_out, void* v_out,
                                  float* ks_out, float* vs_out, float* part_md,
                                  float* part_ctx, int* counters, int dtype,
                                  int cache, cudaStream_t stream) {
  if (bad_args(H, KV, R) || cache < 0 || cache > 1) return (int)cudaErrorInvalidValue;
  const int bs = (H + 2 * KV) * D, esz = dtype == 1 ? 2 : 4;
  const char* base = static_cast<const char*>(qkv);
  const AttnArgs a = {qkv, base + (size_t)H * D * esz, base + (size_t)(H + KV) * D * esz,
                      sin_rows, cos_rows, ks, vs, pos, nullptr, part_md, part_ctx,
                      counters, out, k_out, v_out, ks_out, vs_out,
                      bs, bs, H, KV, S, R, scale};
  return dispatch<true>(D, dtype, cache, a, kc, vc, B, stream);
}

// K5 and K8 (and K25, K27): q [B, H, D] (roped), k_new / v_new [B, KV, D],
// all of one dtype (0 = float32, 1 = bfloat16; out has it too); kc / vc the
// layer [B, S, KV*D], bf16 (cache 2) or f32 (cache 3).  wpos null: the caches
// are read only.  wpos [B] (K26): the combine then writes the new rows,
// cast to the cache dtype, at row wpos[b] of kc / vc, dropping a row outside
// [0, S).  R, partials and counters as for bn_decode_attention_qkv.
int bn_decode_attention(const void* q, const void* k_new, const void* v_new,
                        void* kc, void* vc, const int* pos, const int* wpos,
                        int B, int H, int KV, int D, int S, int R, float scale,
                        void* out, float* part_md, float* part_ctx, int* counters,
                        int dtype, int cache, cudaStream_t stream) {
  if (bad_args(H, KV, R) || cache < 2 || cache > 3) return (int)cudaErrorInvalidValue;
  const AttnArgs a = {q, k_new, v_new, nullptr, nullptr, nullptr, nullptr, pos, wpos,
                      part_md, part_ctx, counters, out,
                      wpos != nullptr ? kc : nullptr, wpos != nullptr ? vc : nullptr,
                      nullptr, nullptr, H * D, KV * D, H, KV, S, R, scale};
  return dispatch<false>(D, dtype, cache, a, kc, vc, B, stream);
}

// K9: K8 over a quantized cache (cache: 0 = int8, 1 = fp8 e4m3) with the
// layer's f32 scales ks / vs [B, S, KV]; k_new / v_new are the new rows
// after the quantization round trip.
int bn_decode_attention_quant(const void* q, const void* k_new,
                              const void* v_new, const void* kc,
                              const void* vc, const float* ks, const float* vs,
                              const int* pos, int B, int H, int KV, int D,
                              int S, int R, float scale, void* out, float* part_md,
                              float* part_ctx, int* counters, int dtype, int cache,
                              cudaStream_t stream) {
  if (bad_args(H, KV, R) || cache < 0 || cache > 1) return (int)cudaErrorInvalidValue;
  const AttnArgs a = {q, k_new, v_new, nullptr, nullptr, ks, vs, pos, nullptr,
                      part_md, part_ctx, counters, out, nullptr, nullptr, nullptr,
                      nullptr, H * D, KV * D, H, KV, S, R, scale};
  return dispatch<false>(D, dtype, cache, a, kc, vc, B, stream);
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
