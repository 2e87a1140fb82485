// The W2A8 experiment's kernels for Hopper (sm_90a): four probes of the
// facts K1's word layout rests on, and the W2A8 prototype GEMM.
//
// Replaces the six Pallas sites of experiments/exp_w2a8.py.  The probes ask
// the TPU questions of the card, not in Mosaic's form:
//   K28 bn_probe_bytes  <- p1_bitcast_order (:55): the byte order of an int32
//       word read as 4 int8, as dp4a reads its operands: out row 4s+j of
//       column c = __dp4a(word[s, c], 1 << 8j, 0), byte j times one.
//   K29 bn_probe_dot    <- p2_int8_dot (:75, :84): int8 x int8 -> int32 through
//       __dp4a (unit 0) and through the int8 tensor-core MMA
//       mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (unit 1), whose
//       operand registers each hold 4 int8 of consecutive k, lowest byte
//       first.
//   K30 bn_probe_bf16   <- p3_i8_to_bf16 (:99): the bytes of the words as int8
//       (the register's bytes in memory order), converted to bf16.
//   K31 bn_probe_unpack <- p4_unpack_chain (:146): for plane p of word s,
//       t = (w >> 2p) & 0x03030303, t + ((t >> 1) & 0x01010101): the biased
//       codes {0, 1, 3, 4}, byte j to row p*4R + 4s + j (the JAX chain's
//       plane-major concatenation; at R = 16 words it is K1's 256-row tile).
// Each is one small launch: launch-bound, not bound by bytes or operations.
//
//   K32 bn_w2a8_quantize + bn_w2a8_mma <- w2a8_matmul (:181, pallas_call
//       :201, body _w2a8_kernel :158): y = ((xq . c) - 2 sumq) * (sx * scale)
//       in f32, cast to bf16, where xq are x's per-row int8 codes (sx =
//       max(absmax, 1e-8) / 127 by IEEE division, q = clip(rint(x / sx),
//       +-127), sumq their sum), c the biased codes of the words [K/16, N]
//       and scale one per-tensor f32.  The TPU kernel runs the MXU int8 dot
//       over 16-row blocks; this runs mma.sync m16n8k32 s8 over 16-row tiles
//       (rows zero-padded to 16, never written out).  A warp owns 8 columns
//       and walks K a 256-row tile at a time: each thread loads 4 words of
//       its column (word rows 4*tid .. 4*tid+3 of the tile), and with K rows
//       taken in the order the word layout gives, a B-fragment register IS
//       one plane's biased bytes of one word: MMA step (wi, ph) takes planes
//       2ph and 2ph+1 of word 4*tid+wi as b0 and b1, whose k rows are
//       128ph + 16tid + 4wi + j and 64 more, so the A fragment reads the four
//       int8 of x at those rows with one 4-byte load each.  Exact int32 sums;
//       the epilogue is the prototype's (the product sx * scale in f32 before
//       it multiplies).  Bound: the words (K*N/4 bytes), 2.64 us at K = 2560,
//       N = 13824 on 3.35 TB/s; each warp re-reads x's tile from L1.  A simple
//       first form: no TMA, no wgmma, one row tile per block row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int MMA_WARPS = 4;   // warps a block in bn_w2a8_mma, 8 columns each

// the four bytes of a register as int8, in the order memory holds them
__device__ __forceinline__ void as_bytes(int w, int8_t (&v)[4]) { memcpy(v, &w, 4); }

__device__ __forceinline__ int biased_plane(int w, int p) {
  const int t = (w >> (2 * p)) & 0x03030303;
  return t + ((t >> 1) & 0x01010101);
}

__global__ void probe_bytes(const int* __restrict__ words, int8_t* __restrict__ out,
                            int R, int C) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R * C) return;
  const int s = i / C, c = i % C, w = words[i];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    out[(size_t)(4 * s + j) * C + c] = static_cast<int8_t>(__dp4a(w, 1 << (8 * j), 0));
}

__global__ void probe_bf16(const int* __restrict__ words,
                           __nv_bfloat16* __restrict__ out, int R, int C) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R * C) return;
  const int s = i / C, c = i % C;
  int8_t v[4];
  as_bytes(words[i], v);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    out[(size_t)(4 * s + j) * C + c] = __int2bfloat16_rn(static_cast<int>(v[j]));
}

__global__ void probe_unpack(const int* __restrict__ words, int8_t* __restrict__ out,
                             int R, int C) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R * C) return;
  const int s = i / C, c = i % C, w = words[i];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    int8_t v[4];
    as_bytes(biased_plane(w, p), v);
#pragma unroll
    for (int j = 0; j < 4; ++j) out[((size_t)p * 4 * R + 4 * s + j) * C + c] = v[j];
  }
}

// int8 [M, K] x int8 [K, N] -> int32 [M, N], both row-major; a thread per
// output, 4 k a dp4a (K % 4 == 0)
__global__ void dot_dp4a(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                         int* __restrict__ out, int M, int K, int N) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M * N) return;
  const int m = i / N, n = i % N;
  int acc = 0;
  for (int k = 0; k < K; k += 4) {
    const int aw = *reinterpret_cast<const int*>(a + (size_t)m * K + k);
    int bw = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bw |= (static_cast<int>(static_cast<uint8_t>(b[(size_t)(k + j) * N + n]))) << (8 * j);
    acc = __dp4a(aw, bw, acc);
  }
  out[i] = acc;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const int (&a)[4], int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the same product, a warp per 16 x 8 output tile (M % 16, N % 8, K % 32):
// A fragment a0 / a1 rows g / g+8 at k = 4 tid .. +3, a2 / a3 the same 16 k
// further; B fragment b0 / b1 k = 4 tid .. +3 and 16 further of column g,
// gathered from the row-major B lowest k in the lowest byte
__global__ void dot_mma(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
                        int* __restrict__ out, int M, int K, int N) {
  const int lane = threadIdx.x, g = lane >> 2, tid = lane & 3;
  const int n0 = blockIdx.x * 8, m0 = blockIdx.y * 16;
  int d[4] = {0, 0, 0, 0};
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int8_t* ar = a + (size_t)(m0 + g) * K + k0 + 4 * tid;
    const int af[4] = {*reinterpret_cast<const int*>(ar),
                       *reinterpret_cast<const int*>(ar + 8 * (size_t)K),
                       *reinterpret_cast<const int*>(ar + 16),
                       *reinterpret_cast<const int*>(ar + 8 * (size_t)K + 16)};
    int bf[2] = {0, 0};
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bf[h] |= static_cast<int>(static_cast<uint8_t>(
                     b[(size_t)(k0 + 16 * h + 4 * tid + j) * N + n0 + g])) << (8 * j);
    mma_s8(d, af, bf[0], bf[1]);
  }
  const size_t o = (size_t)(m0 + g) * N + n0 + 2 * tid;
  out[o] = d[0];
  out[o + 1] = d[1];
  out[o + 8 * (size_t)N] = d[2];
  out[o + 8 * (size_t)N + 1] = d[3];
}

__device__ __forceinline__ float load_x(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_x(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// K32 pass 1: a block per row of the padded Mp; rows >= M get zero codes,
// sumq 0 and sx 1 (the prototype's padding)
template <typename T>
__global__ void __launch_bounds__(256)
w2a8_quantize(const T* __restrict__ x, int M, int K, int8_t* __restrict__ xq,
              float* __restrict__ sx_out, int* __restrict__ sumq_out) {
  const int m = blockIdx.x;
  int8_t* q = xq + (size_t)m * K;
  if (m >= M) {
    for (int k = threadIdx.x; k < K; k += blockDim.x) q[k] = 0;
    if (threadIdx.x == 0) {
      sx_out[m] = 1.f;
      sumq_out[m] = 0;
    }
    return;
  }
  __shared__ float red_f[8];
  __shared__ int red_i[8];
  __shared__ float sx_s;
  const T* xr = x + (size_t)m * K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float am = 0.f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) am = fmaxf(am, fabsf(load_x(xr, k)));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) am = fmaxf(am, __shfl_xor_sync(0xffffffffu, am, o));
  if (lane == 0) red_f[warp] = am;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < 8; ++w) t = fmaxf(t, red_f[w]);
    sx_s = __fdiv_rn(fmaxf(t, 1e-8f), 127.f);
    sx_out[m] = sx_s;
  }
  __syncthreads();
  const float sx = sx_s;
  int sum = 0;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int v = max(-127, min(127, __float2int_rn(__fdiv_rn(load_x(xr, k), sx))));
    q[k] = static_cast<int8_t>(v);
    sum += v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (lane == 0) red_i[warp] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t = 0;
    for (int w = 0; w < 8; ++w) t += red_i[w];
    sumq_out[m] = t;
  }
}

// K32 pass 2: grid (ceil(N / (8 * MMA_WARPS)), Mp / 16); warp w of block x
// owns columns n0 = (x * MMA_WARPS + w) * 8 .. +7 of row tile m0.
__global__ void __launch_bounds__(MMA_WARPS * 32)
w2a8_mma(const int8_t* __restrict__ xq, const int* __restrict__ sumq,
         const float* __restrict__ sx, const int* __restrict__ words, float scale,
         int M, int K, int N, __nv_bfloat16* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tid = lane & 3;
  const int n0 = (blockIdx.x * MMA_WARPS + warp) * 8, m0 = blockIdx.y * 16;
  if (n0 >= N) return;                           // whole warps only
  const int8_t* x0 = xq + (size_t)(m0 + g) * K + 16 * tid;
  const int8_t* x1 = x0 + 8 * (size_t)K;
  const int* wcol = words + (size_t)(4 * tid) * N + n0 + g;
  int d[4] = {0, 0, 0, 0};
  for (int t = 0; t < K / 256; ++t) {
    int w[4];
#pragma unroll
    for (int wi = 0; wi < 4; ++wi) w[wi] = wcol[((size_t)t * 16 + wi) * N];
#pragma unroll
    for (int wi = 0; wi < 4; ++wi)
#pragma unroll
      for (int ph = 0; ph < 2; ++ph) {
        const int k = t * 256 + 128 * ph + 4 * wi;
        const int af[4] = {*reinterpret_cast<const int*>(x0 + k),
                           *reinterpret_cast<const int*>(x1 + k),
                           *reinterpret_cast<const int*>(x0 + k + 64),
                           *reinterpret_cast<const int*>(x1 + k + 64)};
        mma_s8(d, af, biased_plane(w[wi], 2 * ph), biased_plane(w[wi], 2 * ph + 1));
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int m = m0 + g + 8 * r;
    if (m >= M) continue;                        // the padding never leaves
    const float s = __fmul_rn(sx[m], scale);
    const int corr = 2 * sumq[m];
#pragma unroll
    for (int e = 0; e < 2; ++e)
      out[(size_t)m * N + n0 + 2 * tid + e] =
          __float2bfloat16_rn(__fmul_rn(__int2float_rn(d[2 * r + e] - corr), s));
  }
}

int grid1(int n) { return (n + 255) / 256; }

}  // namespace

extern "C" {

// K28, K30, K31: words [R, C] int32; out [4R, C] int8 / [4R, C] bf16 /
// [16R, C] int8.
int bn_probe_bytes(const int* words, int8_t* out, int R, int C, cudaStream_t stream) {
  probe_bytes<<<grid1(R * C), 256, 0, stream>>>(words, out, R, C);
  return (int)cudaGetLastError();
}

int bn_probe_bf16(const int* words, void* out, int R, int C, cudaStream_t stream) {
  probe_bf16<<<grid1(R * C), 256, 0, stream>>>(words, static_cast<__nv_bfloat16*>(out),
                                               R, C);
  return (int)cudaGetLastError();
}

int bn_probe_unpack(const int* words, int8_t* out, int R, int C, cudaStream_t stream) {
  probe_unpack<<<grid1(R * C), 256, 0, stream>>>(words, out, R, C);
  return (int)cudaGetLastError();
}

// K29: a [M, K] int8 x b [K, N] int8 -> out [M, N] int32, unit 0 = dp4a
// (K % 4 == 0), 1 = mma.sync m16n8k32 (M % 16, N % 8, K % 32 == 0).
int bn_probe_dot(const int8_t* a, const int8_t* b, int* out, int M, int K, int N,
                 int unit, cudaStream_t stream) {
  if (unit == 0) {
    if (K % 4 != 0) return (int)cudaErrorInvalidValue;
    dot_dp4a<<<grid1(M * N), 256, 0, stream>>>(a, b, out, M, K, N);
  } else {
    if (M % 16 != 0 || N % 8 != 0 || K % 32 != 0) return (int)cudaErrorInvalidValue;
    dot_mma<<<dim3(N / 8, M / 16), 32, 0, stream>>>(a, b, out, M, K, N);
  }
  return (int)cudaGetLastError();
}

// K32 pass 1: x [M, K] (dtype 0 = float32, 1 = bfloat16) -> xq [Mp, K] int8,
// sx [Mp] f32, sumq [Mp] int32.
int bn_w2a8_quantize(const void* x, int dtype, int M, int Mp, int K, int8_t* xq,
                     float* sx, int* sumq, cudaStream_t stream) {
  if (dtype == 0)
    w2a8_quantize<float><<<Mp, 256, 0, stream>>>(static_cast<const float*>(x), M, K,
                                                  xq, sx, sumq);
  else
    w2a8_quantize<__nv_bfloat16><<<Mp, 256, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), M, K, xq, sx, sumq);
  return (int)cudaGetLastError();
}

// K32 pass 2: words [K/16, N] int32 (K % 256 == 0, N % 8 == 0), Mp % 16 == 0;
// out [M, N] bf16.
int bn_w2a8_mma(const int8_t* xq, const int* sumq, const float* sx, const int* words,
                float scale, int Mp, int M, int K, int N, void* out,
                cudaStream_t stream) {
  if (K % 256 != 0 || N % 8 != 0 || Mp % 16 != 0) return (int)cudaErrorInvalidValue;
  const int cols = 8 * MMA_WARPS;
  w2a8_mma<<<dim3((N + cols - 1) / cols, Mp / 16), MMA_WARPS * 32, 0, stream>>>(
      xq, sumq, sx, words, scale, M, K, N, static_cast<__nv_bfloat16*>(out));
  return (int)cudaGetLastError();
}

const char* bn_exp_w2a8_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
