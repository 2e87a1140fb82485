// The fused W2A8 FFN for Hopper (sm_90a): gate|up GEMV, SiLU(gate) * up,
// per-token per-F-tile int8 requantization, down GEMV.
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
// The f32 sum over tiles runs in tile order from zero, with no atomics, so
// the result is deterministic and equals the plain version wherever the
// integer parts agree.
//
// Four launches under one wrapper and one counter:
//   1. quantize_groups<T>  (one group of Kp a row): xq, sx, sumq
//   2. gateup_gemv<MB>     gate|up over all of K with the SiLU * up
//                          epilogue: act f32 [M, F] (<= 1.8 MB at M = 32,
//                          F = 14336: it stays in the 50 MB L2)
//   3. quantize_groups<float> (n_f groups of bf a row): aq, sa, sq2
//   4. down_gemv<MB, T>    each block owns 32 H columns and walks the F-tiles
//                          in order, applying each tile's scale before adding
//                          its term
// The Pallas kernel does the requantization inside its sequential grid; on
// the card no block sees a whole F-tile of act (the gate|up columns are
// spread over bf/32 blocks), so the per-tile absmax is its own small launch
// between the two GEMVs (launch 3 reads M*F*4 bytes from L2).
//
// What bounds it: the weight bytes.  At the 8B shapes (K = H = 4096,
// F = 14336) the gate|up words are 4096/4 * 28672 = 29.36 MB and the down
// words 14336/4 * 4096 = 14.68 MB: 44.04 MB, 0.0131 ms at 3.35 TB/s; the
// int8 operations (2*M*K*2F + 2*M*F*H = 11.3 G at M = 32) take 0.0057 ms at
// 1979 TOP/s.  Both GEMVs are K1's two-kernel GEMV (w2a8_gemv, 8 warps, 32
// columns a block, 1024 K values a stage, dp4a on the biased planes, int8
// rows broadcast from shared memory), so each word is read once by one
// thread; gate and up words of the same column ride one block.  MB rows
// share a block (MB = 1, 2, 4 or 8; M > 8 runs ceil(M/8) row groups, each
// re-reading the words, from L2 for the later groups when they run
// together).  Simple and right first; not yet fast.

#include "ternary_common.cuh"

namespace {

using namespace bn;

constexpr int STAGE_K = 1024;          // K values a stage (64 word rows)
constexpr int GEMV_THREADS = 256;      // 8 warps

// ---------------------------------------------------------------------------
// Launches 1 and 3: block (g, m) quantizes x[m, g*gw : (g+1)*gw] to int8
// with its own absmax scale; q[m, g*gw + k], s[m*ng + g], sums[m*ng + g].
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(512)
quantize_groups(const T* __restrict__ x, int x_stride, int gw,
                int8_t* __restrict__ q, int q_stride, float* __restrict__ s,
                int* __restrict__ sums) {
  __shared__ float redf[32];
  __shared__ int redi[32];
  const int g = blockIdx.x, m = blockIdx.y, ng = gridDim.x;
  const T* xr = x + (size_t)m * x_stride + (size_t)g * gw;
  int8_t* qr = q + (size_t)m * q_stride + (size_t)g * gw;
  float amax = 0.f;
  for (int k = threadIdx.x; k < gw; k += blockDim.x) amax = fmaxf(amax, fabsf(load_f32(xr, k)));
  amax = block_reduce(amax, redf, true);
  const float sx = fmaxf(amax, 1e-8f) / 127.f;
  int sq = 0;
  for (int k = threadIdx.x; k < gw; k += blockDim.x) {
    const float v = fminf(fmaxf(rintf(load_f32(xr, k) / sx), -127.f), 127.f);
    qr[k] = (int8_t)v;
    sq += (int)v;
  }
  sq = block_reduce(sq, redi, false);
  if (threadIdx.x == 0) {
    s[(size_t)m * ng + g] = sx;
    sums[(size_t)m * ng + g] = sq;
  }
}

// Stage [k0, k0 + kc) of MB int8 rows into shared memory (as ints); rows
// past M are zeros.
template <int MB>
__device__ __forceinline__ void load_rows(int (*xs)[STAGE_K / 4], const int8_t* q,
                                          int ld, int m0, int M, int k0, int kc) {
  const int kc4 = kc / 4;
  for (int i = threadIdx.x; i < MB * kc4; i += blockDim.x) {
    const int mm = i / kc4, kk = i % kc4, m = m0 + mm;
    xs[mm][kk] = m < M ? reinterpret_cast<const int*>(q + (size_t)m * ld + k0)[kk] : 0;
  }
}

// ---------------------------------------------------------------------------
// Launch 2: gate|up GEMV + SiLU(gate) * up.  Block = 32 gate columns n (a
// lane each) and their up columns F + n, rows m0 .. m0 + MB - 1.
// ---------------------------------------------------------------------------
template <int MB>
__global__ void __launch_bounds__(GEMV_THREADS)
gateup_gemv(const int8_t* __restrict__ xq, int M, int Kp,
            const int* __restrict__ words, int F, const int* __restrict__ sumq,
            const float* __restrict__ sx, const float* __restrict__ scale,
            float* __restrict__ act) {
  __shared__ int xs[MB][STAGE_K / 4];
  __shared__ int red[2][MB][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * 32 + lane;
  const int m0 = blockIdx.y * MB;
  const size_t ld = 2 * (size_t)F;                  // words a word row
  for (int i = threadIdx.x; i < 2 * MB * 32; i += blockDim.x) (&red[0][0][0])[i] = 0;
  int ag[MB], au[MB];
#pragma unroll
  for (int mm = 0; mm < MB; ++mm) ag[mm] = au[mm] = 0;

  for (int k0 = 0; k0 < Kp; k0 += STAGE_K) {
    const int kc = min(STAGE_K, Kp - k0);            // multiple of 256
    const int rows = kc / 16;
    int wg[8], wu[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = warp + 8 * i;
      const size_t at = (size_t)(k0 / 16 + r) * ld + n;
      wg[i] = r < rows ? __ldg(words + at) : 0;
      wu[i] = r < rows ? __ldg(words + at + F) : 0;
    }
    __syncthreads();                                 // xs free to refill
    load_rows<MB>(xs, xq, Kp, m0, M, k0, kc);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = warp + 8 * i;
      if (r < rows) {
        const int base = (r / 16) * (KT / 4) + (r % 16);   // int index in the stage
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int cg = biased_plane(wg[i], p), cu = biased_plane(wu[i], p);
#pragma unroll
          for (int mm = 0; mm < MB; ++mm) {
            const int a = xs[mm][base + p * 16];
            ag[mm] = __dp4a(cg, a, ag[mm]);
            au[mm] = __dp4a(cu, a, au[mm]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int mm = 0; mm < MB; ++mm) {
    atomicAdd(&red[0][mm][lane], ag[mm]);           // int: exact in any order
    atomicAdd(&red[1][mm][lane], au[mm]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < MB * 32; i += blockDim.x) {
    const int mm = i / 32, m = m0 + mm, nc = blockIdx.x * 32 + (i % 32);
    if (m < M) {
      const float g = __fmul_rn(__fmul_rn((float)(red[0][mm][i % 32] - 2 * sumq[m]), sx[m]),
                                scale[nc]);
      const float u = __fmul_rn(__fmul_rn((float)(red[1][mm][i % 32] - 2 * sumq[m]), sx[m]),
                                scale[F + nc]);
      const float sig = 1.f / (1.f + expf(-g));
      act[(size_t)m * F + nc] = __fmul_rn(__fmul_rn(g, sig), u);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch 4: down GEMV over the requantized tiles.  Block = 32 H columns,
// rows m0 .. m0 + MB - 1; the F-tiles are walked in order, each tile's exact
// int32 dot scaled by that tile's sa and added to an f32 sum that starts at 0.
// ---------------------------------------------------------------------------
template <int MB, typename T>
__global__ void __launch_bounds__(GEMV_THREADS)
down_gemv(const int8_t* __restrict__ aq, int M, int F, int bf,
          const int* __restrict__ words, int Hp, const int* __restrict__ sq2,
          const float* __restrict__ sa, const float* __restrict__ scale,
          T* __restrict__ out, int N) {
  __shared__ int xs[MB][STAGE_K / 4];
  __shared__ int red[MB][32];
  __shared__ float yacc[MB][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = blockIdx.x * 32 + lane;
  const int m0 = blockIdx.y * MB;
  const int nf = F / bf;
  for (int i = threadIdx.x; i < MB * 32; i += blockDim.x) {
    red[i / 32][i % 32] = 0;
    yacc[i / 32][i % 32] = 0.f;
  }
  for (int f = 0; f < nf; ++f) {
    int acc[MB];
#pragma unroll
    for (int mm = 0; mm < MB; ++mm) acc[mm] = 0;
    for (int k0 = f * bf; k0 < (f + 1) * bf; k0 += STAGE_K) {
      const int kc = min(STAGE_K, (f + 1) * bf - k0);   // multiple of 256
      const int rows = kc / 16;
      int wv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = warp + 8 * i;
        wv[i] = r < rows ? __ldg(words + (size_t)(k0 / 16 + r) * Hp + n) : 0;
      }
      __syncthreads();                               // xs, red free to reuse
      load_rows<MB>(xs, aq, F, m0, M, k0, kc);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = warp + 8 * i;
        if (r < rows) {
          const int base = (r / 16) * (KT / 4) + (r % 16);
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const int c = biased_plane(wv[i], p);
#pragma unroll
            for (int mm = 0; mm < MB; ++mm) acc[mm] = __dp4a(c, xs[mm][base + p * 16], acc[mm]);
          }
        }
      }
    }
#pragma unroll
    for (int mm = 0; mm < MB; ++mm) atomicAdd(&red[mm][lane], acc[mm]);
    __syncthreads();
    for (int i = threadIdx.x; i < MB * 32; i += blockDim.x) {
      const int mm = i / 32, m = m0 + mm, c = i % 32;
      if (m < M) {
        const size_t t = (size_t)m * nf + f;
        const float term = __fmul_rn(__fmul_rn((float)(red[mm][c] - 2 * sq2[t]), sa[t]),
                                     scale[blockIdx.x * 32 + c]);
        yacc[mm][c] = __fadd_rn(yacc[mm][c], term);
      }
      red[mm][c] = 0;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < MB * 32; i += blockDim.x) {
    const int mm = i / 32, m = m0 + mm, nc = blockIdx.x * 32 + (i % 32);
    if (m < M && nc < N) store_f32(out, (size_t)m * N + nc, yacc[mm][i % 32]);
  }
}

template <int MB, typename T>
cudaError_t launch_gemvs(const int8_t* xq, int M, int Kp, const int* gu_words, int F,
                         const int* sumq, const float* sx, const float* gu_scale,
                         float* act, int8_t* aq, float* sa, int* sq2, int bf,
                         const int* d_words, int Hp, const float* d_scale, T* out,
                         int N, cudaStream_t stream) {
  const int groups = (M + MB - 1) / MB;
  gateup_gemv<MB><<<dim3(F / 32, groups), GEMV_THREADS, 0, stream>>>(
      xq, M, Kp, gu_words, F, sumq, sx, gu_scale, act);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  quantize_groups<float><<<dim3(F / bf, M), 512, 0, stream>>>(act, F, bf, aq, F, sa, sq2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  down_gemv<MB, T><<<dim3(Hp / 32, groups), GEMV_THREADS, 0, stream>>>(
      aq, M, F, bf, d_words, Hp, sq2, sa, d_scale, out, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ffn(const void* x, int M, int Kp, const int* gu_words, int F,
                       const float* gu_scale, const int* d_words, int Hp,
                       const float* d_scale, void* out, int N, int bf, int8_t* xq,
                       float* sx, int* sumq, float* act, int8_t* aq, float* sa,
                       int* sq2, cudaStream_t stream) {
  quantize_groups<T><<<dim3(1, M), 512, 0, stream>>>(static_cast<const T*>(x), Kp, Kp,
                                                     xq, Kp, sx, sumq);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  T* o = static_cast<T*>(out);
#define BN_GEMVS(MBV)                                                             \
  return launch_gemvs<MBV, T>(xq, M, Kp, gu_words, F, sumq, sx, gu_scale, act, aq, \
                              sa, sq2, bf, d_words, Hp, d_scale, o, N, stream)
  if (M == 1) BN_GEMVS(1);
  if (M == 2) BN_GEMVS(2);
  if (M <= 4) BN_GEMVS(4);
  BN_GEMVS(8);
#undef BN_GEMVS
}

}  // namespace

extern "C" {

// x [M, Kp] (zero-padded to Kp), dtype 0 = float32, 1 = bfloat16 (x and out
// share it); gu_words [Kp/16, 2F], gu_scale f32 [2F]; d_words [F/16, Hp],
// d_scale f32 [Hp]; out [M, N].  F % bf == 0, bf % 256 == 0, Hp % 32 == 0,
// 1 <= M <= 32.  Scratch: xq int8 [M, Kp], sx f32 [M], sumq int32 [M], act
// f32 [M, F], aq int8 [M, F], sa f32 [M, F/bf], sq2 int32 [M, F/bf].
// Returns cudaGetLastError() after the launches.
int bn_ffn_w2a8(const void* x, int M, int Kp, const int* gu_words, int F,
                const float* gu_scale, const int* d_words, int Hp,
                const float* d_scale, void* out, int N, int bf, int8_t* xq,
                float* sx, int* sumq, float* act, int8_t* aq, float* sa, int* sq2,
                int dtype, cudaStream_t stream) {
  if (M < 1 || M > 32 || bf <= 0 || bf % KT || F % bf || Kp % KT || Hp % 32)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return (int)launch_ffn<__nv_bfloat16>(x, M, Kp, gu_words, F, gu_scale, d_words,
                                          Hp, d_scale, out, N, bf, xq, sx, sumq,
                                          act, aq, sa, sq2, stream);
  return (int)launch_ffn<float>(x, M, Kp, gu_words, F, gu_scale, d_words, Hp,
                                d_scale, out, N, bf, xq, sx, sumq, act, aq, sa,
                                sq2, stream);
}

const char* bn_ffn_fused_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
