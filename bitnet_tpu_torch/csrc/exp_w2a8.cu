// The W2A8 experiment's probes for Hopper (sm_90a): four probes of the facts
// K1's word layout rests on.
//
// Replaces five of the six Pallas sites of experiments/exp_w2a8.py.  The
// probes ask the TPU questions of the card, not in Mosaic's form:
//   K28 bn_probe_bytes  <- p1_bitcast_order (:55): the byte order of an int32
//       word read as 4 int8, as dp4a reads its operands: out row 4s+j of
//       column c = __dp4a(word[s, c], 1 << 8j, 0), byte j times one.
//   K29 bn_probe_dot    <- p2_int8_dot (:75, :84): int8 x int8 -> int32 through
//       __dp4a (unit 0) and through the int8 tensor-core MMA
//       mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (unit 1), whose
//       operand registers each hold 4 int8 of consecutive k, lowest byte
//       first.  Staged through shared memory (below).
//   K30 bn_probe_bf16   <- p3_i8_to_bf16 (:99): the bytes of the words as int8
//       (the register's bytes in memory order), converted to bf16.
//   K31 bn_probe_unpack <- p4_unpack_chain (:146): for plane p of word s,
//       t = (w >> 2p) & 0x03030303, t + ((t >> 1) & 0x01010101): the biased
//       codes {0, 1, 3, 4}, byte j to row p*4R + 4s + j (the JAX chain's
//       plane-major concatenation; at R = 16 words it is K1's 256-row tile).
// Each is one small launch: bound by launch latency, not by bytes or
// operations.
//
// The sixth site, K32 w2a8_matmul (:201), is the per-tensor-scale mode of
// K4's two launches (ternary_matmul.cu bn_w2a8_matmul).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

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

// ---------------------------------------------------------------------------
// K29: int8 a [M, K] x int8 b [K, N] -> int32 [M, N], both row-major.  At the
// probe's shapes the call is bound by latency, not by bytes or operations:
// a warp that read its fragments from global memory step by step would make
// eight (mma) or 64 (dp4a) dependent trips there.  A block of 8 warps owns a
// 16 x 64 output tile
// and stages its A rows and B columns for a slab of 256 K in shared memory
// at once: each thread issues all its loads (16-byte vectors where the row
// strides and the pointers allow, 4-byte or single bytes otherwise) before
// it waits for any.  B is transposed on the way in, so that shared memory
// holds it K-major (bs[n][k]): an mma.sync B fragment, or a dp4a operand, is
// one 32-bit load, not four byte gathers.  One __syncthreads, then every
// step runs out of shared memory; a K past one slab is walked slab by slab
// with the next slab's loads in flight (held in registers) while this one's
// steps run.  Rows are DOT_LD bytes apart (68 ints, 4 mod 32 banks), so the
// fragment loads (row g, int t) touch 32 distinct banks.  mma.sync stays
// unit 1's instruction: the call is bound by latency, and wgmma's 64-row
// tile would buy no rate that the probe can use.
//   unit 1: warp w owns columns 8w .. 8w+7 of the tile, one m16n8k32 a
//   32-K step; unit 0: thread t owns column t % 64 and rows 4(t / 64) ..
//   +3, four dp4a a 16-K step from 16-byte shared-memory loads.
// ---------------------------------------------------------------------------
constexpr int DOT_BM = 16, DOT_BN = 64, DOT_KS = 256;
constexpr int DOT_THREADS = 256;
constexpr int DOT_LD = DOT_KS + 16;            // bytes a staged row
constexpr int DOT_LDI = DOT_LD / 4;

__device__ __forceinline__ void mma_s8(int (&d)[4], const int (&a)[4], int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a chunk of V bytes of a row (V = 16, 4 or 1) as 32-bit words, zero if !ok
template <int V>
struct Chunk {
  static constexpr int W = V >= 4 ? V / 4 : 1;
  uint32_t w[W];
  __device__ __forceinline__ void load(const int8_t* p, bool ok) {
    if constexpr (V == 16) {
      const uint4 v = ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0, 0, 0, 0);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (V == 4) {
      w[0] = ok ? *reinterpret_cast<const uint32_t*>(p) : 0u;
    } else {
      w[0] = ok ? static_cast<uint32_t>(static_cast<uint8_t>(*p)) : 0u;
    }
  }
  __device__ __forceinline__ void store(int8_t* p) const {
    if constexpr (V == 16) *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    else if constexpr (V == 4) *reinterpret_cast<uint32_t*>(p) = w[0];
    else *p = static_cast<int8_t>(w[0]);
  }
};

template <int UNIT, int V>
__global__ void __launch_bounds__(DOT_THREADS)
probe_dot(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
          int* __restrict__ out, int M, int K, int N) {
  constexpr int A_PER = DOT_KS / V;                       // chunks a row of A
  constexpr int A_ITEMS = DOT_BM * A_PER / DOT_THREADS;
  constexpr int B_ITEMS = (DOT_KS / 4) * (DOT_BN / V) / DOT_THREADS;
  __shared__ __align__(16) int8_t as[DOT_BM * DOT_LD];   // as[m][k]
  __shared__ __align__(16) int8_t bs[DOT_BN * DOT_LD];   // bs[n][k]
  const int m0 = blockIdx.y * DOT_BM, n0 = blockIdx.x * DOT_BN;
  const int tid = threadIdx.x;
  Chunk<V> ra[A_ITEMS], rb[B_ITEMS][4];

  // the slab at k0: item i of A is row r, bytes c .. c+V-1; item i of B is
  // rows 4kq .. 4kq+3, columns nc .. nc+V-1 (kq fastest over the threads,
  // so the transposed stores are conflict-free)
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_ITEMS; ++i) {
      const int idx = tid + i * DOT_THREADS, r = idx / A_PER, c = (idx % A_PER) * V;
      ra[i].load(a + (size_t)(m0 + r) * K + k0 + c, m0 + r < M && k0 + c < K);
    }
#pragma unroll
    for (int i = 0; i < B_ITEMS; ++i) {
      const int idx = tid + i * DOT_THREADS, kq = idx % (DOT_KS / 4);
      const int nc = (idx / (DOT_KS / 4)) * V;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + 4 * kq + j;
        rb[i][j].load(b + (size_t)k * N + n0 + nc, k < K && n0 + nc < N);
      }
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < A_ITEMS; ++i) {
      const int idx = tid + i * DOT_THREADS;
      ra[i].store(as + (idx / A_PER) * DOT_LD + (idx % A_PER) * V);
    }
    int* bi = reinterpret_cast<int*>(bs);
#pragma unroll
    for (int i = 0; i < B_ITEMS; ++i) {
      const int idx = tid + i * DOT_THREADS, kq = idx % (DOT_KS / 4);
      int* dst = bi + (idx / (DOT_KS / 4)) * V * DOT_LDI + kq;
      if constexpr (V == 1) {
        dst[0] = static_cast<int>(rb[i][0].w[0] | rb[i][1].w[0] << 8 | rb[i][2].w[0] << 16
                                  | rb[i][3].w[0] << 24);
      } else {
#pragma unroll
        for (int q = 0; q < V / 4; ++q) {          // a 4 x 4 byte transpose
          const uint32_t t0 = __byte_perm(rb[i][0].w[q], rb[i][1].w[q], 0x5140);
          const uint32_t t1 = __byte_perm(rb[i][2].w[q], rb[i][3].w[q], 0x5140);
          const uint32_t t2 = __byte_perm(rb[i][0].w[q], rb[i][1].w[q], 0x7362);
          const uint32_t t3 = __byte_perm(rb[i][2].w[q], rb[i][3].w[q], 0x7362);
          dst[(4 * q + 0) * DOT_LDI] = static_cast<int>(__byte_perm(t0, t1, 0x5410));
          dst[(4 * q + 1) * DOT_LDI] = static_cast<int>(__byte_perm(t0, t1, 0x7632));
          dst[(4 * q + 2) * DOT_LDI] = static_cast<int>(__byte_perm(t2, t3, 0x5410));
          dst[(4 * q + 3) * DOT_LDI] = static_cast<int>(__byte_perm(t2, t3, 0x7632));
        }
      }
    }
  };

  const int* ai = reinterpret_cast<const int*>(as);
  const int* bi = reinterpret_cast<const int*>(bs);
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t4 = lane & 3;
  int d[4] = {0, 0, 0, 0};                      // unit 1: the fragment; unit 0: 4 rows
  fetch(0);
  for (int k0 = 0; k0 < K; k0 += DOT_KS) {
    if (k0) __syncthreads();                    // the last slab is read
    stage();
    __syncthreads();
    if (k0 + DOT_KS < K) fetch(k0 + DOT_KS);    // in flight while this slab runs
    const int span = min(DOT_KS, K - k0);
    if constexpr (UNIT == 1) {
      const int* bc = bi + (8 * warp + g) * DOT_LDI + t4;
      for (int kk = 0; kk < span / 4; kk += 8) {
        const int af[4] = {ai[g * DOT_LDI + kk + t4], ai[(g + 8) * DOT_LDI + kk + t4],
                           ai[g * DOT_LDI + kk + 4 + t4],
                           ai[(g + 8) * DOT_LDI + kk + 4 + t4]};
        mma_s8(d, af, bc[kk], bc[kk + 4]);
      }
    } else {
      const int n = tid % DOT_BN, r0 = 4 * (tid / DOT_BN);
      for (int kk = 0; kk < span; kk += 16) {   // the slab's zeros pad K to 16
        const int4 bv = *reinterpret_cast<const int4*>(bs + n * DOT_LD + kk);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int4 av = *reinterpret_cast<const int4*>(as + (r0 + r) * DOT_LD + kk);
          d[r] = __dp4a(av.x, bv.x, d[r]);
          d[r] = __dp4a(av.y, bv.y, d[r]);
          d[r] = __dp4a(av.z, bv.z, d[r]);
          d[r] = __dp4a(av.w, bv.w, d[r]);
        }
      }
    }
  }
  if constexpr (UNIT == 1) {
    const int n = n0 + 8 * warp + 2 * t4;
    if (n < N) {                                // whole warps: N % 8 == 0
      int* o = out + (size_t)(m0 + g) * N + n;
      *reinterpret_cast<int2*>(o) = make_int2(d[0], d[1]);
      *reinterpret_cast<int2*>(o + 8 * (size_t)N) = make_int2(d[2], d[3]);
    }
  } else {
    const int n = n0 + tid % DOT_BN, r0 = m0 + 4 * (tid / DOT_BN);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (r0 + r < M && n < N) out[(size_t)(r0 + r) * N + n] = d[r];
  }
}

template <int UNIT>
void launch_dot(const int8_t* a, const int8_t* b, int* out, int M, int K, int N, int v,
                cudaStream_t stream) {
  const dim3 grid((N + DOT_BN - 1) / DOT_BN, (M + DOT_BM - 1) / DOT_BM);
  if (v == 16) probe_dot<UNIT, 16><<<grid, DOT_THREADS, 0, stream>>>(a, b, out, M, K, N);
  else if (v == 4) probe_dot<UNIT, 4><<<grid, DOT_THREADS, 0, stream>>>(a, b, out, M, K, N);
  else probe_dot<UNIT, 1><<<grid, DOT_THREADS, 0, stream>>>(a, b, out, M, K, N);
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
// (K % 4 == 0), 1 = mma.sync m16n8k32 (M % 16, N % 8, K % 32 == 0).  The
// staging loads 16 bytes at a time where K and N are multiples of 16 and both
// pointers 16-byte aligned, 4 where N % 4 == 0 and both are 4-byte aligned
// (K % 4 == 0 on both units), else single bytes.
int bn_probe_dot(const int8_t* a, const int8_t* b, int* out, int M, int K, int N,
                 int unit, cudaStream_t stream) {
  if (M < 1 || N < 1 || K % 4 != 0
      || (unit == 1 && (M % 16 != 0 || N % 8 != 0 || K % 32 != 0)))
    return (int)cudaErrorInvalidValue;
  const uintptr_t al = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b);
  const int v = K % 16 == 0 && N % 16 == 0 && al % 16 == 0 ? 16
              : N % 4 == 0 && al % 4 == 0 ? 4 : 1;
  if (unit == 0) launch_dot<0>(a, b, out, M, K, N, v, stream);
  else launch_dot<1>(a, b, out, M, K, N, v, stream);
  return (int)cudaGetLastError();
}

const char* bn_exp_w2a8_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
