// Ternary matmuls for Hopper (sm_90a): int8 or bf16 activations x 2-bit codes.
//
// Replaces these Pallas kernels of bitnet_tpu/ops/ternary_matmul.py:
//   K1 bn_w2a8_normed
//                      <- ternary_matmul_stacked (:316, pallas_call :375),
//                         body _qk256_w2a8_normed_kernel (:201): decode, M <= 64;
//                         also the unstacked w2a8_normed site of
//                         _ternary_matmul_2d (pallas_call :1073)
//   K4 bn_w2a8_gemm    <- ternary_matmul_stacked_prefill (:417, pallas_call
//                         :464), body _qk256_w2a8_kernel (:173): prefill GEMM;
//                         also its unstacked site in _ternary_matmul_2d (:1177)
//   K32 bn_w2a8_matmul <- experiments/exp_w2a8.py w2a8_matmul (:181, pallas_call
//                         :201): K4's two launches with one scale for the
//                         tensor (below)
//   K11 bn_tl_w2a8_normed <- ternary_matmul_stacked_tl_w2a8 (:890, pallas_call
//                         :960), body _tl_w2a8_fused_kernel (:753): K1's
//                         decode form with a scale a 32-row block (below)
// K6, the bf16 qk256 body of the same site (bitnet_tpu/ops/ternary_matmul.py:1177,
// _qk256_kernel), is a column-scale mode of K10's two forms in
// ternary_matmul_tl.cu.
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
//  - K1 (M = B <= 64) is bound by the weight bytes (Kp*Np/4 per call).  At
//    M <= 2 (decode at B <= 2, the main path) it is one launch,
//    w2a8_decode: each word read once, by TMA, into a ring per block; the
//    row preamble (SwiGLU, RMSNorm, absmax int8 quantization, row sums),
//    which needs the whole row before the dot, recomputed by every block
//    while its words are in flight; dp4a from shared memory.  The launch is
//    a programmatic dependent: its words stream in before the launch before
//    it has ended.  At M = 3..64 (pools) it is the row kernel, then K4's GEMM
//    below with the residual in its epilogue: every row in one block, each
//    word read once a call.
//  - K11 (bitnet32 / TL weights, M = B <= 2) is bound by the bytes of its
//    words and f32 block scales (half the words' bytes again): one launch
//    of w2a8_decode in its block-scale mode, the scales streamed by TMA
//    beside the words, the same preamble (so its int8 rows are K1's bit for
//    bit), each 32-row block's int32 partial exact before its scale.
//  - K4 (prefill, M = B*T rows, 8 to 16384 and more) is bound by int8
//    operations at M >= 128 and by the weight bytes below.  The product runs
//    on wgmma (the only way to the card's int8 rate), transposed so that the
//    ternary weights are its register-fed A operand: a thread reads each of
//    its words once a K tile and decodes all four planes from it (a few
//    integer ops a register, next to the asynchronous wgmma), and the tokens
//    are wgmma's N, so a prefill of 8 rows fills an 8-wide tile rather than
//    a 64-row one.  The int8 rows and the words arrive by TMA (128-byte
//    swizzle for the rows, rows past M zero-filled), in a ring of stages
//    under mbarriers fed by a producer warpgroup.  Where the column blocks
//    leave SMs idle, K is split over a thread block cluster and the int32
//    partials are added through distributed shared memory.  The row
//    quantization (the K1 preamble's kernel, without norm or SwiGLU) is the
//    first of the call's two launches; the GEMM is its programmatic
//    dependent.  On the H100 the GEMM runs at 25-46 % of the int8 peak
//    and the quantization adds 11-59 % to its time (PERF.md,
//    PR 10): at M = 512 each block has one tile of output, so the first
//    tile's latency and the epilogue are not hidden, and in the main loop
//    shared memory carries the int8 rows twice a tile (the TMA writes, then
//    each column half's wgmmas read them) beside the words.
// The integer accumulation is exact (|acc| <= 4*127*Kp < 2^31), so the
// results do not depend on the tiling; the float epilogue uses _rn
// intrinsics so it is never contracted into an FMA and rounds exactly as
// the plain PyTorch version does.

#include <cooperative_groups.h>
#include <cuda.h>

#include <algorithm>

#include "ternary_common.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace bn;

// ---------------------------------------------------------------------------
// The row kernel: one block per row m, x is [M, K] (or [M, 2K] when glu).
// K1's rows in its GEMM form (with glu / gamma), K4's and K32's (without):
// the W2A8 rows of the GEMM below.  It lets the GEMM, its programmatic
// dependent, start once its rows are written: the GEMM's first words stream
// in while the row sums are reduced and the launch ends.
//
// The row statistics from outside (stats != nullptr, [M][2] f32: the sum of
// squares of the whole row and the absmax of the whole normed row).  A
// row-parallel linear of the tensor-parallel modes (parallel/sharding.py)
// holds K / tp values of each row: the norm and the int8 scale are the
// whole row's, so the caller reduces both statistics over the model axis
// first and the kernel takes them instead of its own (the mean over kfull
// values), quantizing its slice as the unsharded row is quantized.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void w2a8_quantize_rows(const T* __restrict__ x, int x_stride, int K,
                                   int glu, const float* __restrict__ gamma,
                                   float eps, const float* __restrict__ stats,
                                   int kfull, int8_t* __restrict__ xq,
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
    const float var = stats != nullptr ? stats[2 * m] / (float)kfull
                                       : block_reduce(ss, redf, false) / (float)K;
    const float r = 1.f / sqrtf(var + eps);
    __syncthreads();
    for (int k = threadIdx.x; k < K; k += blockDim.x)
      row[k] = __fmul_rn(__fmul_rn(row[k], r), gamma[k]);
  }
  float amax = 0.f;
  if (stats != nullptr) {                // the whole row's absmax, from outside
    amax = stats[2 * m + 1];
  } else {
    for (int k = threadIdx.x; k < K; k += blockDim.x) amax = fmaxf(amax, fabsf(row[k]));
    amax = block_reduce(amax, redf, true);
  }
  const float sx = fmaxf(amax, 1e-8f) / 127.f;
  int sq = 0;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float q = fminf(fmaxf(rintf(row[k] / sx), -127.f), 127.f);
    xq[(size_t)m * K + k] = (int8_t)q;
    sq += (int)q;
  }
  launch_dependents();                   // the GEMM may start: only the sums are left
  sq = block_reduce(sq, redi, false);
  if (threadIdx.x == 0) {
    sx_out[m] = sx;
    sumq_out[m] = sq;
  }
}

// ---------------------------------------------------------------------------
// K1's decode form, M <= DEC_MAX_M (decode at B <= 2, every qk256 decode
// step): ONE launch, w2a8_decode<MB, T, COLS, EPT, BLOCK>, any K up to
// DEC_MAX_K.  With BLOCK it is K11 (bitnet32 / TL weights with a scale a
// 32-row block, decode at B <= 2): the same kernel in its block-scale mode,
// below.
//
// A block owns COLS output columns (32, 64 or 128; w2a8_decode_plan in
// ops/ternary_matmul.py picks them) and every K tile of them.  K is not
// split: a split over a thread block cluster, its int32 partials added
// through distributed shared memory, was slower on every main-path shape,
// since each rank runs the whole row preamble and the cluster's barriers
// cost more than the words a rank gives up (PERF.md §6, K1's plan sweep).
// Sixteen consumer warps and one producer warp.  The producer copies gamma
// into shared memory (one bulk copy) and streams the block's words into a
// ring of up to DEC_STAGES stages of DEC_STAGE bytes (a stage one TMA box
// of COLS ints x its K tiles' word rows) under full / empty mbarriers, all
// started before anything else and before griddepcontrol.wait: they are the
// layer's, and nothing before K1 writes them.  The launch is a programmatic
// dependent of the one before it, and every thread calls launch_dependents
// at once, so the next launch (the next K1, usually) sets up and streams
// its own words while this one ends; the consumers read x and resid, and
// the block writes anything at all, only after griddepcontrol.wait, because
// the caching allocator may hand K1 a buffer the launch before it still
// reads.  Rows of up to DEC_SHORT_K values hold DEC_EPT_SHORT values a
// consumer thread in registers (two blocks an SM); longer rows (the down
// projections) DEC_EPT_LONG (one block an SM).
//
// The row preamble (silu(gate) * up, RMSNorm, absmax int8 quantization, the
// row sums) needs the whole row before the dot, and Hopper blocks share no
// scratch across the grid: every block computes it from the x row in L2
// (5-57 KB) while its words are in flight, k = threadIdx.x + 512 i over the
// 512 consumer threads, the sums reduced in block_reduce's order (the order
// of the kernels this one replaced, so the rows stayed theirs bit for bit).
// It is a chain of dependent steps (the x loads, the squares'
// reduction, the maxima's, the quantization), so it is latency, not
// operations, that it costs: splitting it over a cluster's ranks, which
// then exchange the squared values and the maxima through distributed
// shared memory, was measured slower (each cluster barrier about 0.7 µs,
// each dependent remote load about 0.2; PERF.md §6, K1's findings).  The int8 rows are
// kept with the four planes' 4-byte groups of a word row side by side, so
// one 16-byte shared load gives a word's four dp4a operands.  Column block
// 0 writes the rows, scales and sums out.
//
// The product: dp4a on the CUDA cores, from shared memory.  Each consumer
// warp takes four word rows of each stage, a lane a column (a warp's word
// reads are 32 consecutive ints: no bank conflict; its int8 reads one
// broadcast 16-byte load a word row), decodes a word's four planes in 13
// integer operations (biased_planes) and runs MB dp4a a plane.  At M <= 2
// an mma.sync m16n8k32 would leave 6/8 of its N idle and needs the same
// decode, and the dot is not what paces a call (PERF.md §6, K1's timeline).
//
// The warps' int32 partials meet in shared memory (atomics, exact), so the
// plan never changes a bit; a consumer thread then applies -2 sumq and the
// f32 epilogue to one output.
//
// The block-scale mode (BLOCK, K11).  y = sx * sum_b s[b, n] * (sum_{k in b}
// q v(c) - 2 sum_{k in b} q), v(c) = c + (c >> 1) (bitnet32's LUT) or c
// (TL), each 32-row block's int32 partial exact before its f32 scale
// multiplies it.  What changes:
//  - The producer streams each stage's block scales with its words: a second
//    TMA box, COLS floats x the stage's 8 TPS scale rows (DEC_SSTAGE, half
//    the words' bytes), on the same full barrier, also before the wait.
//  - The preamble is K1's, unchanged, so the int8 rows, scales and sums
//    are K1's bit for bit.  The 32-row sums of q that the zero point needs
//    are formed in the dot, beside the products, from the same broadcast
//    loads: added to the preamble (one warp reduction a block) they made
//    the chain that paces a call longer (PERF.md §6, K11's findings).
//  - The dot.  Scale block (tile t, plane p, half h) is plane p of word rows
//    8h .. 8h+7 of tile t, so one thread holds all eight: a warp owns whole
//    half tiles of its 32 columns (a unit), not K1's four word rows a
//    stage.  A stage holds 2 TPS x CG = 8 units whatever COLS is, so warps
//    0-7 take one unit of each even stage and warps 8-15 one of each odd
//    stage.  The ring has an even number of slots, so each half reads only
//    its own slots, every phase in order (a parity wait is sound only for a
//    reader that saw every earlier phase).  A unit is eight 16-byte loads
//    of the int8 rows, biased_planes with the codes' bias (mult 3 or 2),
//    4 MB dp4a a word row for the products and 4 MB for the rows' sums,
//    then per plane and row one fma of the block's exact partial and its
//    scale, read from the stage.  Deeper stages (a unit for every warp in
//    each) would halve the ring's depth in the same shared memory.  The
//    column block is K1's plan: the K11 tiles sweep found it the fastest
//    or within 1 % on every main-path shape (PERF.md §6, K11's findings).
//  - The warps' f32 partials meet in shared memory and are added in warp
//    order (no float atomics: two runs give the same bits), then y * sx
//    (+ resid), rounded as K11 always rounded.
// ---------------------------------------------------------------------------
constexpr int DEC_MAX_M = 2;
constexpr int DEC_MAX_K = 14336;              // the 8B down projection
constexpr int DEC_CONSUMERS = 512;            // 16 warps: the preamble's order
constexpr int DEC_WARPS = DEC_CONSUMERS / 32;
constexpr int DEC_THREADS = DEC_CONSUMERS + 32;   // + the producer warp
constexpr int DEC_SHORT_K = 4096;             // rows held 8 values a thread
constexpr int DEC_EPT_SHORT = DEC_SHORT_K / DEC_CONSUMERS;
constexpr int DEC_EPT_LONG = DEC_MAX_K / DEC_CONSUMERS;
constexpr int DEC_STAGE = 8192;               // bytes of words a stage
constexpr int DEC_SSTAGE = DEC_STAGE / 2;     // bytes of block scales a stage (K11)
constexpr int DEC_STAGES = 8;                 // the ring's depth, at most
// what two blocks an SM leave a block (228 KB an SM, 1 KB of it reserved a
// block, the static arrays): the ring is cut to fit where it can
constexpr int DEC_TWO_SMEM = 108 * 1024;

// bytes of a stage of the ring
__host__ __device__ constexpr int dec_stage(bool block) {
  return block ? DEC_STAGE + DEC_SSTAGE : DEC_STAGE;
}
// dynamic shared memory past a ring of nst stages: the int8 rows, K11's
// warps' f32 partials, gamma, the barriers, alignment
__host__ __device__ constexpr int dec_rest(int MB, int K, bool gamma, bool block,
                                           int nst) {
  return MB * K + (block ? DEC_CONSUMERS * MB * 4 : 0) + (gamma ? 4 * K : 0)
         + (2 * nst + 1) * 8 + 1024;
}
__host__ __device__ constexpr int dec_max_smem(bool block) {
  return DEC_STAGES * dec_stage(block)
         + dec_rest(DEC_MAX_M, DEC_MAX_K, true, block, DEC_STAGES);
}
// where rows are short, the ring cut to DEC_TWO_SMEM keeps two stages of
// K11's mode (K1's stages and rest are smaller), so two blocks of either
// mode fit an SM there, as w2a8_decode_plan counts
static_assert(2 * dec_stage(true) + dec_rest(DEC_MAX_M, DEC_SHORT_K, true, true, DEC_STAGES)
                  <= DEC_TWO_SMEM,
              "two blocks of K11's mode an SM at DEC_SHORT_K");

template <typename T>
struct DecArgs {
  const T* x;
  int x_stride, M, Kp, glu;
  const float* gamma;
  float eps;
  int Np;
  const float* scale;                         // K1: one a column [Np]
  const T* resid;
  T* out;
  int N;
  int8_t* xq;
  float* sx;
  int* sumq;
  int nst;                                    // the ring's stages
  uint32_t mult;                              // the codes' bias: 3 (LUT) or 2 (TL)
  const float* stats;                         // [M][2] the whole row's sum of
                                              // squares and absmax, or nullptr
  int kfull;                                  // values of the whole row (stats)
};

// one contiguous copy into shared memory (bytes a multiple of 16, both ends
// 16-byte aligned), completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// the consumer warps' barrier (named barrier 1): the producer warp runs on
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "r"(DEC_CONSUMERS) : "memory");
}

// block_reduce's arithmetic and order over the 16 consumer warps, for the
// MB rows at once (each row's value reduced as block_reduce reduces one)
template <int MB>
__device__ __forceinline__ void dec_reduce(float (&v)[MB], float (*red)[32], bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int mm = 0; mm < MB; ++mm)
    for (int o = 16; o > 0; o >>= 1) {
      const float u = __shfl_xor_sync(0xffffffffu, v[mm], o);
      v[mm] = is_max ? (u > v[mm] ? u : v[mm]) : v[mm] + u;
    }
  consumers_sync();                      // red may still be read by a prior call
  if (lane == 0)
#pragma unroll
    for (int mm = 0; mm < MB; ++mm) red[mm][warp] = v[mm];
  consumers_sync();
#pragma unroll
  for (int mm = 0; mm < MB; ++mm) {
    v[mm] = lane < DEC_WARPS ? red[mm][lane] : (is_max ? red[mm][0] : 0.f);
    for (int o = 16; o > 0; o >>= 1) {
      const float u = __shfl_xor_sync(0xffffffffu, v[mm], o);
      v[mm] = is_max ? (u > v[mm] ? u : v[mm]) : v[mm] + u;
    }
  }
}

// rint(v / sx) clamped to +-127, v / sx rounded as IEEE division rounds it,
// from the reciprocal rcp = RN(1 / sx): |v / sx| <= 127 (sx is the row's
// absmax / 127), so t = RN(v * rcp) is within 127 * 2^-22 < 1e-4 of v / sx,
// and rint(t) is rint(v / sx) unless v / sx lies within 1e-4 of a
// half-integer, where the division itself decides (a branch the warp takes
// only when one of its lanes needs it; the caller's warps are whole)
__device__ __forceinline__ int dec_quantize(float v, float sx, float rcp) {
  const float t = __fmul_rn(v, rcp);
  const bool tie = fabsf(t - floorf(t) - 0.5f) < 1e-4f;
  float q = rintf(t);
  if (__any_sync(0xffffffffu, tie) && tie) q = rintf(v / sx);
  return (int)fminf(fmaxf(q, -127.f), 127.f);
}

// the byte of row value k in the int8 rows' layout: word row (tile, s)'s
// four planes' 4-byte groups side by side, (tile*16 + s)*16 + 4p + j for
// k = tile*256 + 64p + 4s + j
__device__ __forceinline__ int dec_xbyte(int k) {
  return (k & ~255) + ((k >> 2) & 15) * 16 + ((k >> 6) & 3) * 4 + (k & 3);
}

template <int MB, typename T, int COLS, int EPT, bool BLOCK>
__global__ void __launch_bounds__(DEC_THREADS, EPT == DEC_EPT_SHORT ? 2 : 1)
w2a8_decode(const __grid_constant__ CUtensorMap wmap,
            const __grid_constant__ CUtensorMap smap, const DecArgs<T> a) {
  constexpr int TPS = DEC_STAGE / (COLS * 64);    // K tiles a stage
  constexpr int CG = COLS / 32;                   // a warp's 32 columns: groups
  constexpr int NRG = DEC_WARPS / CG;             // warps on one column group
  constexpr int SB = dec_stage(BLOCK);            // bytes a stage
  static_assert(16 * TPS == 4 * NRG, "four word rows a warp a stage");
  static_assert(2 * TPS * CG == DEC_WARPS / 2, "K11: a stage is a unit for half the warps");
  extern __shared__ uint8_t smem_raw[];
  __shared__ int part[MB][COLS];
  __shared__ int sqw[MB][DEC_WARPS];
  __shared__ float redf[MB][32], sx_s[MB];
  __shared__ int sq_s[MB];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int nst = a.nst, Kp = a.Kp;
  const bool norm = a.gamma != nullptr;
  int8_t* xs = reinterpret_cast<int8_t*>(smem + nst * SB);          // [MB][Kp]
  float* red = reinterpret_cast<float*>(xs + MB * Kp);               // K11: [NRG][MB][COLS]
  float* gs = red + (BLOCK ? DEC_CONSUMERS * MB : 0);                // [Kp]
  uint64_t* full = reinterpret_cast<uint64_t*>(gs + (norm ? Kp : 0));
  uint64_t* empty = full + nst;
  uint64_t* gbar = empty + nst;

  const int nk = Kp / KT;
  const int ns = (nk + TPS - 1) / TPS;            // the block's stages
  const int n0 = blockIdx.x * COLS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // stage s into its slot: one TMA box of COLS ints x TPS K tiles' word
  // rows and, for K11, one of COLS floats x their scale rows (rows past the
  // layer read as zeros)
  auto load_stage = [&](int s) {
    const int slot = s % nst;
    mbar_expect_tx(&full[slot], SB);
    tma_load_2d(smem + slot * SB, &wmap, &full[slot], n0, s * TPS * (KT / 16));
    if constexpr (BLOCK)
      tma_load_2d(smem + slot * SB + DEC_STAGE, &smap, &full[slot], n0, s * TPS * (KT / 32));
  };
  if (tid == DEC_CONSUMERS) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], BLOCK ? DEC_WARPS / 2 : DEC_WARPS);
    }
    mbar_init(gbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < MB * COLS; i += DEC_THREADS) part[i / COLS][i % COLS] = 0;
  __syncthreads();                        // the barriers are set up
  launch_dependents();
  // the epilogue's operands: a consumer thread an output (mm, n)
  const int emm = tid / COLS, ec = tid % COLS, en = n0 + ec;
  const bool eout = tid < MB * COLS && emm < a.M && en < a.N;
  const float esc = eout && !BLOCK ? a.scale[en] : 0.f;
  float eres = 0.f;

  if (warp == DEC_WARPS) {                // the producer
    if (lane == 0) {
      if (norm) {
        mbar_expect_tx(gbar, Kp * 4);
        bulk_load(gs, a.gamma, Kp * 4, gbar);
      }
      for (int s = 0; s < min(nst, ns); ++s) load_stage(s);
    }
    __syncwarp();
    for (int s = 0; s + nst < ns; ++s) {  // refill each slot once it is read
      mbar_wait(&empty[s % nst], (s / nst) & 1);
      if (lane == 0) load_stage(s + nst);
      __syncwarp();
    }
  } else {
    grid_dependency_wait();               // x, resid and out: after the launch before
    if (eout && a.resid != nullptr) eres = load_f32(a.resid, (size_t)emm * a.N + en);

    // the preamble, k = tid + 512 i; a row's loads all in flight before the
    // first value is used
    float v[MB][EPT];
#pragma unroll
    for (int mm = 0; mm < MB; ++mm) {
      const T* xr = a.x + (size_t)mm * a.x_stride;
      float up[EPT];
#pragma unroll
      for (int i = 0; i < EPT; ++i) {
        const int k = tid + DEC_CONSUMERS * i;
        v[mm][i] = k < Kp ? load_f32(xr, k) : 0.f;
        up[i] = k < Kp && a.glu ? load_f32(xr, (size_t)Kp + k) : 0.f;
      }
      if (a.glu)                          // silu(gate) * up
#pragma unroll
        for (int i = 0; i < EPT; ++i) {
          const float t = v[mm][i];
          const float sig = 1.f / (1.f + expf(-t));
          v[mm][i] = __fmul_rn(__fmul_rn(t, sig), up[i]);
        }
    }
    if (norm) {                           // RMSNorm: (x * rsqrt(mean + eps)) * g
      float ss[MB];
      if (a.stats != nullptr) {           // the whole row's, from outside
#pragma unroll
        for (int mm = 0; mm < MB; ++mm) ss[mm] = a.stats[2 * mm];
      } else {
#pragma unroll
        for (int mm = 0; mm < MB; ++mm) {
          ss[mm] = 0.f;
#pragma unroll
          for (int i = 0; i < EPT; ++i) ss[mm] += v[mm][i] * v[mm][i];
        }
        dec_reduce<MB>(ss, redf, false);
      }
      mbar_wait(gbar, 0);
      const float kn = (float)(a.stats != nullptr ? a.kfull : Kp);
#pragma unroll
      for (int mm = 0; mm < MB; ++mm) {
        const float var = ss[mm] / kn;
        const float r = 1.f / sqrtf(var + a.eps);
#pragma unroll
        for (int i = 0; i < EPT; ++i) {
          const int k = tid + DEC_CONSUMERS * i;
          if (k < Kp) v[mm][i] = __fmul_rn(__fmul_rn(v[mm][i], r), gs[k]);
        }
      }
    }
    float am[MB];
    if (a.stats != nullptr) {
#pragma unroll
      for (int mm = 0; mm < MB; ++mm) am[mm] = a.stats[2 * mm + 1];
    } else {
#pragma unroll
      for (int mm = 0; mm < MB; ++mm) {
        am[mm] = 0.f;
#pragma unroll
        for (int i = 0; i < EPT; ++i) am[mm] = fmaxf(am[mm], fabsf(v[mm][i]));
      }
      dec_reduce<MB>(am, redf, true);
    }
    const bool writer = blockIdx.x == 0;  // writes the rows out
    // value tid + 512 i's byte in xs: 512 i + that of value tid (the low 8
    // bits of k, its place in the tile, are tid's)
    const int xoff = dec_xbyte(tid);
#pragma unroll
    for (int mm = 0; mm < MB; ++mm) {
      const float sx = fmaxf(am[mm], 1e-8f) / 127.f, rcp = 1.f / sx;
      int sq = 0;
#pragma unroll
      for (int i = 0; i < EPT; ++i) {
        const int k = tid + DEC_CONSUMERS * i;
        if (k < Kp) {                     // the same for the whole warp
          const int qi = dec_quantize(v[mm][i], sx, rcp);
          xs[mm * Kp + DEC_CONSUMERS * i + xoff] = (int8_t)qi;
          sq += qi;
          if (writer) a.xq[(size_t)mm * Kp + k] = (int8_t)qi;
        }
      }
      for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
      if (lane == 0) sqw[mm][warp] = sq;
      if (tid == 0) {
        sx_s[mm] = sx;
        if (writer) a.sx[mm] = sx;
      }
    }
    consumers_sync();                     // the int8 rows are in place
    if (tid < MB) {
      int sq = 0;
      for (int w = 0; w < DEC_WARPS; ++w) sq += sqw[tid][w];
      sq_s[tid] = sq;
      if (writer) a.sumq[tid] = sq;
    }

    // the dot: each word once, from the ring.  K1: every warp four word rows
    // of each stage; K11: warps 0-7 one unit of each even stage, 8-15 of
    // each odd one (a unit: half tile hl of the stage, 32 columns)
    const int4* xi = reinterpret_cast<const int4*>(xs);
    const int xrow = Kp / 16;                     // word rows a row of xs
    const int rg = warp / CG, col = (warp % CG) * 32 + lane;
    const int hl = (warp & 7) / CG, lt = hl >> 1, h = hl & 1;
    int acc[MB];                                  // K1: int32 partials
    float y[MB];                                  // K11: f32 partials
#pragma unroll
    for (int mm = 0; mm < MB; ++mm) {
      acc[mm] = 0;
      y[mm] = 0.f;
    }
    for (int s = BLOCK ? warp >> 3 : 0; s < ns; s += BLOCK ? 2 : 1) {
      const int slot = s % nst;
      const int* wt = reinterpret_cast<const int*>(smem + slot * SB);
      mbar_wait(&full[slot], (s / nst) & 1);
      if constexpr (BLOCK) {
        const float* sc = reinterpret_cast<const float*>(smem + slot * SB + DEC_STAGE);
        const int t = s * TPS + lt;               // the unit's K tile
        if (t < nk) {
          int bacc[4][MB], bsum[4][MB];           // the four blocks' q.v and q sums
#pragma unroll
          for (int p = 0; p < 4; ++p)
#pragma unroll
            for (int mm = 0; mm < MB; ++mm) bacc[p][mm] = bsum[p][mm] = 0;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            uint32_t pl[4];
            biased_planes((uint32_t)wt[(lt * 16 + 8 * h + i) * COLS + col], pl, a.mult);
#pragma unroll
            for (int mm = 0; mm < MB; ++mm) {
              const int4 q = xi[mm * xrow + t * 16 + 8 * h + i];
              bacc[0][mm] = __dp4a((int)pl[0], q.x, bacc[0][mm]);
              bacc[1][mm] = __dp4a((int)pl[1], q.y, bacc[1][mm]);
              bacc[2][mm] = __dp4a((int)pl[2], q.z, bacc[2][mm]);
              bacc[3][mm] = __dp4a((int)pl[3], q.w, bacc[3][mm]);
              bsum[0][mm] = __dp4a(0x01010101, q.x, bsum[0][mm]);
              bsum[1][mm] = __dp4a(0x01010101, q.y, bsum[1][mm]);
              bsum[2][mm] = __dp4a(0x01010101, q.z, bsum[2][mm]);
              bsum[3][mm] = __dp4a(0x01010101, q.w, bsum[3][mm]);
            }
          }
#pragma unroll
          for (int p = 0; p < 4; ++p) {           // block 8t + 2p + h of the row
            const float sv = sc[(lt * 8 + 2 * p + h) * COLS + col];
#pragma unroll
            for (int mm = 0; mm < MB; ++mm)
              y[mm] = fmaf((float)(bacc[p][mm] - 2 * bsum[p][mm]), sv, y[mm]);
          }
        }
      } else {
        const int row0 = s * TPS * (KT / 16);
        const int rows = min(TPS, nk - s * TPS) * (KT / 16);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = rg + NRG * i;
          if (r < rows) {
            uint32_t pl[4];
            biased_planes((uint32_t)wt[r * COLS + col], pl);
#pragma unroll
            for (int mm = 0; mm < MB; ++mm) {
              const int4 q = xi[mm * xrow + row0 + r];
              acc[mm] = __dp4a((int)pl[0], q.x, acc[mm]);
              acc[mm] = __dp4a((int)pl[1], q.y, acc[mm]);
              acc[mm] = __dp4a((int)pl[2], q.z, acc[mm]);
              acc[mm] = __dp4a((int)pl[3], q.w, acc[mm]);
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
    }
#pragma unroll
    for (int mm = 0; mm < MB; ++mm) {             // the warp's partials out
      if constexpr (BLOCK) red[(rg * MB + mm) * COLS + col] = y[mm];
      else atomicAdd(&part[mm][col], acc[mm]);
    }
  }
  __syncthreads();                        // every warp's partials are in place
  if (eout) {
    float y;
    if constexpr (BLOCK) {                // the column's NRG warps, in order
      float acc = 0.f;
      for (int w = 0; w < NRG; ++w) acc = __fadd_rn(acc, red[(w * MB + emm) * COLS + ec]);
      y = __fmul_rn(acc, sx_s[emm]);
    } else {
      y = (float)(part[emm][ec] - 2 * sq_s[emm]);
      y = __fmul_rn(__fmul_rn(y, sx_s[emm]), esc);
    }
    if (a.resid != nullptr) y = __fadd_rn(y, eres);
    store_f32(a.out, (size_t)emm * a.N + en, y);
  }
}

// ---------------------------------------------------------------------------
// K4 GEMM on wgmma.  The product is taken transposed, out^T[n, m] =
// W^T[n, k] . xq^T[k, m]: output columns are wgmma's 64-row M, whose A
// fragment comes from registers, and tokens are its N (BT = 8..128), whose
// B tile (the int8 rows, K-major) comes from shared memory.  Thread (g, t)
// of warp w holds A rows 16w+g and 16w+g+8 at K offsets 4t..4t+3 and
// 16+4t..16+4t+3 of each 32-K step, and word s, plane p of a column holds
// exactly such 4 K values (K rows p*64 + 4s + j): a thread reads its 8
// words of a 256-row K tile once and decodes all four planes from them.
//
// 384 threads: warpgroup 0 is the producer (one thread issues the copies),
// warpgroups 1 and 2 each own 64 of the block's 128 output columns.  A ring
// of stages, each one K tile: the BT int8 rows as two TMA boxes of 128
// bytes a row with the 128-byte swizzle wgmma's B descriptor reads (rows
// past M are zero-filled by the TMA unit), and the 16 word rows of the 128
// columns as one TMA box G4_WLD ints wide: its 8 extra columns pad each
// row, so the consumers' word reads are free of bank conflicts.  Three
// copies a stage: one thread issues them.  Full barriers count the bytes,
// empty barriers the 8 consumer warps.  A consumer decodes the next tile's
// A fragments while this tile's wgmmas run, into a second register set
// kept apart from the first until the wait (fence_operand).
//
// K may be split over the z blocks of a thread block cluster (up to 8):
// each block leaves its int32 partial tile in its shared memory, and after
// the cluster barrier block r adds the partials of its share of the rows
// from every rank and applies the epilogue.  Integer sums are exact in any
// order, so the split never changes a bit.
//
// The words do not depend on the row kernel before the GEMM: the first
// G4_PREFETCH stages' words are in flight before griddepcontrol.wait (the
// row kernel lets the GEMM start at once), the rows after it.
//
// The epilogue has three modes.  K4's, with one scale a column:
// ((acc - 2 sumq) * sx) * scale[n] in x's dtype; K1's GEMM form adds
// the residual, + resid[m, n], rounded as the plain version rounds (f32,
// then x's dtype).  K32's (scale == nullptr),
// with one scale for the tensor: (acc - 2 sumq) * (sx * tscale), the product
// sx * tscale rounded once in f32 before it multiplies, as the W2A8
// prototype rounds it, written as bf16 whatever x's dtype.  Nothing else
// differs: K32 at M = 1 reads each word once, 128 columns a block, through
// the TMA ring, and pads no row (rows past M read as zeros, never written).
// ---------------------------------------------------------------------------
constexpr int G4_COLS = 128;                  // output columns a block
constexpr int G4_WLD = G4_COLS + 8;           // ints a word row in shared memory
constexpr int G4_WTILE = (KT / 16) * G4_WLD * 4;   // bytes of a stage's words
constexpr int G4_PLD = G4_COLS + 4;           // ints a row of the partial tile
constexpr int G4_THREADS = 384;
constexpr int G4_MAX_SPLIT = 8;               // the portable cluster size
// stages whose words are in flight before the dependency wait (K24's
// FG_PREFETCH: more slow the row kernel, on the same memory, by more than
// they save)
constexpr int G4_PREFETCH = 2;

template <int BT>
struct G4Tile {
  static constexpr int STAGES = BT >= 64 ? 4 : 8;
  static constexpr int XBOX = BT * 128;       // bytes of one TMA box
  static constexpr int XTILE = 2 * XBOX;      // a K tile of BT int8 rows
  static constexpr int RING = STAGES * (XTILE + G4_WTILE);
  static constexpr int SMEM = RING + 2 * STAGES * 8 + 8 * BT + 1024;   // + alignment
  static_assert(BT * G4_PLD * 4 <= STAGES * XTILE, "partial tile fits the ring");
};

template <int BT>
__global__ void __launch_bounds__(G4_THREADS, 1)
w2a8_gemm(const __grid_constant__ CUtensorMap xmap,
          const __grid_constant__ CUtensorMap wmap, int M, int Kp, int Np,
          const int* __restrict__ sumq,
          const float* __restrict__ sx, const float* __restrict__ scale,
          float tscale, const void* __restrict__ resid, void* __restrict__ out, int N,
          int bf16_out) {
  using Tile = G4Tile<BT>;
  constexpr int STAGES = Tile::STAGES;
  extern __shared__ uint8_t smem_raw[];
  launch_dependents();
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* xs = smem;                                     // STAGES x XTILE
  int* ws = reinterpret_cast<int*>(smem + STAGES * Tile::XTILE);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Tile::RING);
  uint64_t* empty = full + STAGES;
  int* sumq_s = reinterpret_cast<int*>(empty + STAGES);   // the rows' sums and scales
  float* sx_s = reinterpret_cast<float*>(sumq_s + BT);

  cg::cluster_group cluster = cg::this_cluster();
  const int S = gridDim.z, rank = blockIdx.z;             // cluster (1, 1, S)
  const int nk = Kp / KT;
  const int kt0 = rank * nk / S, kt1 = (rank + 1) * nk / S;
  const int n0 = blockIdx.x * G4_COLS, m0 = blockIdx.y * BT;
  const int ncols = min(G4_COLS, Np - n0);                // 64 or 128
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);                            // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int nl = 2 * (threadIdx.x % (G4_COLS / 2));       // the epilogue's columns
  const int n = n0 + nl;
  const bool tensor_scale = scale == nullptr;             // K32's epilogue
  const float sc0 = !tensor_scale && n < N ? scale[n] : 0.f;
  const float sc1 = !tensor_scale && n + 1 < N ? scale[n + 1] : 0.f;
  __syncthreads();

  int acc[BT / 2];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) acc[i] = 0;
  const int ct = threadIdx.x & 127, w = ct >> 5, lane = ct & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int c = wg - 1;                                   // consumer's column half
  const bool active = wg > 0 && 64 * c < ncols;

  if (wg == 0) {                                          // producer
    if (threadIdx.x == 0) {
      auto load_words = [&](int st, int kt) {
        mbar_expect_tx(&full[st], Tile::XTILE + G4_WTILE);
        tma_load_2d(ws + st * (G4_WTILE / 4), &wmap, &full[st], n0, kt * (KT / 16));
      };
      const int npre = min(G4_PREFETCH, kt1 - kt0);
      for (int i = 0; i < npre; ++i) load_words(i, kt0 + i);
      grid_dependency_wait();
      int st = 0, ph = 0;
      for (int kt = kt0; kt < kt1; ++kt) {
        if (kt - kt0 >= npre) {
          mbar_wait(&empty[st], ph ^ 1);
          load_words(st, kt);
        }
        uint8_t* xdst = xs + st * Tile::XTILE;
        tma_load_2d(xdst, &xmap, &full[st], kt * KT, m0);
        tma_load_2d(xdst + Tile::XBOX, &xmap, &full[st], kt * KT + 128, m0);
        if (++st == STAGES) { st = 0; ph ^= 1; }
      }
    }
    __syncwarp();                        // warp 0 meets the block barriers whole
  } else if (!active) {                // a column half past Np: keep the ring turning
    int st = 0, ph = 0;
    for (int kt = kt0; kt < kt1; ++kt) {
      mbar_wait(&full[st], ph);
      if (lane == 0) mbar_arrive(&empty[st]);
      if (++st == STAGES) { st = 0; ph ^= 1; }
    }
  } else {                                                // consumers
    // the epilogue's operands, read now so that their latency hides behind
    // the main loop
    grid_dependency_wait();
    for (int i = ct + 128 * c; i < BT && m0 + i < M; i += 256) {
      sumq_s[i] = sumq[m0 + i];
      sx_s[i] = sx[m0 + i];
    }
    const int col = 64 * c + 16 * w + g;                  // A row g's column
    // the A fragments of the tile in stage st: word rows t4 + 4i of
    // columns col and col + 8.  32-K step (p, h) covers K rows p*64 + 32h
    // ..: words 8h + t4 (K offsets 4t4..) and 8h + 4 + t4 (16 + 4t4..)
    auto decode = [&](int st, uint32_t (&a)[8][4]) {
      const int* wt = ws + st * (G4_WTILE / 4);
      int wv[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wv[i][0] = wt[(t4 + 4 * i) * G4_WLD + col];
        wv[i][1] = wt[(t4 + 4 * i) * G4_WLD + col + 8];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          a[2 * p + h][0] = biased_plane(wv[2 * h][0], p);
          a[2 * p + h][1] = biased_plane(wv[2 * h][1], p);
          a[2 * p + h][2] = biased_plane(wv[2 * h + 1][0], p);
          a[2 * p + h][3] = biased_plane(wv[2 * h + 1][1], p);
        }
    };
    // the next tile's words are decoded while this tile's wgmmas run
    uint32_t a[8][4];
    int st = 0, ph = 0;
    if (kt0 < kt1) {
      mbar_wait(&full[0], 0);
      decode(0, a);
    }
    for (int kt = kt0; kt < kt1; ++kt) {
      const uint32_t xb = smem_u32(xs + st * Tile::XTILE);
#pragma unroll
      for (int i = 0; i < BT / 2; ++i) fence_operand(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int h = 0; h < 2; ++h)                       // box p/2, bytes (p%2)*64 + 32h
          wgmma_s8(acc, a[2 * p + h],
                   sw128_desc(xb + (p >> 1) * Tile::XBOX + (p & 1) * 64 + 32 * h));
      wgmma_commit();
      const int nst = st + 1 == STAGES ? 0 : st + 1, nph = nst == 0 ? ph ^ 1 : ph;
      uint32_t next[8][4];
      if (kt + 1 < kt1) {
        mbar_wait(&full[nst], nph);
        decode(nst, next);
      }
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < BT / 2; ++i) fence_operand(acc[i]);
      if (lane == 0) mbar_arrive(&empty[st]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          fence_operand(a[i][e]);          // the wgmmas above read a until the wait
          a[i][e] = next[i][e];
        }
      st = nst;
      ph = nph;
    }
  }
  __syncthreads();                       // every wgmma has read its stage

  // the int32 partial tile [BT tokens][128 columns], over the ring
  int* part = reinterpret_cast<int*>(smem);
  if (active) {
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 64 * c + 16 * w + g + (e & 2 ? 8 : 0);
        const int m = 8 * j + 2 * t4 + (e & 1);
        part[m * G4_PLD + r] = acc[4 * j + e];
      }
  }
  // block r of a split adds the partials of rows [r0, r1) over the ranks
  const int r0 = rank * BT / S, r1 = (rank + 1) * BT / S;
  if (S > 1) cluster.sync();             // every block's partial is in place
  else __syncthreads();
  // a thread stores two adjacent columns of every sixth row
  const bool pair = N % 2 == 0 && n + 1 < N;
  const int rend = min(r1, M - m0);
#pragma unroll 4
  for (int ml = r0 + threadIdx.x / (G4_COLS / 2); ml < rend;
       ml += G4_THREADS / (G4_COLS / 2)) {
    const int* at = part + ml * G4_PLD + nl;
    int2 v = *reinterpret_cast<const int2*>(at);
    for (int q = 1; q < S; ++q) {
      const int2 t = *reinterpret_cast<const int2*>(
          cluster.map_shared_rank(at, (rank + q) % S));
      v.x += t.x;
      v.y += t.y;
    }
    float y0, y1;
    if (tensor_scale) {
      const float s = __fmul_rn(sx_s[ml], tscale);
      y0 = __fmul_rn((float)(v.x - 2 * sumq_s[ml]), s);
      y1 = __fmul_rn((float)(v.y - 2 * sumq_s[ml]), s);
    } else {
      y0 = __fmul_rn(__fmul_rn((float)(v.x - 2 * sumq_s[ml]), sx_s[ml]), sc0);
      y1 = __fmul_rn(__fmul_rn((float)(v.y - 2 * sumq_s[ml]), sx_s[ml]), sc1);
    }
    const size_t o = (size_t)(m0 + ml) * N + n;
    if (resid != nullptr) {                // K1's residual, in the output's dtype
      if (bf16_out) {
        const __nv_bfloat16* r = static_cast<const __nv_bfloat16*>(resid);
        if (n < N) y0 = __fadd_rn(y0, load_f32(r, o));
        if (n + 1 < N) y1 = __fadd_rn(y1, load_f32(r, o + 1));
      } else {
        const float* r = static_cast<const float*>(resid);
        if (n < N) y0 = __fadd_rn(y0, r[o]);
        if (n + 1 < N) y1 = __fadd_rn(y1, r[o + 1]);
      }
    }
    if (pair) {
      if (bf16_out)
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + o) =
            __halves2bfloat162(__float2bfloat16_rn(y0), __float2bfloat16_rn(y1));
      else
        *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(y0, y1);
    } else {
      for (int e = 0; e < 2 && n + e < N; ++e) {
        if (bf16_out) store_f32(static_cast<__nv_bfloat16*>(out), o + e, e ? y1 : y0);
        else store_f32(static_cast<float*>(out), o + e, e ? y1 : y0);
      }
    }
  }
  if (S > 1) cluster.sync();             // no block leaves while it is read
}

template <typename T>
cudaError_t launch_quantize(const T* x, int x_stride, int M, int K, int glu,
                            const float* gamma, float eps, const float* stats, int kfull,
                            int8_t* xq, float* sx, int* sumq, cudaStream_t stream) {
  const size_t smem = (size_t)K * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        w2a8_quantize_rows<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  w2a8_quantize_rows<T><<<M, 512, smem, stream>>>(x, x_stride, K, glu, gamma, eps,
                                                  stats, kfull, xq, sx, sumq);
  return cudaGetLastError();
}

// a launch on clusters of (1, 1, split) blocks, as a programmatic dependent of
// the stream's last launch
template <typename Kern, typename... Args>
cudaError_t launch_on_cluster(Kern kern, dim3 grid, int threads, size_t smem, int split,
                              cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int BT>
cudaError_t launch_gemm(const CUtensorMap& xmap, const CUtensorMap& wmap, int M,
                        int Kp, int Np, const int* sumq, const float* sx,
                        const float* scale, float tscale, const void* resid, void* out,
                        int N, int bf16_out, int split, cudaStream_t stream) {
  auto kern = w2a8_gemm<BT>;
  static bool smem_set = false;           // once, before any graph capture
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         G4Tile<BT>::SMEM);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  return launch_on_cluster(kern, dim3((Np + G4_COLS - 1) / G4_COLS, (M + BT - 1) / BT, split),
                           G4_THREADS, G4Tile<BT>::SMEM, split, stream, xmap, wmap, M,
                           Kp, Np, sumq, sx, scale, tscale, resid, out, N, bf16_out);
}

// K1's (BLOCK: K11's) decode form: w2a8_decode<MB, T, COLS, EPT, BLOCK> on
// Np / COLS blocks; scales: K11's block scales [Kp/32, Np] of the layer
template <int MB, typename T, int COLS, int EPT, bool BLOCK>
cudaError_t launch_decode(const DecArgs<T>& a, const int* words, const float* scales,
                          cudaStream_t stream) {
  auto kern = w2a8_decode<MB, T, COLS, EPT, BLOCK>;
  static bool smem_set = false;           // once, before any graph capture
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         dec_max_smem(BLOCK));
    if (e == cudaSuccess)                 // all of L1 as shared memory: two blocks an SM
      e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  // the words: boxes of COLS ints x a stage's word rows; K11's scales:
  // boxes of COLS floats x their scale rows; both unswizzled
  CUtensorMap wmap, smap;
  cudaError_t e = tma_map_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_INT32, words, a.Np, a.Kp / 16,
                             (uint64_t)a.Np * 4, COLS, DEC_STAGE / (COLS * 4),
                             CU_TENSOR_MAP_SWIZZLE_NONE);
  smap = wmap;
  if (e == cudaSuccess && BLOCK)
    e = tma_map_2d(&smap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scales, a.Np, a.Kp / 32,
                   (uint64_t)a.Np * 4, COLS, DEC_SSTAGE / (COLS * 4),
                   CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != cudaSuccess) return e;
  const size_t smem = (size_t)a.nst * dec_stage(BLOCK)
                      + dec_rest(MB, a.Kp, a.gamma != nullptr, BLOCK, a.nst);
  return launch_on_cluster(kern, dim3(a.Np / COLS), DEC_THREADS, smem, 1, stream, wmap,
                           smap, a);
}

template <int MB, typename T, bool BLOCK>
cudaError_t launch_decode_cols(const DecArgs<T>& a, const int* words, const float* scales,
                               int cols, cudaStream_t stream) {
  const bool shrt = a.Kp <= DEC_SHORT_K;
#define BN_DEC(C)                                                                        \
  (shrt ? launch_decode<MB, T, C, DEC_EPT_SHORT, BLOCK>(a, words, scales, stream)        \
        : launch_decode<MB, T, C, DEC_EPT_LONG, BLOCK>(a, words, scales, stream))
  switch (cols) {
    case 32: return BN_DEC(32);
    case 64: return BN_DEC(64);
    default: return BN_DEC(128);
  }
#undef BN_DEC
}

// The rows of x (dtype 0 = float32, 1 = bfloat16, row stride x_stride;
// [gate | up] when glu) through silu(gate) * up and the RMSNorm by gamma
// where given, quantized into xq [M, Kp] / sx [M] / sumq [M], then the GEMM
// with bt rows a block and K split over split blocks of a cluster; out [M, N]
// (bf16 if bf16_out, else f32), one scale a column or, with scale ==
// nullptr, tscale for the tensor, plus resid [M, N] (out's dtype) where
// given.  Two launches.
cudaError_t w2a8_two_launches(const void* x, int x_stride, int M, int Kp, int glu,
                              const float* gamma, float eps, const float* stats,
                              int kfull, const int* words, int Np,
                              const float* scale, float tscale, const void* resid,
                              void* out, int N, int8_t* xq, float* sx, int* sumq,
                              int dtype, int bf16_out, int bt, int split,
                              cudaStream_t stream) {
  if (split < 1 || split > G4_MAX_SPLIT || (split & (split - 1)) || split > Kp / KT)
    return cudaErrorInvalidValue;
  cudaError_t e = dtype == 1
      ? launch_quantize(static_cast<const __nv_bfloat16*>(x), x_stride, M, Kp, glu,
                        gamma, eps, stats, kfull, xq, sx, sumq, stream)
      : launch_quantize(static_cast<const float*>(x), x_stride, M, Kp, glu, gamma, eps,
                        stats, kfull, xq, sx, sumq, stream);
  if (e != cudaSuccess) return e;
  // the int8 rows: boxes of 128 bytes x bt rows, 128-byte swizzle (rows past
  // M read as zeros); the words: 16 rows of G4_WLD columns, the 8 past the
  // block's 128 padding each row in shared memory (zeros past Np)
  CUtensorMap xmap, wmap;
  e = tma_map_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, Kp, M, Kp, 128, bt,
                 CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = tma_map_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_INT32, words, Np, Kp / 16,
                   (uint64_t)Np * 4, G4_WLD, KT / 16, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != cudaSuccess) return e;
#define BN_GEMM(BTV)                                                          \
  launch_gemm<BTV>(xmap, wmap, M, Kp, Np, sumq, sx, scale, tscale, resid, out, N, \
                   bf16_out, split, stream)
  switch (bt) {
    case 8: return BN_GEMM(8);
    case 16: return BN_GEMM(16);
    case 32: return BN_GEMM(32);
    case 64: return BN_GEMM(64);
    case 128: return BN_GEMM(128);
    default: return cudaErrorInvalidValue;
  }
#undef BN_GEMM
}

// K1's decode form (M <= DEC_MAX_M, K <= DEC_MAX_K, checked here: the
// caller picks the form) with cols columns a block; with block, K11's
// block-scale mode: scale is the layer's block scales [K/32, Np], mult the
// codes' bias (3: c + (c >> 1), 2: c)
template <typename T>
cudaError_t launch_normed_decode(const void* x, int x_stride, int M, int K, int glu,
                                 const float* gamma, float eps, const int* words, int Np,
                                 const float* scale, bool block, uint32_t mult,
                                 const void* resid, void* out, int N, int8_t* xq,
                                 float* sx, int* sumq, const float* stats, int kfull,
                                 int cols, cudaStream_t stream) {
  if (M > DEC_MAX_M || K > DEC_MAX_K || (cols != 32 && cols != 64 && cols != 128)
      || Np % cols)
    return cudaErrorInvalidValue;
  // the ring: the block's stages, at most DEC_STAGES, cut where it keeps two
  // blocks an SM (rows of up to DEC_SHORT_K values; longer rows take one
  // block an SM); K11's an even number, at least two (its two halves of
  // warps read alternate stages, each from its own slots)
  const int nk = K / KT, tps = DEC_STAGE / (cols * 64), ns = (nk + tps - 1) / tps;
  const int room = (K <= DEC_SHORT_K ? DEC_TWO_SMEM : dec_max_smem(block))
                   - dec_rest(DEC_MAX_M, K, gamma != nullptr, block, DEC_STAGES);
  int nst = std::min({DEC_STAGES, block ? ns + (ns & 1) : ns, room / dec_stage(block)});
  nst = block ? std::max(2, nst & ~1) : std::max(1, nst);
  const DecArgs<T> a = {static_cast<const T*>(x), x_stride, M, K, glu, gamma, eps, Np,
                        block ? nullptr : scale, static_cast<const T*>(resid),
                        static_cast<T*>(out), N, xq, sx, sumq, nst, mult, stats, kfull};
  if (block)
    return M == 1 ? launch_decode_cols<1, T, true>(a, words, scale, cols, stream)
                  : launch_decode_cols<2, T, true>(a, words, scale, cols, stream);
  return M == 1 ? launch_decode_cols<1, T, false>(a, words, nullptr, cols, stream)
                : launch_decode_cols<2, T, false>(a, words, nullptr, cols, stream);
}

}  // namespace

extern "C" {

// K1: x [M, K] (or [M, 2K] when glu, rows x_stride values apart; dtype 0 =
// float32, 1 = bfloat16: x, resid and out share it), K % 256 == 0; words
// [K/16, Np]; out [M, N].  xq [M, K] (16-byte aligned), sx [M], sumq [M]
// receive the int8 rows, scales and sums.  Two forms, which the caller
// picks: cols > 0, one launch of w2a8_decode at M <= 2 and K <= 14336
// (refused past them) with cols = 32, 64 or 128 columns a block (dividing
// Np); cols == 0, any M and K, the row kernel, then the GEMM with bt rows a
// block (8..128) and K split over split blocks of a cluster (1, 2, 4 or 8,
// at most K / 256).  stats, where not null, is the row-statistics mode:
// stats [M][2] f32, each row's sum of squares over kfull values (the whole
// row, of which x holds K) and the absmax of the whole normed row, taken
// instead of the kernel's own (the row-parallel linears of the mesh modes,
// parallel/sharding.py).  Each launch is a programmatic dependent of the
// stream's last launch.  Returns cudaGetLastError() after the launches.
int bn_w2a8_normed(const void* x, int x_stride, int M, int K, int glu,
                   const float* gamma, float eps, const int* words, int Np,
                   const float* scale, const void* resid, void* out, int N,
                   int8_t* xq, float* sx, int* sumq, int dtype, const float* stats,
                   int kfull, int cols, int bt, int split, cudaStream_t stream) {
  if (M < 1 || K < KT || K % KT || Np % 64 || N > Np || (stats != nullptr && kfull < K))
    return (int)cudaErrorInvalidValue;
  if (cols == 0)
    return (int)w2a8_two_launches(x, x_stride, M, K, glu, gamma, eps, stats, kfull, words,
                                  Np, scale, 0.f, resid, out, N, xq, sx, sumq, dtype,
                                  dtype == 1, bt, split, stream);
  if (dtype == 1)
    return (int)launch_normed_decode<__nv_bfloat16>(x, x_stride, M, K, glu, gamma, eps,
                                                    words, Np, scale, false, 3u, resid, out,
                                                    N, xq, sx, sumq, stats, kfull, cols,
                                                    stream);
  return (int)launch_normed_decode<float>(x, x_stride, M, K, glu, gamma, eps, words, Np,
                                          scale, false, 3u, resid, out, N, xq, sx, sumq,
                                          stats, kfull, cols, stream);
}

// K11: K1's decode form in its block-scale mode, the same operands but the
// scales: f32 [K/32, Np], a scale a 32-row block and column; lut_bias picks
// the codes' biased value (1: bitnet32's c + (c >> 1), 0: TL's c).  M <= 2,
// K <= 14336, cols as K1's.  One launch.
int bn_tl_w2a8_normed(const void* x, int x_stride, int M, int K, int glu,
                      const float* gamma, float eps, const int* words, int Np,
                      const float* scales, const void* resid, void* out, int N,
                      int8_t* xq, float* sx, int* sumq, int lut_bias, int dtype, int cols,
                      cudaStream_t stream) {
  if (M < 1 || K < KT || K % KT || Np % 64 || N > Np) return (int)cudaErrorInvalidValue;
  const uint32_t mult = lut_bias ? 3u : 2u;
  if (dtype == 1)
    return (int)launch_normed_decode<__nv_bfloat16>(x, x_stride, M, K, glu, gamma, eps,
                                                    words, Np, scales, true, mult, resid,
                                                    out, N, xq, sx, sumq, nullptr, 0, cols,
                                                    stream);
  return (int)launch_normed_decode<float>(x, x_stride, M, K, glu, gamma, eps, words, Np,
                                          scales, true, mult, resid, out, N, xq, sx, sumq,
                                          nullptr, 0, cols, stream);
}

// K4: the rows of x (dtype 0 = float32, 1 = bfloat16, row stride x_stride)
// quantized into xq [M, Kp] / sx [M] / sumq [M], then the GEMM with bt rows
// a block (8, 16, 32, 64 or 128) and K split over split blocks of a cluster
// (1, 2, 4 or 8, at most Kp / 256); out [M, N] in x's dtype.  Two launches.
// stats, where not null, gives each row's absmax from outside: the second
// of each pair of stats [M][2] f32 (the row-parallel linears of the mesh
// modes).
int bn_w2a8_gemm(const void* x, int x_stride, int M, int Kp, const int* words,
                 int Np, const float* scale, void* out, int N, int8_t* xq,
                 float* sx, int* sumq, const float* stats, int dtype, int bt,
                 int split, cudaStream_t stream) {
  if (M < 1 || Kp % KT || Np % 64 || N > Np) return (int)cudaErrorInvalidValue;
  return (int)w2a8_two_launches(x, x_stride, M, Kp, 0, nullptr, 0.f, stats, Kp, words, Np,
                                scale, 0.f, nullptr, out, N, xq, sx, sumq, dtype,
                                dtype == 1, bt, split, stream);
}

// K32: x [M, K] (dtype as above, rows contiguous) times words [K/16, N]
// (K % 256 == 0, N % 8 == 0) with one scale for the tensor: the same two
// launches, out [M, N] bf16 = f32(acc - 2 sumq) * (sx * scale).
int bn_w2a8_matmul(const void* x, int M, int K, const int* words, int N, float scale,
                   void* out, int8_t* xq, float* sx, int* sumq, int dtype, int bt,
                   int split, cudaStream_t stream) {
  if (M < 1 || K < KT || K % KT || N < 8 || N % 8) return (int)cudaErrorInvalidValue;
  return (int)w2a8_two_launches(x, K, M, K, 0, nullptr, 0.f, nullptr, 0, words, N, nullptr,
                                scale, nullptr, out, N, xq, sx, sumq, dtype, 1, bt, split,
                                stream);
}

const char* bn_ternary_matmul_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
