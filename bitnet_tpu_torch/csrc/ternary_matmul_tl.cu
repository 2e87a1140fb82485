// Ternary matmuls with per-32-row block scales (bitnet32 and TL1/TL2 weights)
// or one scale a column (qk256 weights under --kernel-path pallas) for Hopper
// (sm_90a).
//
// Replaces these Pallas kernels of bitnet_tpu/ops/ternary_matmul.py (K11, the
// W2A8 twin of K12 at B <= 2, is K1's decode kernel in its block-scale mode,
// ternary_matmul.cu):
//   K10 bn_blockscale_gemm  <- the _bitnet32_kernel body (:138) of
//                              _ternary_matmul_2d (pallas_call :1177) and of
//                              ternary_matmul_stacked_tl (:502, pallas_call :555)
//   K6  bn_colscale_decode  <- the bf16 _qk256_kernel body (:112) of
//       bn_colscale_gemm       _ternary_matmul_2d (pallas_call :1177): the
//                              column-scale mode of K10's decode form and of
//                              its GEMM (below)
//   K12 bn_tl_bf16_normed   <- ternary_matmul_stacked_tl_fused (:669,
//                              pallas_call :733), body _bitnet32_fused_kernel (:573)
//
// Weights: K1's int32 words [Kp/16, Np] (ternary_common.cuh) plus f32 block
// scales s [Kp/32, Np] of the same layer, zero-padded.  LUT_BIAS picks the
// biased value of a code c: c + (c >> 1) in {0,1,3,4} (bitnet32, the LUT
// {-2,-1,1,2} plus 2) or c in {0..3} (TL levels {-2,-1,0,1} plus 2).
//
// What bounds them on the card, and what the design does about it:
//  - K10 has two forms: the decode form (below), which takes up to 16 rows
//    and runs for M <= MB (the wrapper's BLOCKSCALE_DECODE_MAX_M), and for
//    more rows (prefill, small pools) the GEMM it shares with K12
//    (pools, M = 1..64).  Decode is bound by the bytes of words and scales
//    (the scales are half the words' bytes), prefill by bf16 operations.
//    The GEMM is K4's design for bf16 (below): the transposed product on
//    wgmma, the words' planes decoded through a per-(column, 32-row block)
//    table into its register A operand, the bf16 rows its B by TMA, tokens
//    its N (BT = 8..128, so K12's pool of 8 fills an 8-wide tile), K split
//    over a cluster where the column blocks leave SMs idle.  Each call is
//    two launches: a row kernel (K10: x rounded to bf16, zero-padded to Kp,
//    and its 32-row sums; K12: the SwiGLU / RMSNorm preamble), then the
//    GEMM as its programmatic dependent.  K10's bias correction
//    2 * (sum32 @ s) is subtracted inside the GEMM; padded K rows hold code
//    0, whose biased value is 0, so a zero-padded scale never meets a
//    nonzero weight.  K12's unbiased weights need no correction.
//  - K10's decode form (M <= MB: the generic path's seven projections and
//    the stacked loop's four at decode rows): one lane per output column
//    reads coalesced word rows (a half tile of 8 a warp), so every word and
//    scale is read once per call whatever M is; K is split over a thread block cluster (up to 8
//    blocks) where the column blocks alone leave the SMs idle (k / v: 20
//    column blocks on 132 SMs), and the cluster's partials are added in rank
//    order through distributed shared memory (one launch, no scratch, no
//    atomics: two runs give the same bits).  Each warp stages its half
//    tile's rows of x in its own slice of shared memory, rounded to bf16 (so
//    x comes in its own dtype, unpadded), and forms their 32-row sums there;
//    the correction 2 * sum32 * s[b, n] is kept beside the dot and
//    subtracted at the end, as the JAX epilogue subtracts corr.  The weight
//    of a code is looked up with two byte permutes from two registers that
//    hold the low and high bytes of the four bf16 weights bf16(v * s) of the
//    (column, block), the code-0 entry +0 (byte 0 of both is the zero the
//    lookup places in the f32's low half); x * w is exact in f32 and summed
//    there.  The generic seven at M = 1 take 8x their byte bound together
//    (PERF.md, Findings).
//  - K6 is the column-scale mode (W_COLSCALE) of both K10 forms:
//    y = (sum_k bf16(x) * v(c) - 2 * sum_k bf16(x)) * s[n], v(c) = c + (c >> 1)
//    in {0,1,3,4}, the bitnet32 LUT's biased values, in f32 (:1114-1121,
//    :1126-1149).  Its decode form (M <= MB, the wrapper's
//    BF16_DECODE_MAX_M) reads no scale rows, so a call moves 2/3 of K10's
//    bytes; a code's weight comes from two constant registers
//    (COLS_LO / COLS_HI), and each warp forms the whole-row sums of its
//    rows beside their 32-row sums, added over the warps and the cluster in
//    the order of the partials.  Its GEMM form is the GEMM below without the
//    scale box, the table build and the correction steps; its row kernel
//    (colscale_rows) writes the whole-row sums and, only where TMA cannot
//    read x itself (f32 x, or rows 16-byte misaligned), the bf16 rows.  Both
//    subtract 2 * sum once, after the K reduction, then scale:
//    (acc - 2 * sum) * s[n], rounded in that order as the JAX epilogue is.

#include <cooperative_groups.h>
#include <cuda.h>

#include <type_traits>

#include "ternary_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace bn;

// ---------------------------------------------------------------------------
// K10 / K12 GEMM on wgmma, the block-scale counterpart of K4's GEMM
// (ternary_matmul.cu).  The product is taken transposed, out^T[n, m] =
// W^T[n, k] . xb^T[k, m]: output columns are wgmma's 64-row M, whose A
// fragments come from registers, and tokens are its N (BT = 8..128), whose
// B tile (the bf16 rows, K-major) comes from shared memory.  For the k16
// step of plane p, K rows p*64 + 16h .. +15, thread (g, t) of warp w holds
// A rows (columns) 16w+g and 16w+g+8 at K offsets 2t, 2t+1 and 2t+8, 2t+9:
// bytes 2(t&1), 2(t&1)+1 of plane p of word rows 4h + t/2 and 4h + 2 + t/2.
// A thread reads its 16 words of a K tile once (shifted so that its two
// bytes are the low ones) and decodes every plane from them: the weights
// of a (column, 32-row block) are four bf16 values, bf16(v(c) * s) (K10:
// biased, as :156) or bf16((v(c) - 2) * s) (K12: unbiased, as :633), held
// as their low and high bytes in two registers, and a code pair becomes its
// bf16x2 fragment register with one byte permute.
//
// 384 threads: warpgroup 0 is the producer (one thread issues the copies),
// warpgroups 1 and 2 each own 64 of the block's 128 columns.  A ring of
// stages, each one K tile: the bf16 rows as four TMA boxes of 64 values
// (128 bytes) a row with the 128-byte swizzle wgmma's B descriptor reads
// (rows past M zero-filled by the TMA unit), the 16 word rows as one box
// BS_WLD columns wide (the 8 past the block's 128 pad each shared-memory
// row: conflict-free word reads), the K tile's 8 scale rows of the block's
// columns and, for K10, the rows' block sums.  Full barriers count the
// bytes, empty barriers the 8 consumer warps.  A consumer issues one wgmma
// group a unit (two planes, one at BT = 128, where the accumulators take
// the registers) and decodes the next unit while it runs, into a second
// register set kept apart from the first until the wait (fence_operand).
//
// K10 (W_BLOCK) subtracts its bias correction 2 * sum_b sum32[m, b] * s[b, n]
// on the tensor cores too: two more k16 steps a K tile, A = -2 s of the
// tile's 8 scale blocks split into bf16 hi + lo parts, B = the rows' 8
// block sums split the same way by the row kernel (hi·hi + hi·lo + lo·hi +
// lo·lo: 16 significant bits of each factor, far inside the f32 output's
// tolerance), by TMA in four boxes of 8 values a row, the layout of
// wgmma's unswizzled core matrices.  That adds 1/8 to the tensor work and
// nothing to the CUDA cores; as f32 FMAs into the accumulators the same
// correction doubled the GEMM's time.  K12 (W_UNBIASED) adds the residual
// in the epilogue.  K6 (W_COLSCALE) reads no scale rows: its A fragments
// come from the constant table of the biased values, and its epilogue, after
// the K reduction, computes (acc - 2 * sumx[m]) * s[n] from the row kernel's
// whole-row sums and the column scales.
//
// K may be split over the z blocks of a thread block cluster (up to 8):
// each block leaves its f32 partial tile in its shared memory, and after
// the cluster barrier block r adds its share of the rows over the ranks in
// rank order 0, 1, ..., so two calls give the same bits.  The GEMM is a
// programmatic dependent of the row kernel before it (K10's rows, K12's
// preamble): barrier set-up and the first tile's words and scales overlap
// that kernel's tail.
// ---------------------------------------------------------------------------
constexpr int BS_COLS = 128;                  // output columns a block
constexpr int BS_WLD = BS_COLS + 8;           // ints a word row in shared memory
constexpr int BS_WTILE = (KT / 16) * BS_WLD * 4;    // bytes of a stage's words
constexpr int BS_STILE = (KT / 32) * BS_COLS * 4;   // bytes of its scale rows
constexpr int BS_PLD = BS_COLS + 4;           // floats a row of the partial tile
constexpr int BS_THREADS = 384;
constexpr int BS_MAX_SPLIT = 8;               // the portable cluster size

// The weight modes of the decode form and the GEMM: block scales with the
// bias correction 2 * sum32 * s (K10; lut_bias picks the values), block
// scales on unbiased values (K12's GEMM), one scale a column with the
// correction 2 * sum(x) after the K reduction (K6).
enum WMode { W_BLOCK = 0, W_UNBIASED = 1, W_COLSCALE = 2 };

// K6's weights: byte c of COLS_LO / COLS_HI is the low / high byte of the
// bf16 biased value of code c, {0, 1, 3, 4} = 0x0000, 0x3F80, 0x4040, 0x4080
constexpr uint32_t COLS_LO = 0x80408000u, COLS_HI = 0x40403F00u;

template <int BT, int MODE>
struct BsTile {
  static constexpr int XBOX = BT * 128;       // bytes of one TMA box
  static constexpr int XTILE = 4 * XBOX;      // a K tile of BT bf16 rows
  static constexpr int STILE = MODE == W_COLSCALE ? 0 : BS_STILE;   // scale rows
  static constexpr int QTILE = MODE == W_BLOCK ? BT * 64 : 0;   // block sums, split
  static constexpr int STAGE = XTILE + BS_WTILE + STILE + QTILE;
  static constexpr int STAGES = 200 * 1024 / STAGE < 8 ? 200 * 1024 / STAGE : 8;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int SMEM = RING + 2 * STAGES * 8 + 1024;   // + alignment
  static constexpr int UP = BT >= 128 ? 1 : 2;               // planes a unit
  static_assert(STAGES >= 2, "a ring of two stages at least");
  static_assert(BT * BS_PLD * 4 <= RING, "partial tile fits the ring");
};

// wgmma.mma_async m64nBTk16 f32 += bf16 (A, registers) x bf16 (B, shared
// memory, K-major); d holds BT/2 accumulators a thread
__device__ __forceinline__ void wgmma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[8], const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[16], const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// wgmma descriptor of a K-major tile without swizzle: core matrices of 8
// rows x 16 bytes, each 128 contiguous bytes; lbo bytes between core
// matrices adjacent in K, sbo between those adjacent in N
__device__ __forceinline__ uint64_t plain_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16)
       | ((uint64_t)(sbo >> 4) << 32);
}

// v as bf16 hi + lo, hi = bf16(v), lo = bf16(v - hi): 16 significant bits
__device__ __forceinline__ void split_bf16(float v, __nv_bfloat16& hi, __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(v);
  lo = __float2bfloat16_rn(__fsub_rn(v, __bfloat162float(hi)));
}

// lo / hi: byte c holds the low / high byte of bf16(vals[c] * s), the
// weight of code c in a block of scale s
__device__ __forceinline__ void weight_table(const float (&vals)[4], float s,
                                             uint32_t& lo, uint32_t& hi) {
  const __nv_bfloat162 w01 = __floats2bfloat162_rn(__fmul_rn(vals[0], s),
                                                   __fmul_rn(vals[1], s));
  const __nv_bfloat162 w23 = __floats2bfloat162_rn(__fmul_rn(vals[2], s),
                                                   __fmul_rn(vals[3], s));
  const uint32_t p01 = *reinterpret_cast<const uint32_t*>(&w01);
  const uint32_t p23 = *reinterpret_cast<const uint32_t*>(&w23);
  lo = __byte_perm(p01, p23, 0x6420);
  hi = __byte_perm(p01, p23, 0x7531);
}

// the weights of the codes in bytes 0 and 1 of plane p of w as a bf16x2
// register, the lower K index in the low half: the selector's nibbles are
// (c0, c0 + 4, c1, c1 + 4), byte k of u * 0x11 + 0x4040 being ck | (ck + 4) << 4
__device__ __forceinline__ uint32_t code_pair(int w, int p, uint32_t lo, uint32_t hi) {
  const uint32_t u = ((uint32_t)w >> (2 * p)) & 0x0303u;
  return __byte_perm(lo, hi, u * 0x11u + 0x4040u);
}

// out[m, n] = sum_k xb[m, k] * w[k, n] (W_BLOCK: - 2 sum_b sum32[m, b] s[b, n])
// (+ resid[m, n]) for n < N, in bf16 (bf16_out) or f32; W_COLSCALE:
// (sum_k xb[m, k] * v[k, n] - 2 sumx[m]) * cscale[n]
template <int BT, int MODE>
__global__ void __launch_bounds__(BS_THREADS, 1)
blockscale_gemm(const __grid_constant__ CUtensorMap xmap,
                const __grid_constant__ CUtensorMap wmap,
                const __grid_constant__ CUtensorMap smap,
                const __grid_constant__ CUtensorMap qmap, int M, int Kp, int Np,
                int lut_bias, const void* __restrict__ resid,
                void* __restrict__ out, int N, int bf16_out,
                const float* __restrict__ sumx, const float* __restrict__ cscale) {
  using Tile = BsTile<BT, MODE>;
  constexpr bool CORR = MODE == W_BLOCK, COLS = MODE == W_COLSCALE;
  constexpr int STAGES = Tile::STAGES, UP = Tile::UP, UNITS = 4 / UP;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* xs = smem;                                           // STAGES x XTILE
  int* ws = reinterpret_cast<int*>(smem + STAGES * Tile::XTILE);
  float* ss = reinterpret_cast<float*>(smem + STAGES * (Tile::XTILE + BS_WTILE));
  float* qs = ss + STAGES * (Tile::STILE / 4);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Tile::RING);
  uint64_t* empty = full + STAGES;

  cg::cluster_group cluster = cg::this_cluster();
  const int S = gridDim.z, rank = blockIdx.z;                   // cluster (1, 1, S)
  const int nk = Kp / KT;
  const int kt0 = rank * nk / S, kt1 = (rank + 1) * nk / S;
  const int n0 = blockIdx.x * BS_COLS, m0 = blockIdx.y * BT;
  const int ncols = min(BS_COLS, Np - n0);                      // 64 or 128
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);                                  // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[BT / 2];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) acc[i] = 0.f;
  const int ct = threadIdx.x & 127, w = ct >> 5, lane = ct & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int c = wg - 1;                                         // consumer's column half
  const bool active = wg > 0 && 64 * c < ncols;

  if (wg == 0) {                                                // producer
    if (threadIdx.x == 0) {
      int st = 0, ph = 0;
      for (int kt = kt0; kt < kt1; ++kt) {
        mbar_wait(&empty[st], ph ^ 1);
        mbar_expect_tx(&full[st], Tile::STAGE);
        tma_load_2d(ws + st * (BS_WTILE / 4), &wmap, &full[st], n0, kt * (KT / 16));
        if constexpr (!COLS)
          tma_load_2d(ss + st * (Tile::STILE / 4), &smap, &full[st], n0, kt * (KT / 32));
        if (kt == kt0) grid_dependency_wait();
        uint8_t* xdst = xs + st * Tile::XTILE;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          tma_load_2d(xdst + b * Tile::XBOX, &xmap, &full[st], kt * KT + 64 * b, m0);
        if constexpr (CORR) {
          uint8_t* qdst = reinterpret_cast<uint8_t*>(qs) + st * Tile::QTILE;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            tma_load_2d(qdst + b * BT * 16, &qmap, &full[st], kt * 32 + 8 * b, m0);
        }
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
  } else {                                                      // consumers
    const int col = 64 * c + 16 * w + g;                        // A row g's column
    const int shift = 16 * (t4 & 1);
    float vals[4];                                              // each code's value
#pragma unroll
    for (int cc = 0; cc < 4; ++cc)
      vals[cc] = (float)((lut_bias ? cc + (cc >> 1) : cc) - (MODE == W_UNBIASED ? 2 : 0));
    // word rows 2i + t/2 of columns col and col + 8 (i = 0..7: for step h,
    // rows 4h + t/2 and 4h + 2 + t/2 are i = 2h and 2h + 1)
    int wv[8][2];
    auto load_words = [&](int st) {
      const int* wt = ws + st * (BS_WTILE / 4);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = 2 * i + (t4 >> 1);
        wv[i][0] = (int)((uint32_t)wt[r * BS_WLD + col] >> shift);
        wv[i][1] = (int)((uint32_t)wt[r * BS_WLD + col + 8] >> shift);
      }
    };
    // the A fragments of planes p0 .. p0 + UP - 1 of the tile in stage st:
    // step (p, h) uses the table of scale block 2p + h/2 (K6: the constant one)
    auto decode = [&](int st, int p0, uint32_t (&a)[4 * UP][4]) {
      const float* sc = ss + st * (Tile::STILE / 4);
#pragma unroll
      for (int pp = 0; pp < UP; ++pp)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int p = p0 + pp, b = 2 * p + hh;
          uint32_t lo0 = COLS_LO, hi0 = COLS_HI, lo1 = COLS_LO, hi1 = COLS_HI;
          if constexpr (!COLS) {
            weight_table(vals, sc[b * BS_COLS + col], lo0, hi0);
            weight_table(vals, sc[b * BS_COLS + col + 8], lo1, hi1);
          }
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int h = 2 * hh + h2;
            a[4 * pp + h][0] = code_pair(wv[2 * h][0], p, lo0, hi0);
            a[4 * pp + h][1] = code_pair(wv[2 * h][1], p, lo1, hi1);
            a[4 * pp + h][2] = code_pair(wv[2 * h + 1][0], p, lo0, hi0);
            a[4 * pp + h][3] = code_pair(wv[2 * h + 1][1], p, lo1, hi1);
          }
        }
    };
    // K10's correction of the tile in stage st as A fragments of two k16
    // steps: K offset k of step q is scale block k % 8 of the tile, with
    // the weight hi(-2 s) (q = 0) or lo(-2 s) (q = 1) against sum32's hi
    // (k < 8) or lo (k >= 8) part in the B tile; a thread's K offsets 2t,
    // 2t+1 and 2t+8, 2t+9 are blocks 2t and 2t+1 both times
    auto corr_frags = [&](int st, uint32_t (&cf)[2][4]) {
      const float* sc = ss + st * (Tile::STILE / 4);
#pragma unroll
      for (int r = 0; r < 2; ++r) {                             // column col + 8r
        __nv_bfloat16 h0, l0, h1, l1;
        split_bf16(-2.f * sc[(2 * t4) * BS_COLS + col + 8 * r], h0, l0);
        split_bf16(-2.f * sc[(2 * t4 + 1) * BS_COLS + col + 8 * r], h1, l1);
        const __nv_bfloat162 hh = __halves2bfloat162(h0, h1), ll = __halves2bfloat162(l0, l1);
        cf[0][r] = cf[0][r + 2] = *reinterpret_cast<const uint32_t*>(&hh);
        cf[1][r] = cf[1][r + 2] = *reinterpret_cast<const uint32_t*>(&ll);
      }
    };
    // One flat loop over the units of the block's K tiles, one wgmma group
    // each (K10: the tile's last unit adds its correction's two k16 steps),
    // as K4's loop over tiles: the next unit is decoded while this one's
    // wgmmas run, into a second register set kept apart until the wait.
    // Each of these gave wrong, unrepeatable sums on the H100: the
    // correction as FMAs into the accumulators after a tile's wait; the
    // units of a tile unrolled, or in an inner loop, inside the loop over
    // tiles.
    uint32_t a[4 * UP][4], cf[2][4];
    int st = 0, ph = 0;
    const int u0 = kt0 * UNITS, u1 = kt1 * UNITS;
    if (u0 < u1) {
      mbar_wait(&full[0], 0);
      load_words(0);
      decode(0, 0, a);
      if constexpr (CORR) corr_frags(0, cf);
    }
    for (int u = u0; u < u1; ++u) {
      const int un = u % UNITS;
      const bool last = un == UNITS - 1;                        // of its K tile
      const uint32_t xb = smem_u32(xs + st * Tile::XTILE) + un * UP * Tile::XBOX;
#pragma unroll
      for (int i = 0; i < BT / 2; ++i) fence_operand(acc[i]);
      wgmma_fence();
#pragma unroll
      for (int pp = 0; pp < UP; ++pp)
#pragma unroll
        for (int h = 0; h < 4; ++h)                             // box p, bytes 32h
          wgmma_bf16(acc, a[4 * pp + h], sw128_desc(xb + pp * Tile::XBOX + 32 * h));
      if constexpr (CORR) {
        if (last) {                                             // boxes 2q, 2q + 1
          const uint32_t qb = smem_u32(qs) + st * Tile::QTILE;
          wgmma_bf16(acc, cf[0], plain_desc(qb, BT * 16, 128));
          wgmma_bf16(acc, cf[1], plain_desc(qb + 2 * BT * 16, BT * 16, 128));
        }
      }
      wgmma_commit();
      const int nst = st + 1 == STAGES ? 0 : st + 1, nph = nst == 0 ? ph ^ 1 : ph;
      uint32_t next[4 * UP][4], cnext[2][4];
      if (!last) {
        decode(st, (un + 1) * UP, next);
      } else if (u + 1 < u1) {                                  // the next tile's first
        mbar_wait(&full[nst], nph);
        load_words(nst);
        decode(nst, 0, next);
        if constexpr (CORR) corr_frags(nst, cnext);
      }
      wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < BT / 2; ++i) fence_operand(acc[i]);
      if (last) {
        if (lane == 0) mbar_arrive(&empty[st]);
        st = nst;
        ph = nph;
      }
#pragma unroll
      for (int i = 0; i < 4 * UP; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          fence_operand(a[i][e]);          // the wgmmas above read a until the wait
          a[i][e] = next[i][e];
        }
      if constexpr (CORR) {
        if (last) {
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              fence_operand(cf[q][e]);
              cf[q][e] = cnext[q][e];
            }
        }
      }
    }
  }
  __syncthreads();                       // every wgmma has read its stage

  // the f32 partial tile [BT tokens][128 columns], over the ring
  float* part = reinterpret_cast<float*>(smem);
  if (active) {
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 64 * c + 16 * w + g + (e & 2 ? 8 : 0);
        const int m = 8 * j + 2 * t4 + (e & 1);
        part[m * BS_PLD + r] = acc[4 * j + e];
      }
  }
  // block r of a split adds the partials of rows [r0, r1) over the ranks
  const int r0 = rank * BT / S, r1 = (rank + 1) * BT / S;
  if (S > 1) cluster.sync();             // every block's partial is in place
  else __syncthreads();
  if constexpr (COLS) grid_dependency_wait();   // the row kernel's sums
  // a thread takes two adjacent columns of every sixth row
  const int nl = 2 * (threadIdx.x % (BS_COLS / 2)), n = n0 + nl;
  const bool pair = N % 2 == 0 && n + 1 < N;
  const int rend = min(r1, M - m0);
  for (int ml = r0 + threadIdx.x / (BS_COLS / 2); ml < rend && n < N;
       ml += BS_THREADS / (BS_COLS / 2)) {
    const float* at = part + ml * BS_PLD + nl;
    float2 v = *reinterpret_cast<const float2*>(S > 1 ? cluster.map_shared_rank(at, 0) : at);
    for (int q = 1; q < S; ++q) {        // rank order
      const float2 t = *reinterpret_cast<const float2*>(cluster.map_shared_rank(at, q));
      v.x = __fadd_rn(v.x, t.x);
      v.y = __fadd_rn(v.y, t.y);
    }
    if constexpr (COLS) {                // once, after the K reduction
      const float c2 = 2.f * sumx[m0 + ml];
      v.x = __fmul_rn(__fsub_rn(v.x, c2), cscale[n]);
      v.y = __fmul_rn(__fsub_rn(v.y, c2), cscale[n + 1]);
    }
    const size_t o = (size_t)(m0 + ml) * N + n;
    if (bf16_out) {
      const __nv_bfloat16* rb = static_cast<const __nv_bfloat16*>(resid);
      __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out);
      if (rb != nullptr) {
        v.x = __fadd_rn(v.x, load_f32(rb, o));
        if (n + 1 < N) v.y = __fadd_rn(v.y, load_f32(rb, o + 1));
      }
      if (pair) {
        *reinterpret_cast<__nv_bfloat162*>(ob + o) =
            __halves2bfloat162(__float2bfloat16_rn(v.x), __float2bfloat16_rn(v.y));
      } else {
        ob[o] = __float2bfloat16_rn(v.x);
        if (n + 1 < N) ob[o + 1] = __float2bfloat16_rn(v.y);
      }
    } else {
      const float* rf = static_cast<const float*>(resid);
      float* of = static_cast<float*>(out);
      if (rf != nullptr) {
        v.x = __fadd_rn(v.x, rf[o]);
        if (n + 1 < N) v.y = __fadd_rn(v.y, rf[o + 1]);
      }
      if (pair) {
        *reinterpret_cast<float2*>(of + o) = v;
      } else {
        of[o] = v.x;
        if (n + 1 < N) of[o + 1] = v.y;
      }
    }
  }
  if (S > 1) cluster.sync();             // no block leaves while it is read
}

template <int BT, int MODE>
cudaError_t launch_bs_gemm(const CUtensorMap (&maps)[4], int M, int Kp, int Np,
                           int lut_bias, const void* resid, void* out, int N,
                           int bf16_out, const float* sumx, const float* cscale,
                           int split, cudaStream_t stream) {
  auto kern = blockscale_gemm<BT, MODE>;
  static bool smem_set = false;           // once, before any graph capture
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         BsTile<BT, MODE>::SMEM);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((Np + BS_COLS - 1) / BS_COLS, (M + BT - 1) / BT, split);
  cfg.blockDim = dim3(BS_THREADS, 1, 1);
  cfg.dynamicSmemBytes = BsTile<BT, MODE>::SMEM;
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
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, maps[0], maps[1], maps[2], maps[3], M,
                                     Kp, Np, lut_bias, resid, out, N, bf16_out, sumx,
                                     cscale);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// the GEMM's tensor maps: the bf16 rows xb [M, xw] (row stride xb_ld
// values; boxes of 64 values x bt rows, 128-byte swizzle; values past xw
// and rows past M read as zeros), the words [Kp/16, Np] (16 rows of BS_WLD
// columns, zeros past Np), the scales [Kp/32, Np] (8 rows of 128 columns;
// K6: none, the map repeats the words') and, for K10, the split block sums
// [M, Kp/8] (boxes of 8 values x bt rows; without them the fourth map
// repeats the third, unread);
// then the launch with bt rows a block and K split over split blocks
template <int MODE>
cudaError_t launch_bs(const __nv_bfloat16* xb, int xw, int xb_ld, const __nv_bfloat16* sums,
                      int M, int Kp, const int* words, int Np, const float* scales,
                      int lut_bias, const void* resid, void* out, int N, int bf16_out,
                      const float* sumx, int bt, int split, cudaStream_t stream) {
  CUtensorMap maps[4];
  cudaError_t e = tma_map_2d(&maps[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, xb, xw, M,
                             (uint64_t)xb_ld * 2, 64, bt, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == cudaSuccess)
    e = tma_map_2d(&maps[1], CU_TENSOR_MAP_DATA_TYPE_INT32, words, Np, Kp / 16,
                   (uint64_t)Np * 4, BS_WLD, KT / 16, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e == cudaSuccess) {
    if (MODE == W_COLSCALE)
      maps[2] = maps[1];
    else
      e = tma_map_2d(&maps[2], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scales, Np, Kp / 32,
                     (uint64_t)Np * 4, BS_COLS, KT / 32, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (e == cudaSuccess) {
    if (MODE == W_BLOCK)
      e = tma_map_2d(&maps[3], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, sums, Kp / 8, M,
                     (uint64_t)(Kp / 8) * 2, 8, bt, CU_TENSOR_MAP_SWIZZLE_NONE);
    else
      maps[3] = maps[2];
  }
  if (e != cudaSuccess) return e;
  const float* cscale = MODE == W_COLSCALE ? scales : nullptr;
#define BN_BS(BTV)                                                                  \
  launch_bs_gemm<BTV, MODE>(maps, M, Kp, Np, lut_bias, resid, out, N, bf16_out, sumx, \
                            cscale, split, stream)
  switch (bt) {
    case 8: return BN_BS(8);
    case 16: return BN_BS(16);
    case 32: return BN_BS(32);
    case 64: return BN_BS(64);
    case 128: return BN_BS(128);
    default: return cudaErrorInvalidValue;
  }
#undef BN_BS
}

// the shape checks of both GEMM entries
bool bs_shape_ok(int M, int Kp, int Np, int N, int bt, int split) {
  return M >= 1 && Kp > 0 && Kp % KT == 0 && Np % 64 == 0 && N >= 1 && N <= Np
      && split >= 1 && split <= BS_MAX_SPLIT && (split & (split - 1)) == 0
      && split <= Kp / KT && (bt == 8 || bt == 16 || bt == 32 || bt == 64 || bt == 128);
}

// ---------------------------------------------------------------------------
// K10's row kernel, the first of its GEMM form's two launches: x [M, K]
// (row stride x_stride, its own dtype) rounded to bf16 into xb [M, Kp], zero
// past K, and the f32 sums of each 32 of those bf16 values into sum32
// [M, Kp/32] (what the JAX wrappers form in XLA, :533-538, :1159-1166),
// and split as the GEMM's correction reads them: sums [M, Kp/8] bf16, a K
// tile's 32 values (hi of its 8 blocks, lo, hi, lo).
// Block (m, i): 256 threads of 8 consecutive values, values 2048 i .. of
// row m; four lanes hold a 32-row block.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
blockscale_rows(const T* __restrict__ x, int x_stride, int K, int Kp,
                __nv_bfloat16* __restrict__ xb, float* __restrict__ sum32,
                __nv_bfloat16* __restrict__ sums) {
  const int m = blockIdx.x;
  const int k0 = blockIdx.y * 2048 + threadIdx.x * 8;
  if (k0 >= Kp) return;                  // whole warps: Kp % 256 == 0
  const T* xr = x + (size_t)m * x_stride;
  uint32_t pk[4];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + 2 * i;
    const __nv_bfloat162 b = __floats2bfloat162_rn(k < K ? load_f32(xr, k) : 0.f,
                                                   k + 1 < K ? load_f32(xr, k + 1) : 0.f);
    s = __fadd_rn(__fadd_rn(s, __low2float(b)), __high2float(b));
    pk[i] = *reinterpret_cast<const uint32_t*>(&b);
  }
  *reinterpret_cast<uint4*>(xb + (size_t)m * Kp + k0) = make_uint4(pk[0], pk[1], pk[2], pk[3]);
  s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 1));
  s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, 2));
  if ((threadIdx.x & 3) == 0) {
    const int kb = k0 >> 5, b = kb & 7;
    sum32[(size_t)m * (Kp / 32) + kb] = s;
    __nv_bfloat16 hi, lo;
    split_bf16(s, hi, lo);
    __nv_bfloat16* q = sums + (size_t)m * (Kp / 8) + (kb >> 3) * 32;
    q[b] = q[16 + b] = hi;
    q[8 + b] = q[24 + b] = lo;
  }
}

// ---------------------------------------------------------------------------
// K6's row kernel, the first of its GEMM form's two launches: the f32 sum of
// row m of x [M, K] (row stride x_stride, its own dtype) rounded to bf16,
// into sumx[m] (what the JAX wrapper forms in XLA, :1114-1121), and, where
// xb is not null (the GEMM cannot read x itself), those bf16 values
// zero-padded to Kp into xb [M, Kp].  One block of 256 threads a row, 8
// consecutive values a thread at a time; the sum in a fixed order.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
colscale_rows(const T* __restrict__ x, int x_stride, int K, int Kp,
              __nv_bfloat16* __restrict__ xb, float* __restrict__ sumx) {
  __shared__ float red[32];
  const int m = blockIdx.x;
  const T* xr = x + (size_t)m * x_stride;
  const int kend = xb != nullptr ? Kp : K;
  float s = 0.f;
  for (int k0 = threadIdx.x * 8; k0 < kend; k0 += 256 * 8) {
    uint32_t pk[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + 2 * i;
      const __nv_bfloat162 b = __floats2bfloat162_rn(k < K ? load_f32(xr, k) : 0.f,
                                                     k + 1 < K ? load_f32(xr, k + 1) : 0.f);
      s = __fadd_rn(__fadd_rn(s, __low2float(b)), __high2float(b));
      pk[i] = *reinterpret_cast<const uint32_t*>(&b);
    }
    if (xb != nullptr)
      *reinterpret_cast<uint4*>(xb + (size_t)m * Kp + k0) =
          make_uint4(pk[0], pk[1], pk[2], pk[3]);
  }
  s = block_reduce(s, red, false);
  if (threadIdx.x == 0) sumx[m] = s;
}

// ---------------------------------------------------------------------------
// K12 preamble: one block per row m, 512 threads: silu(gate) * up, RMSNorm,
// bf16 rows [M, K].  x is [M, K] (or [M, 2K] when glu).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(512)
bf16_rows(const T* __restrict__ x, int x_stride, int K, int glu,
          const float* __restrict__ gamma, float eps,
          __nv_bfloat16* __restrict__ xb) {
  extern __shared__ float row[];         // K floats
  __shared__ float redf[32];
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
  float r = 1.f;
  if (gamma != nullptr) {                // RMSNorm: (x * rsqrt(mean + eps)) * g
    const float var = block_reduce(ss, redf, false) / (float)K;
    r = 1.f / sqrtf(var + eps);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float v = gamma != nullptr ? __fmul_rn(__fmul_rn(row[k], r), gamma[k]) : row[k];
    xb[(size_t)m * K + k] = __float2bfloat16_rn(v);
  }
}

// ---------------------------------------------------------------------------
// A lane's words of half tile ht (8 word rows of column n; zeros past the
// last half tile), and with tl_load_half their four block scales, read from
// global memory (K10's decode form keeps the next half tile's in flight).
// ---------------------------------------------------------------------------
__device__ __forceinline__ void load_words_half(int ht, int halves,
                                                const int* __restrict__ words, int Np, int n,
                                                int (&w)[8]) {
  const int t = ht >> 1, h = ht & 1;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i] = ht < halves ? __ldg(words + (size_t)(t * 16 + 8 * h + i) * Np + n) : 0;
}

__device__ __forceinline__ void tl_load_half(int ht, int halves, const int* __restrict__ words,
                                             const float* __restrict__ scales, int Np, int n,
                                             int (&w)[8], float (&s)[4]) {
  const int t = ht >> 1, h = ht & 1;
  load_words_half(ht, halves, words, Np, n, w);
#pragma unroll
  for (int p = 0; p < 4; ++p)
    s[p] = ht < halves ? __ldg(scales + (size_t)(t * 8 + 2 * p + h) * Np + n) : 0.f;
}

// ---------------------------------------------------------------------------
// K10 decode form: grid (split, Np / 32), cluster (split, 1, 1); W warps a
// block.  Block s of a cluster takes half tiles [h0, h1) of its 32 columns
// (the split of Kp / 128 half tiles); warp w takes half tiles h0 + w,
// h0 + w + W, ... (8 word rows = 4 scale blocks of 32 K rows),
// the next one's words, scales and rows of x in flight while it computes
// one.  A warp stages its half tile's rows of x in its own slice of shared
// memory (bf16-rounded f32; rows past M and K are 0) and forms their 32-row
// sums there, so warps never wait for each other until the end: the warps'
// partials are added in warp order, then the cluster's in rank order, each
// block adding a share of the outputs through distributed shared memory.
// K6 (W_COLSCALE) reads no scales in the loop: each warp adds its rows'
// 32-row sums into whole-row sums, which are added over the warps and the
// ranks in the same orders, and the output is (acc - 2 sum) * s[n].
// ---------------------------------------------------------------------------
constexpr int DEC_MAX_M = 16;
constexpr int DEC_MAX_WARPS = 8;
constexpr int DEC_MAX_SPLIT = 8;          // the portable cluster size

__host__ __device__ constexpr size_t decode_smem(int warps, int mr) {
  return (size_t)warps * mr * (128 + 4 + 32 + 1) * sizeof(float)
       + (size_t)mr * (32 + 1) * sizeof(float);
}

// lo / hi: byte c holds the low / high byte of the bf16 weight of code c,
// bf16(v(c) * s); code 0 (biased value 0) is +0
template <bool LUT_BIAS>
__device__ __forceinline__ void weight_bytes(float s, unsigned& lo, unsigned& hi) {
  unsigned b[4];
#pragma unroll
  for (int c = 1; c < 4; ++c)
    b[c] = __bfloat16_as_ushort(
        __float2bfloat16_rn(__fmul_rn((float)(LUT_BIAS ? c + (c >> 1) : c), s)));
  const unsigned p12 = b[1] | (b[2] << 16);
  lo = __byte_perm(p12, b[3], 0x4206);    // {0, b1.lo, b2.lo, b3.lo}
  hi = __byte_perm(p12, b[3], 0x5316);    // {0, b1.hi, b2.hi, b3.hi}
}

// the lane's 4 * MR values of x for half tile ht: K row (ht/2)*256 + p*64 +
// 32*(ht%2) + lane of row m in xv[m * 4 + p]
template <int MR, typename T>
__device__ __forceinline__ void load_x_half(const T* __restrict__ x, int M, int K, int ht,
                                            int h1, int lane, float (&xv)[4 * MR]) {
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int k = (ht >> 1) * KT + p * 64 + 32 * (ht & 1) + lane;
      xv[m * 4 + p] = ht < h1 && m < M && k < K ? load_f32(x, (size_t)m * K + k) : 0.f;
    }
}

// scales: block scales [Kp/32, Np] (W_BLOCK) or column scales [Np] (W_COLSCALE)
template <int MR, int MODE, bool LUT_BIAS, typename T>
__global__ void __launch_bounds__(DEC_MAX_WARPS * 32)
blockscale_decode(const T* __restrict__ x, int M, int K, int Kp,
                  const int* __restrict__ words, int Np,
                  const float* __restrict__ scales, T* __restrict__ out, int N) {
  constexpr bool COLS = MODE == W_COLSCALE;
  static_assert(MODE != W_UNBIASED, "the decode form takes biased values");
  extern __shared__ __align__(16) float dsm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int W = blockDim.x >> 5, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* xw = dsm + warp * MR * 128;                // this warp's rows [MR][128]
  float* sw = dsm + W * MR * 128 + warp * MR * 4;   // their 32-row sums [MR][4]
  float* red = dsm + W * MR * 132;                  // the warps' partials [W][MR][32]
  float* part = red + W * MR * 32;                  // the block's [MR][32]
  float* redx = part + MR * 32;                     // K6: the warps' row sums [W][MR]
  float* partx = redx + W * MR;                     // K6: the block's [MR]
  const int S = gridDim.x, units = Kp / 128;
  const int h0 = (int)((long long)blockIdx.x * units / S);
  const int h1 = (int)((long long)(blockIdx.x + 1) * units / S);
  const int n = blockIdx.y * 32 + lane;
  constexpr bool X_AHEAD = MR <= 8;                 // 16 rows ahead would spill
  float y[MR], corr[MR];                            // K6: corr holds the row sums
#pragma unroll
  for (int m = 0; m < MR; ++m) y[m] = corr[m] = 0.f;
  int wv[8];
  float sv[4], xv[4 * MR];
  if constexpr (COLS) load_words_half(h0 + warp, h1, words, Np, n, wv);   // in flight
  else tl_load_half(h0 + warp, h1, words, scales, Np, n, wv, sv);
  if constexpr (X_AHEAD) load_x_half<MR>(x, M, K, h0 + warp, h1, lane, xv);

  for (int ht = h0 + warp; ht < h1; ht += W) {
    int wn[8];
    float sn[4], xn[4 * MR];
    if constexpr (COLS) load_words_half(ht + W, h1, words, Np, n, wn);
    else tl_load_half(ht + W, h1, words, scales, Np, n, wn, sn);
    if constexpr (X_AHEAD) load_x_half<MR>(x, M, K, ht + W, h1, lane, xn);
    else load_x_half<MR>(x, M, K, ht, h1, lane, xv);
#pragma unroll
    for (int i = 0; i < 4 * MR; ++i)
      xw[i * 32 + lane] = __bfloat162float(__float2bfloat16_rn(xv[i]));
    __syncwarp();
    for (int l = lane; l < 4 * MR; l += 32) {   // 32-row sums, a fixed order
      const float* b = xw + l * 32;               // (rotated: no bank conflicts)
      float a = 0.f;
#pragma unroll 8
      for (int j = 0; j < 32; ++j) a = __fadd_rn(a, b[(j + l) & 31]);
      sw[l] = a;
    }
    __syncwarp();
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      unsigned lo = COLS_LO, hi = COLS_HI;
      if constexpr (COLS) {
#pragma unroll
        for (int m = 0; m < MR; ++m) corr[m] = __fadd_rn(corr[m], sw[m * 4 + p]);
      } else {
        weight_bytes<LUT_BIAS>(sv[p], lo, hi);
#pragma unroll
        for (int m = 0; m < MR; ++m) corr[m] = fmaf(sw[m * 4 + p], sv[p], corr[m]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        // byte j of u: the selector nibbles (c, c + 4) of code c of K row
        // 4i + j of the block
        const unsigned u =
            ((((unsigned)wv[i] >> (2 * p)) & 0x03030303u) * 0x11u) + 0x40404040u;
        float wf[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wf[j] = __uint_as_float(__byte_perm(lo, hi, __byte_perm(u, 0u, 0x4404u | (j << 4))));
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          const float4 x4 = *reinterpret_cast<const float4*>(xw + m * 128 + p * 32 + 4 * i);
          y[m] = fmaf(x4.x, wf[0], y[m]);
          y[m] = fmaf(x4.y, wf[1], y[m]);
          y[m] = fmaf(x4.z, wf[2], y[m]);
          y[m] = fmaf(x4.w, wf[3], y[m]);
        }
      }
    }
    __syncwarp();                                   // xw is restaged next
#pragma unroll
    for (int i = 0; i < 8; ++i) wv[i] = wn[i];
    if constexpr (!COLS) {
#pragma unroll
      for (int p = 0; p < 4; ++p) sv[p] = sn[p];
    }
    if constexpr (X_AHEAD) {
#pragma unroll
      for (int i = 0; i < 4 * MR; ++i) xv[i] = xn[i];
    }
  }
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    red[(warp * MR + m) * 32 + lane] = COLS ? y[m] : __fsub_rn(y[m], 2.f * corr[m]);
    if (COLS && lane == 0) redx[warp * MR + m] = corr[m];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < MR * 32; i += blockDim.x) {
    float a = 0.f;
    for (int w = 0; w < W; ++w) a = __fadd_rn(a, red[(w * MR + i / 32) * 32 + (i & 31)]);
    part[i] = a;
  }
  if (COLS && threadIdx.x < MR) {
    float a = 0.f;
    for (int w = 0; w < W; ++w) a = __fadd_rn(a, redx[w * MR + threadIdx.x]);
    partx[threadIdx.x] = a;
  }
  cluster.sync();                                   // every block's partial is in place
  // output i = m * 32 + column is added by rank i % S, in rank order
  const int rank = (int)cluster.block_rank();
  for (int i = threadIdx.x * S + rank; i < M * 32; i += blockDim.x * S) {
    float v[DEC_MAX_SPLIT];
#pragma unroll
    for (int r = 0; r < DEC_MAX_SPLIT; ++r)
      v[r] = r < S ? cluster.map_shared_rank(part, r)[i] : 0.f;
    float a = v[0];
#pragma unroll
    for (int r = 1; r < DEC_MAX_SPLIT; ++r)
      if (r < S) a = __fadd_rn(a, v[r]);
    const int nc = blockIdx.y * 32 + (i & 31);
    if constexpr (COLS) {                           // the whole row's sum, once
#pragma unroll
      for (int r = 0; r < DEC_MAX_SPLIT; ++r)
        v[r] = r < S ? cluster.map_shared_rank(partx, r)[i / 32] : 0.f;
      float sx = v[0];
#pragma unroll
      for (int r = 1; r < DEC_MAX_SPLIT; ++r)
        if (r < S) sx = __fadd_rn(sx, v[r]);
      if (nc < N) a = __fmul_rn(__fsub_rn(a, 2.f * sx), scales[nc]);
    }
    if (nc < N) store_f32(out, (size_t)(i / 32) * N + nc, a);
  }
  cluster.sync();                                   // no block leaves while read
}

// split (cluster size) and warps a block for Kp x Np: split K only while
// the column blocks leave fewer than two blocks an SM; rounds of at most
// DEC_MAX_WARPS half tiles, balanced
void decode_plan(int Kp, int Np, int sms, int* split, int* warps) {
  const int units = Kp / 128, cb = Np / 32;
  int s = 1;
  while (s < DEC_MAX_SPLIT && cb * s < 2 * sms && units >= 2 * s) s *= 2;
  const int per = (units + s - 1) / s;
  const int rounds = (per + DEC_MAX_WARPS - 1) / DEC_MAX_WARPS;
  *split = s;
  *warps = (per + rounds - 1) / rounds;
}

template <int MR, int MODE, bool LUT_BIAS, typename T>
cudaError_t launch_decode(const void* x, int M, int K, int Kp, const int* words,
                          int Np, const float* scales, void* out, int N, int split,
                          int warps, cudaStream_t stream) {
  auto kern = blockscale_decode<MR, MODE, LUT_BIAS, T>;
  static bool smem_set = false;           // once, before any graph capture
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)decode_smem(DEC_MAX_WARPS, MR));
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, Np / 32, 1);
  cfg.blockDim = dim3(32 * warps, 1, 1);
  cfg.dynamicSmemBytes = decode_smem(warps, MR);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(x), M, K, Kp,
                                     words, Np, scales, static_cast<T*>(out), N);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int MODE, bool LUT_BIAS, typename T>
cudaError_t launch_decode_rows(const void* x, int M, int K, int Kp, const int* words,
                               int Np, const float* scales, void* out, int N,
                               cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  int split, warps;
  decode_plan(Kp, Np, sms, &split, &warps);
#define BN_DEC(MRV) \
  return launch_decode<MRV, MODE, LUT_BIAS, T>(x, M, K, Kp, words, Np, scales, out, N, split, \
                                               warps, stream)
  if (M <= 1) BN_DEC(1);
  if (M <= 2) BN_DEC(2);
  if (M <= 4) BN_DEC(4);
  if (M <= 8) BN_DEC(8);
  BN_DEC(16);
#undef BN_DEC
}

template <typename T>
cudaError_t launch_tl_bf16(const void* x, int x_stride, int M, int K, int glu,
                           const float* gamma, float eps, const int* words, int Np,
                           const float* scales, const void* resid, void* out,
                           int N, __nv_bfloat16* xb, int lut_bias, int bt, int split,
                           cudaStream_t stream) {
  const size_t smem = (size_t)K * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bf16_rows<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  bf16_rows<T><<<M, 512, smem, stream>>>(static_cast<const T*>(x), x_stride, K,
                                         glu, gamma, eps, xb);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_bs<W_UNBIASED>(xb, K, K, nullptr, M, K, words, Np, scales, lut_bias, resid,
                               out, N, std::is_same<T, __nv_bfloat16>::value, nullptr, bt,
                               split, stream);
}

template <typename T>
cudaError_t launch_blockscale_gemm(const void* x, int x_stride, int M, int K, int Kp,
                                   const int* words, int Np, const float* scales,
                                   void* out, int N, __nv_bfloat16* xb, float* sum32,
                                   __nv_bfloat16* sums, int lut_bias, int bt, int split,
                                   cudaStream_t stream) {
  blockscale_rows<T><<<dim3(M, (Kp + 2047) / 2048), 256, 0, stream>>>(
      static_cast<const T*>(x), x_stride, K, Kp, xb, sum32, sums);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_bs<W_BLOCK>(xb, Kp, Kp, sums, M, Kp, words, Np, scales, lut_bias, nullptr,
                            out, N, std::is_same<T, __nv_bfloat16>::value, nullptr, bt,
                            split, stream);
}

// K6's GEMM form: the row kernel, then the GEMM in column-scale mode; with
// xb null the GEMM reads x (bf16) itself, K values a row, x_stride apart
template <typename T>
cudaError_t launch_colscale_gemm(const void* x, int x_stride, int M, int K, int Kp,
                                 const int* words, int Np, const float* scale, void* out,
                                 int N, __nv_bfloat16* xb, float* sumx, int bt, int split,
                                 cudaStream_t stream) {
  colscale_rows<T><<<M, 256, 0, stream>>>(static_cast<const T*>(x), x_stride, K, Kp, xb,
                                          sumx);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const bool copy = xb != nullptr;
  return launch_bs<W_COLSCALE>(copy ? xb : static_cast<const __nv_bfloat16*>(x),
                               copy ? Kp : K, copy ? Kp : x_stride, nullptr, M, Kp, words,
                               Np, scale, 1, nullptr, out, N,
                               std::is_same<T, __nv_bfloat16>::value, sumx, bt, split,
                               stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, resid and out share it).  Each entry
// returns cudaGetLastError() after its launches.

// K10's GEMM form (more rows than the decode form takes): x [M, K] in its
// own dtype (row stride x_stride) rounded to bf16 into xb [M, Kp] (zero past
// K) with its 32-row sums sum32 [M, Kp/32] and their bf16 split sums
// [M, Kp/8] (scratch the wrapper allocates), then the GEMM with bt rows a
// block (8, 16, 32, 64 or 128) and K split over split blocks of a cluster
// (1, 2, 4 or 8, at most Kp / 256), the correction inside; scales f32
// [Kp/32, Np] of the layer; out [M, N].  Two launches.
int bn_blockscale_gemm(const void* x, int x_stride, int M, int K, int Kp,
                       const int* words, int Np, const float* scales, void* out,
                       int N, __nv_bfloat16* xb, float* sum32, __nv_bfloat16* sums,
                       int lut_bias, int dtype, int bt, int split, cudaStream_t stream) {
  if (!bs_shape_ok(M, Kp, Np, N, bt, split) || K < 1 || K > Kp || x_stride < K)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return (int)launch_blockscale_gemm<__nv_bfloat16>(x, x_stride, M, K, Kp, words, Np,
                                                      scales, out, N, xb, sum32, sums,
                                                      lut_bias, bt, split, stream);
  return (int)launch_blockscale_gemm<float>(x, x_stride, M, K, Kp, words, Np, scales,
                                            out, N, xb, sum32, sums, lut_bias, bt, split,
                                            stream);
}

// K10's decode form: x [M, K] in its own dtype (rounded to bf16 here, rows
// past K read as 0), M <= 16; the correction inside; out [M, N].  One launch.
int bn_blockscale_decode(const void* x, int M, int K, int Kp, const int* words,
                         int Np, const float* scales, void* out, int N, int lut_bias,
                         int dtype, cudaStream_t stream) {
  if (M < 1 || M > DEC_MAX_M || Kp % KT || K < 1 || K > Kp || Np % 32 || N > Np)
    return (int)cudaErrorInvalidValue;
#define BN_D(LB, TT) \
  return (int)launch_decode_rows<W_BLOCK, LB, TT>(x, M, K, Kp, words, Np, scales, out, N, stream)
  if (dtype == 1) {
    if (lut_bias) BN_D(true, __nv_bfloat16);
    BN_D(false, __nv_bfloat16);
  }
  if (lut_bias) BN_D(true, float);
  BN_D(false, float);
#undef BN_D
}

// K6's decode form: x [M, K] in its own dtype (rounded to bf16 here, rows
// past K read as 0), M <= 16; scale f32 [Np], one a column; out [M, N] in
// x's dtype.  One launch.
int bn_colscale_decode(const void* x, int M, int K, int Kp, const int* words, int Np,
                       const float* scale, void* out, int N, int dtype,
                       cudaStream_t stream) {
  if (M < 1 || M > DEC_MAX_M || Kp % KT || K < 1 || K > Kp || Np % 32 || N > Np)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return (int)launch_decode_rows<W_COLSCALE, true, __nv_bfloat16>(x, M, K, Kp, words, Np,
                                                                    scale, out, N, stream);
  return (int)launch_decode_rows<W_COLSCALE, true, float>(x, M, K, Kp, words, Np, scale,
                                                          out, N, stream);
}

// K6's GEMM form: x [M, K] in its own dtype (row stride x_stride); the row
// kernel writes the f32 sums of its bf16-rounded rows into sumx [M] and,
// where xb is not null, those rows zero-padded to Kp into xb [M, Kp]; with
// xb null the GEMM reads x itself (bf16, 16-byte aligned, x_stride * 2 a
// multiple of 16; values past K read as zeros).  Then the GEMM in
// column-scale mode, tiled as K10's (bt, split); scale f32 [Np]; out
// [M, N] in x's dtype.  Two launches.
int bn_colscale_gemm(const void* x, int x_stride, int M, int K, int Kp, const int* words,
                     int Np, const float* scale, void* out, int N, __nv_bfloat16* xb,
                     float* sumx, int dtype, int bt, int split, cudaStream_t stream) {
  if (!bs_shape_ok(M, Kp, Np, N, bt, split) || K < 1 || K > Kp || x_stride < K)
    return (int)cudaErrorInvalidValue;
  if (xb == nullptr && (dtype != 1 || (x_stride * 2) % 16 || (uintptr_t)x % 16))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return (int)launch_colscale_gemm<__nv_bfloat16>(x, x_stride, M, K, Kp, words, Np, scale,
                                                    out, N, xb, sumx, bt, split, stream);
  return (int)launch_colscale_gemm<float>(x, x_stride, M, K, Kp, words, Np, scale, out, N,
                                          xb, sumx, bt, split, stream);
}

// K12: K == Kp; xb bf16 [M, K] scratch for the preamble's rows; the GEMM
// tiled as K10's (bt, split).  Two launches.
int bn_tl_bf16_normed(const void* x, int x_stride, int M, int K, int glu,
                      const float* gamma, float eps, const int* words, int Np,
                      const float* scales, const void* resid, void* out, int N,
                      __nv_bfloat16* xb, int lut_bias, int dtype, int bt, int split,
                      cudaStream_t stream) {
  if (!bs_shape_ok(M, K, Np, N, bt, split)) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return (int)launch_tl_bf16<__nv_bfloat16>(x, x_stride, M, K, glu, gamma, eps,
                                              words, Np, scales, resid, out, N,
                                              xb, lut_bias, bt, split, stream);
  return (int)launch_tl_bf16<float>(x, x_stride, M, K, glu, gamma, eps, words, Np,
                                    scales, resid, out, N, xb, lut_bias, bt, split,
                                    stream);
}

const char* bn_ternary_matmul_tl_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
