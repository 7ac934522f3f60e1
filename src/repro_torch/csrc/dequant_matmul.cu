// K1 fused dequant-matmul: out = x @ W where W exists only as uniform Q_x
// codes (int8, int16, or 2/3/4/6-bit lanes packed per row) plus one f32
// scale. The full-precision weight never reaches device memory.
//
// Replaces repro/comm/matmul.py _matmul_pallas (_mm_body, _mm_lut_body).
// On the TPU each grid step held the whole (M, K) activation in VMEM and
// one column tile of codes, and the LUT body read sub-8-bit values from an
// SMEM table. Here the dequantization happens in registers, exactly as the
// reference's cast chain does it: (c / 2^k) * s, then rounded to the leaf
// dtype, then to the activation dtype, so the weight each product sees is
// bitwise the plain version's.
//
// Bound: at decode (M = slots, a few rows) and chunked prefill (M = 32)
// the work is ~2 M flops per code byte, far below the card's ~295
// flop/byte balance point, so K1 is bound by the bytes of codes it
// streams: (4096, 11008) int8 is 45 MB, 0.0135 ms at the H100 SXM's
// 3.35 TB/s (data sheet, 700 W).
//
// Tensor-core route, rt_dequant_matmul_tc (namespace tc): bf16 activations
// against int8 / int16 codes or packed 2/3/4/6-bit lanes whose weight is a
// bf16 number (the leaf or the pending cast is bf16), so
// mma.sync.m16n8k16 (bf16 operands, fp32 accumulators) forms exactly the
// plain version's products; only the order of the sum differs. One pass
// over the codes for M <= 64: x is staged in 16-row MMA tiles with zero
// rows past M, so each code byte is read once per call (M > 64 takes a row
// tile per 64 rows). A block of 4 or 8 warps owns 128 or 256 output
// columns and a slice of K; codes and x stream through a 4-stage ring of
// 16-byte cp.async copies (64 K rows a stage). The resident layout stays
// the reference's (K, N) rows, packed lanes included: a thread reads the
// 4 codes of columns 4g .. 4g+3 of each staged row with one shared load
// (4 bytes of int8, 8 of int16; a byte of 2-bit lanes, 2 bytes of 4-bit
// ones, one whole 3-byte group of 6-bit lanes, half an 8-code 3-byte
// group of 3-bit lanes, the last two through a funnel shift over two
// words) from a row padded so that a warp's rows fall in distinct banks,
// and the warp's four n8 MMA tiles are interleaved over its 32 columns
// (MMA column g of tile j is column 4g + j), so those 4 codes are one
// B-fragment element of each tile and the C fragment holds 8 contiguous
// output columns. Each code
// becomes its weight without a conversion instruction (see Deq): the
// packed lanes are stored biased already (comm/bits.py), so their codes
// splice into the mantissa as they are. The tensor cores sum a stage's 64
// products of an output from zero and the result is added to the running
// fp32 sum with one IEEE rounding: the MMA's truncating accumulation never
// sees the large partial sum, so the error stays at fp32 summation-order
// size (the tier's floor). Where the column tiles alone cannot fill the
// 132 SMs (wk, wv, wq, wo, gemma2's projections), K is cut into slices
// (comm/matmul.py k1_plan) whose fp32 partial sums go to a workspace; a
// second kernel folds them in a fixed order and rounds once. No atomics:
// the result is deterministic. Rows whose bytes are no multiple of 16 (a
// ragged N of packed lanes, N = 1001) are staged byte by byte, masked at
// the row's end; they stay on this route.
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W; PERF.md section
// 6): (4096, 11008) int8 at M = 4 in 0.0247 ms (55 % of the byte bound)
// and at M = 32 in 0.0318 ms, against 0.0341 and 0.0343 for torch.matmul
// on the dequantized bf16 weight, which reads twice the bytes; gemma2's
// small projections at M = 32 are latency-bound, up to 1.56x it. The
// packed lanes' times are in PERF.md.
//
// CUDA-core route, rt_dequant_matmul (namespace fm): float32 activations
// against a float32 weight, or a bf16 one where the activations are
// float32, and bf16 activations against a float32 weight, on every code
// type (an fp32 product on tensor cores would be TF32, not the plain
// version's). Products are fp32 fmaf. Bound: at M = 4 the bytes of codes
// ((4096, 11008) int8: 0.0135 ms); at M = 32 the fp32 FMAs (2.89 GFLOP,
// 0.043 ms at 66.9 TFLOP/s). The first kernel reached 25 % of the
// byte bound: a block of 32 columns walked all of K in 512-row chunks, two
// block barriers a chunk, no chunk's loads in flight during another's
// math, 4-byte code loads, N / 32 blocks (32 to 128 at the serving
// shapes: less than one wave), and x tiled 4 or 8 rows at a time (each
// code byte read 4 times at M = 32). Now:
// - a block owns 128 output columns, all of x's rows up to 32 (one row
//   tile: each code byte read once for M <= 32; m_tile 4, 8, 16 or 32)
//   and one slice of K; comm/matmul.py fma_plan splits K until the blocks
//   fill the 132 SMs, the slices' partial sums folded by
//   tc::k1_fold_kernel in slice order;
// - x's rows of the slice are staged once, as floats (float32 rows by
//   cp.async, every copy in flight), while the first step's code loads
//   are in flight; then each warp group streams its steps of the slice
//   (8 to 64 code rows of the block's 128 columns, two or four 16-byte
//   ld.global.nc a lane, through a staging buffer of its own), the next
//   step's loads in flight while this one is multiplied, with no block
//   barrier in the loop; the groups' sums fold in group order at the end;
// - lane l owns columns 4l .. 4l+3: one shared load gives it their 4
//   codes of a row, which become weights as on the tensor cores (tc::Deq:
//   the biased code spliced into a float's mantissa, the exact base
//   subtracted, one multiply by s: (c 2^-k) s bit for bit, no conversion
//   instruction), then one bf16 rounding where the weight is bf16; one
//   16-byte shared load gives 4 K rows of x for each of its rows. A
//   weight costs ~3 ALU instructions plus m_tile FMAs, and a quarter of a
//   shared load each for its codes and for x: ~7.6 at M = 4 against ~9
//   that 128 issue slots allow at 14 int8 weights a clock an SM;
// - at 32 rows the two warps of a group split x's rows (16 each: 64
//   accumulators a lane, two blocks an SM at 128 registers) and share one
//   double-buffered step, met at a named barrier; with all 32 rows a warp
//   (128 accumulators, one block an SM) it was slower.
// Ragged N (rows of no whole 16 bytes load byte by byte), K and M are
// masked; the order of every sum is fixed (no atomics): deterministic.
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W; PERF.md section
// 6): (4096, 11008) int8 at M = 4 in 0.0261 ms (52 % of the byte bound;
// the first kernel 0.0544, fp32 torch.matmul 0.0908) and at M = 32 in
// 0.1155 ms (the first kernel 0.354; the library 0.1270; 37 % of the
// 0.043 ms FMA floor: the goal of twice that floor is missed). At M = 32
// the FMA loop issues at about half rate: removing x's shared loads (an
// uncommitted probe) gained 15 %, removing the dequantization 3 %; other
// loop orders and an exact I2F weight gained nothing. gemma2's small
// projections at M = 32 are latency-bound (the fold is a second launch,
// x staged per slice): 1.04x to 1.29x the library, faster than the first
// kernel; at M = 4 every timed shape is 0.3x to 0.6x the library.
//
// K1t, the transposed product: out = x @ W.T where W is (V, d) as code
// rows, the tied logit head of gemma2 (256000 rows of 2304 codes).
// Replaces the transposed branch of _matmul_pallas (_mm_t_body,
// repro/comm/matmul.py:150), which tiled code rows and needed V to be a
// multiple of its tile (_pallas_covers). Bound: at M = 4 the head reads
// 590 MB of int8 codes for 4.7 GFLOP, ~8 flops a byte, so the bytes of
// codes bound it: 0.176 ms at the H100 SXM's 3.35 TB/s (data sheet,
// 700 W), about 14 codes a clock per SM. Two routes, as K1's:
//
// Tensor-core route, rt_dequant_matmul_t_tc (namespace tt): bf16
// activations against a bf16 weight, every code type. It computes out.T
// (V, M) = W (V, d) x.T (d, M): 16 code rows are the A operand of
// mma.sync.m16n8k16 (row-major along d, the contracted axis, as they lie)
// and up to 8 activation rows one n8 B tile (NT tiles for M up to 32, a
// grid row per 32 more). The contracted index is permuted inside each
// chunk of d, in both operands alike (a sum over d does not see the
// order): a thread's codes of a row are one contiguous span (32 bytes of
// int8, int16 or 4-bit lanes: 8, 4 or 16 k steps; 16 bytes of 2-bit
// lanes; 48 bytes, whole groups, of 3- and 6-bit lanes), so each row
// costs 16-byte ld.global.nc loads, and x is staged
// once a block in shared memory already in B fragment order (one 8-byte
// load a k step, no bank conflict; 37 KB at d 2304, M <= 8). Codes go
// from device memory straight into registers, the next chunk's loads in
// flight while this one's weights are made: a warp walks two 16-row
// tiles (one for 3- and 6-bit spans), blocks are persistent over the
// row groups, and there is no barrier after the staging (K1's tensor-core
// route meets at one every 64 rows). Each code becomes its weight as in
// K1 (tc::Deq: the biased code spliced into the mantissa, the exact base
// subtracted, one multiply by the scale, one bf16 rounding in the pack),
// for 2- and 4-bit lanes one mask of a word puts four codes in four bytes
// for the byte permute, for 3 and 6 bits a funnel shift over two words.
// Count a weight's ALU instructions against the budget: at the bound an
// SM streams ~14 int8 codes a clock and issues 128 thread instructions,
// ~9 a weight; the kernel spends ~4 (byte permute, subtract, multiply,
// half a bf16x2 pack, a quarter of the bias XOR; plus a mask a word for
// packed lanes) and one MMA per 8 weights a thread. Narrow lanes carry
// 2-4 codes a byte, so the same ~4 instructions bound them before the
// bytes do. The MMA sums a stage's 64 products from zero and the result
// is added to the running fp32 sum with one IEEE rounding (K1's order and
// tier). Rows whose bytes are no multiple of 16 (ragged d, packed rows at
// odd widths) load byte by byte on the same route; ragged V and M are
// masked, x zero past d. Deterministic. d is limited by the staged x:
// 16 NT bytes a value of d in shared memory (d up to ~14,500 at M <= 8).
//
// CUDA-core route, rt_dequant_matmul_t (namespace ft): float32
// activations or float32 weights (on tensor cores TF32, not the plain
// version's product). Products are fp32 fmaf. At M = 4 the bytes of codes
// bound it as the tensor-core route (0.177 ms at gemma2's head); a weight
// costs the byte permute, subtract and multiply of tc::Deq plus M FMAs
// and 1/R of a shared load of x: ~7.5 instructions at M = 4 against the
// ~9 that 128 issue slots a clock allow at 14 int8 codes a clock an SM.
// The first K1t kernel reached 43 % of the bound: a warp's lanes streamed
// 4 rows along d, so gemma2's 2304-code rows were ~4.5 loads a lane, x was
// read again from the cache for every 4 rows (4 bytes of x a code), and
// each row paid a 5-step butterfly for each output. Now it takes the
// tensor-core route's structure with FMAs for the MMA: blocks persistent
// over groups of code rows, a thread's 32- or 48-byte span of R rows (4,
// or 2 of 3- and 6-bit lanes) of a chunk streamed from device memory into
// registers with the next chunk's loads in flight, x staged once a block
// in shared memory in the span's order (MT = 1, 4 or 8 activation rows a
// slot, one 16-byte shared load serving R rows), no barrier after the
// staging, and a quad's 4 sums folded by a 2-step butterfly once a row.
// Each output is summed in fp32 in an order fixed by d alone (a thread's
// products 32 at a time from zero, each such sum added to its running sum
// with one rounding, as the tensor-core routes order theirs); the weight
// each product sees is bitwise the plain version's cast chain, as in K1.
// Ragged V, d and M are masked (rows of no whole 16 bytes load byte by
// byte); d is limited by the staged x (comm/matmul.py t_fma_plan: about
// 7,000 at M > 4, 57,000 at M = 1).
// Measured times of both routes: PERF.md section 6 (chip_smoke.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "mma.cuh"

namespace {

using rt::cp_async16;
using rt::cp_async_commit;
using rt::cp_async_wait;
using rt::ldsm_x4;
using rt::mma_bf16;
using rt::pack_bf16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---------------------------------------------------------------------------
// K1 on tensor cores: bf16 activations, int8 / int16 codes, bf16 weights
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kBK = 64;        // K rows per pipeline stage
constexpr int kStages = 4;
constexpr int kXRow = kBK + 8;  // bf16 per staged x row (16 bytes of pad)

struct TArgs {
  const __nv_bfloat16* x;
  const uint8_t* codes;
  const float* scale;
  void* out;
  float* ws;      // (slices, M, N) fp32 partial sums when K is split
  int M, K, N;
  long long row_bytes;  // bytes of one code row: N codes of BITS bits
  int k_slice;    // K rows per slice, a multiple of 32
  int k_x;
  float inv_pow2;
  int vec_x;      // x rows 16-byte aligned: cp.async, else element loads
  int vec_c;      // code rows 16-byte aligned
  int vec_o;      // output rows 16-byte aligned
  int out_bf16;   // out is bf16 (else float32)
};

// A staged code row's stride: its bytes plus pad (a multiple of 16) such
// that rows 2t (t = 0..3), which one warp-wide load reads, start 8 banks
// apart: two rows are stride / 2 words, 8 or 24 mod 32 banks. A thread's
// word(s) of a row then share no bank with another row's (at most 8 words
// a row a warp: 6-bit lanes, 4 bytes of int8).
constexpr int crow_of(int row) {
  int c = row + 16;
  while ((c / 2) % 32 != 8 && (c / 2) % 32 != 24) c += 16;
  return c;
}

// a block: NW warps of 32 output columns each (NW = 4 or 8). Shared
// memory of one stage: codes [kBK][CROW] bytes (a row: the block's 32 NW
// codes of BITS bits, then pad), then x [16 MT][kXRow] bf16 (rows past M
// stay zero). The ring is 4 stages at every code width: narrower codes
// stage fewer bytes for the same MMA work, and more or longer stages for
// them (6 to 12 stages, 128 or 256 rows) did not move the time.
template <int BITS, int MT, int NW>
struct TLayout {
  static constexpr int THREADS = 32 * NW;
  static constexpr int BN = 32 * NW;
  static constexpr int RB = BN * BITS / 8;   // code bytes of a staged row
  static constexpr int CROW = crow_of(RB);
  static constexpr int CBYTES = kBK * CROW;
  static constexpr int XBYTES = 16 * MT * kXRow * 2;
  static constexpr int STAGE = CBYTES + XBYTES;
  static constexpr int SMEM = kStages * STAGE;
  static_assert(RB % 16 == 0, "whole 16-byte copies a staged row");
  static_assert(SMEM <= 232448, "a block's shared memory on sm_90");
};

// The weight of a code, the reference's cast chain (c / 2^k) * s up to
// the final bf16 rounding (done when packing), for every scale s. A code
// biased to unsigned u (u = c + 128 for int8, c + 32768 for int16; the
// packed lanes are stored biased, u = c + 2^(BITS-1)) is spliced into the
// low mantissa of a float whose exponent field is 150 - k: that float is
// (2^23 + u) 2^-k exactly, so subtracting the exact constant
// (2^23 + bias) 2^-k leaves c 2^-k exactly, and one multiply by s rounds
// it once, as the chain does. No int->float conversion (a quarter-rate
// instruction) and no branch on the scale.
struct Deq {
  uint32_t hi;   // bytes 2, 3 of the float: exponent field 150 - k
  uint32_t hi32; // the whole exponent word, (150 - k) << 23
  float base;    // (2^23 + bias) 2^-k
  float s;
  __device__ __forceinline__ float operator()(uint32_t bits) const {
    return (__uint_as_float(bits) - base) * s;
  }
};

// The four codes at columns 4g .. 4g+3 of one staged code row, as
// weights; `at` is the thread's offset into the row: bytes for int8 /
// int16 (4g CB), bits for the packed lanes (4g BITS).
template <int BITS>
__device__ __forceinline__ void weights4(const uint8_t* row, int at,
                                         const Deq& q, float (&w)[4]) {
  if constexpr (BITS == 8) {
    const uint32_t v =
        *reinterpret_cast<const uint32_t*>(row + at) ^ 0x80808080u;
    // byte 0: code j; byte 1: 0 (q.hi's byte 2); bytes 2, 3: q.hi's 0, 1
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = q(__byte_perm(v, q.hi, 0x5460u + j));
  } else if constexpr (BITS == 16) {
    const uint2 u = *reinterpret_cast<const uint2*>(row + at);
    const uint32_t v0 = u.x ^ 0x80008000u, v1 = u.y ^ 0x80008000u;
    w[0] = q(__byte_perm(v0, q.hi, 0x5410u));
    w[1] = q(__byte_perm(v0, q.hi, 0x5432u));
    w[2] = q(__byte_perm(v1, q.hi, 0x5410u));
    w[3] = q(__byte_perm(v1, q.hi, 0x5432u));
  } else {
    // 4 BITS bits from bit `at`: one aligned word for 2- and 4-bit lanes
    // (a byte, a half word), a funnel shift over two for 3 and 6 (half of
    // an 8-code group, or one whole 4-code group, of 3 bytes)
    const uint32_t* p = reinterpret_cast<const uint32_t*>(row) + (at >> 5);
    uint32_t v;
    if constexpr (BITS == 2 || BITS == 4) v = p[0] >> (at & 31);
    else v = __funnelshift_r(p[0], p[1], at & 31);
    constexpr uint32_t kMask = (1u << BITS) - 1u;
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = q(q.hi32 | ((v >> (j * BITS)) & kMask));
  }
}

// Block (n tile, m tile, K slice). Warp w owns the block's columns
// 32w .. 32w+31, laid out over its four n8 MMA tiles so that one shared
// load gives a thread one code of each: MMA column g of tile j is block
// column 32w + 4g + j. The C fragment then holds 8 contiguous output
// columns 8t .. 8t+7 a row.
template <int BITS, int MT, int NW>
__global__ void __launch_bounds__(32 * NW)
k1_tc_kernel(const TArgs a) {
  using L = TLayout<BITS, MT, NW>;
  constexpr int kThreads = L::THREADS, kBN = L::BN;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * 16 * MT;
  const int mrows = min(16 * MT, a.M - m0);
  const int kb = blockIdx.z * a.k_slice;
  const int ke = min(a.K, kb + a.k_slice);
  const int ntiles = (ke - kb + kBK - 1) / kBK;
  // the block's first code byte of a row (n0 is a multiple of 128, so of
  // every packing group)
  const long long c0 = (long long)n0 * BITS / 8;

  // x rows past M are never loaded: zero them once in every stage
  constexpr int XROW16 = kXRow * 2 / 16;   // 16-byte words of an x row
  for (int i = mrows * XROW16 + tid; i < 16 * MT * XROW16; i += kThreads)
#pragma unroll
    for (int st = 0; st < kStages; ++st)
      reinterpret_cast<uint4*>(smem + st * L::STAGE + L::CBYTES)[i] =
          make_uint4(0u, 0u, 0u, 0u);

  // stage tile kt of this slice: code rows k0 .. k0+kBK-1 (zeros past
  // the slice and past the row's bytes), x columns likewise (zeros past
  // the slice; the slice ends on a multiple of 32 rows or at K)
  auto load = [&](int kt) {
    uint8_t* cs = smem + (kt % kStages) * L::STAGE;
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(cs + L::CBYTES);
    const int k0 = kb + kt * kBK;
    constexpr int CCH = L::RB / 16;  // 16-byte chunks of a code row
    for (int i = tid; i < kBK * CCH; i += kThreads) {
      const int r = i / CCH, c = i % CCH;
      const int k = k0 + r;
      const long long at = c0 + c * 16;   // byte of the code row
      uint8_t* dst = cs + r * L::CROW + c * 16;
      if (a.vec_c) {   // rows of whole 16-byte words: a chunk is in or out
        const bool in = k < ke && at < a.row_bytes;
        cp_async16(dst, in ? a.codes + (long long)k * a.row_bytes + at
                           : a.codes,
                   in ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          dst[e] = (k < ke && at + e < a.row_bytes)
              ? __ldg(a.codes + (long long)k * a.row_bytes + at + e)
              : (uint8_t)0;
      }
    }
    constexpr int XCH = kBK / 8;  // 16-byte chunks of an x row
    for (int i = tid; i < mrows * XCH; i += kThreads) {
      const int r = i / XCH, c = i % XCH;
      const int k = k0 + c * 8;
      __nv_bfloat16* dst = xs + r * kXRow + c * 8;
      const __nv_bfloat16* row = a.x + (long long)(m0 + r) * a.K;
      if (a.vec_x) {
        const bool in = k < ke;   // k and ke are multiples of 8 here
        cp_async16(dst, in ? row + k : a.x, in ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = k + e < ke ? row[k + e] : __float2bfloat16_rn(0.0f);
      }
    }
  };

  Deq q;
  q.hi = (uint32_t)(150 - a.k_x) << 7;   // (150 - k) << 23, shifted down 16
  q.hi32 = (uint32_t)(150 - a.k_x) << 23;
  q.base = (8388608.0f + (BITS == 8    ? 128.0f
                          : BITS == 16 ? 32768.0f
                                       : (float)(1 << (BITS - 1)))) *
           a.inv_pow2;
  q.s = __ldg(a.scale);
  // the thread's offset into a staged code row: bytes (int8 / int16) or
  // bits (packed lanes) of column 32 warp + 4g
  const int at = BITS >= 8 ? (warp * 32 + 4 * g) * (BITS / 8)
                           : (warp * 32 + 4 * g) * BITS;

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < ntiles) load(p);
    cp_async_commit();
  }
  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait<kStages - 2>();   // tile kt has landed
    __syncthreads();                // ... for every thread; kt-1 consumed
    if (kt + kStages - 1 < ntiles) load(kt + kStages - 1);
    cp_async_commit();
    const uint8_t* cs = smem + (kt % kStages) * L::STAGE;
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(cs + L::CBYTES);
    // the stage's 64 products of each output summed by the tensor cores
    // alone (from zero), then added to the running sum with one IEEE
    // rounding: the MMA's truncating accumulation never sees the large
    // partial sum, so the error stays at fp32 summation-order size
    float d[MT][4][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) d[i][j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      // B fragments of the warp's four n8 tiles: rows kk+2t, +1 (b0) and
      // kk+2t+8, +9 (b1), MMA column g
      uint32_t bf[4][2];
#pragma unroll
      for (int hb = 0; hb < 2; ++hb) {
        const uint8_t* r0 = cs + (kk + 2 * t + 8 * hb) * L::CROW;
        float w0[4], w1[4];
        weights4<BITS>(r0, at, q, w0);
        weights4<BITS>(r0 + L::CROW, at, q, w1);
#pragma unroll
        for (int j = 0; j < 4; ++j) bf[j][hb] = pack_bf16(w0[j], w1[j]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        uint32_t af[4];
        ldsm_x4(af, xs + (16 * i + (lane & 15)) * kXRow + kk + 8 * (lane >> 4));
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(d[i][j], af, bf[j][0], bf[j][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += d[i][j][e];
  }
  cp_async_wait<0>();

  // C fragment -> 8 contiguous columns 8t .. 8t+7 of rows g and g+8
  const bool split = gridDim.z > 1;
  const int col0 = n0 + warp * 32 + 8 * t;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m0 + 16 * i + g + 8 * hr;
      if (row >= a.M) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[i][j][2 * hr];
        v[4 + j] = acc[i][j][2 * hr + 1];
      }
      const long long off = (long long)row * a.N + col0;
      const bool whole = a.vec_o && col0 + 8 <= a.N;
      if (split || !a.out_bf16) {
        float* dst = split ? a.ws + (long long)blockIdx.z * a.M * a.N + off
                           : static_cast<float*>(a.out) + off;
        if (whole) {
          float4* d4 = reinterpret_cast<float4*>(dst);
          d4[0] = make_float4(v[0], v[1], v[2], v[3]);
          d4[1] = make_float4(v[4], v[5], v[6], v[7]);
        } else {
          for (int e = 0; e < 8; ++e)
            if (col0 + e < a.N) dst[e] = v[e];
        }
      } else {
        __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(a.out) + off;
        if (whole) {
          *reinterpret_cast<uint4*>(dst) =
              make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                         pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
        } else {
          for (int e = 0; e < 8; ++e)
            if (col0 + e < a.N) store(dst + e, v[e]);
        }
      }
    }
  }
}

// out = the slices' partial sums folded in a fixed order (slice z into
// partial z % 4, then (p0 + p1) + (p2 + p3): four independent loads in
// flight), rounded once
template <typename OT>
__global__ void k1_fold_kernel(const float* __restrict__ ws,
                               OT* __restrict__ out, int slices,
                               long long mn) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int z = 0;
    for (; z + 4 <= slices; z += 4)
#pragma unroll
      for (int u = 0; u < 4; ++u) p[u] += ws[(z + u) * mn + i];
    for (int u = 0; z + u < slices; ++u) p[u] += ws[(z + u) * mn + i];
    store(out + i, (p[0] + p[1]) + (p[2] + p[3]));
  }
}

template <int BITS, int MT, int NW>
int launch_tc(const TArgs& a, int slices, cudaStream_t stream) {
  using L = TLayout<BITS, MT, NW>;
  static bool sized = false;   // once per instance: the shared-memory cap
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        k1_tc_kernel<BITS, MT, NW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  dim3 grid((a.N + L::BN - 1) / L::BN, (a.M + 16 * MT - 1) / (16 * MT),
            slices);
  k1_tc_kernel<BITS, MT, NW><<<grid, L::THREADS, L::SMEM, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return (int)err;
  const long long mn = (long long)a.M * a.N;
  const int blocks = (int)std::min<long long>((mn + 255) / 256, 132 * 8);
  if (a.out_bf16)
    k1_fold_kernel<__nv_bfloat16><<<blocks, 256, 0, stream>>>(
        a.ws, static_cast<__nv_bfloat16*>(a.out), slices, mn);
  else
    k1_fold_kernel<float><<<blocks, 256, 0, stream>>>(
        a.ws, static_cast<float*>(a.out), slices, mn);
  return (int)cudaGetLastError();
}

template <int BITS, int NW>
int launch_tc_m(const TArgs& a, int slices, cudaStream_t stream) {
  if (a.M <= 16) return launch_tc<BITS, 1, NW>(a, slices, stream);
  if (a.M <= 32) return launch_tc<BITS, 2, NW>(a, slices, stream);
  return launch_tc<BITS, 4, NW>(a, slices, stream);
}

template <int BITS>
int launch_tc_n(const TArgs& a, int tile_n, int slices, cudaStream_t stream) {
  return tile_n == 256 ? launch_tc_m<BITS, 8>(a, slices, stream)
                       : launch_tc_m<BITS, 4>(a, slices, stream);
}

}  // namespace tc

// ---------------------------------------------------------------------------
// K1 on CUDA cores: float32 products (fmaf), every code type
// ---------------------------------------------------------------------------

namespace fm {

using tc::Deq;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileN = 128;     // output columns a block: 4 a lane

// A step over the block's 128 columns: H warps (a warp group) share it,
// each lane loading VL 16-byte vectors of codes; R whole code rows (RB
// bytes each, BITS vectors), R a multiple of 4 (x is read 4 K rows a
// shared load). At 32 rows of x the two warps of a group split them (16
// each: 64 accumulators a lane, two blocks an SM) and share the staged
// codes through a double buffer. Wide row tiles keep fewer vectors a lane
// in flight: their FMAs, not the bytes, bound them.
template <int BITS, int TM>
struct Step {
  static constexpr int H = TM == 32 ? 2 : 1;       // warps a group
  static constexpr int TMW = TM / H;               // x rows a warp
  static constexpr int GROUPS = kWarps / H;
  static constexpr int VL = TM <= 8 ? 4 : 2;
  static constexpr int RB = 16 * BITS;
  static constexpr int R = (32 * H * VL / BITS) / 4 * 4;
  static constexpr int VECS = R * BITS;             // vectors a step
  static constexpr int BUF = VECS * 16 + 16;        // staged bytes, a pad
  static constexpr int NBUF = H;                    // buffers a group
  static_assert(R >= 4 && VECS <= 32 * H * VL, "a step of whole rows");
};

struct FArgs {
  const void* x;
  const uint8_t* codes;
  const float* scale;
  float* out;
  float* ws;            // (slices, M, N) fp32 partial sums when K is split
  int M, K, N;
  long long row_bytes;  // bytes of one code row: N codes of BITS bits
  int k_slice;          // K rows a slice, a multiple of 32; x rows staged
  int k_x;
  float inv_pow2;
  int vec_c;            // code rows of whole 16-byte vectors, aligned
  int vec_x;            // float32 x rows of whole 16-byte vectors, aligned
};

// the x rows of a warp group's step meet here: a named barrier of its H
// warps (barrier 0 is __syncthreads')
template <int H>
__device__ __forceinline__ void group_sync(int g) {
  if constexpr (H == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + g), "r"(32 * H) : "memory");
}

// 4 staged code rows (of which `live` lie inside the slice) against the
// warp's TMW rows of x: the lane's 4 columns' weights, then TMW x 16 FMAs,
// x read 4 K rows a shared load
template <int BITS, int TMW, bool RBF>
__device__ __forceinline__ void fma_rows4(const uint8_t* rows, int at,
                                          const Deq& q, const float* xk,
                                          int xstride, int live,
                                          float (&acc)[TMW][4]) {
  float w[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    tc::weights4<BITS>(rows + j * 16 * BITS, at, q, w[j]);
    if constexpr (RBF) {
#pragma unroll
      for (int e = 0; e < 4; ++e) w[j][e] = round_bf16(w[j][e]);
    }
  }
  if (live < 4) {                    // rows past the slice weigh nothing
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j >= live) w[j][e] = 0.0f;
  }
#pragma unroll
  for (int m = 0; m < TMW; ++m) {
    const float4 xv = *reinterpret_cast<const float4*>(xk + m * xstride);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[m][e] = fmaf(xv.x, w[0][e], acc[m][e]);
      acc[m][e] = fmaf(xv.y, w[1][e], acc[m][e]);
      acc[m][e] = fmaf(xv.z, w[2][e], acc[m][e]);
      acc[m][e] = fmaf(xv.w, w[3][e], acc[m][e]);
    }
  }
}

// Block (128-column tile, TM-row tile of x, K slice), 8 warps. x's rows
// of the slice are staged once, as floats ([TM][k_slice], zeros past M
// and the slice; float32 rows by cp.async, all copies in flight); then
// each warp group streams steps g, g + GROUPS, ... of the slice from
// device memory straight into registers (16-byte ld.global.nc), the next
// step's loads in flight while this one's weights are made, through a
// staging buffer of its own (no block barrier in the loop). Lane l owns
// columns 4l .. 4l+3 and sums TMW x 4 outputs in fp32 over its K rows in
// order; the groups' sums fold in group order at the end.
// RBF: the weight is rounded to bf16 (a bf16 leaf, or a pending cast).
template <int BITS, int TM, typename XT, bool RBF>
__global__ void __launch_bounds__(kThreads, TM >= 16 ? 2 : 1)
k1_fma_kernel(const FArgs a) {
  using S = Step<BITS, TM>;
  extern __shared__ __align__(16) uint8_t smem[];
  float* xs = reinterpret_cast<float*>(smem);          // [TM][k_slice]
  float* red = xs + TM * a.k_slice;                      // [TM][kTileN]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp % S::GROUPS, half = warp / S::GROUPS;
  uint8_t* gbuf = reinterpret_cast<uint8_t*>(red + TM * kTileN) +
                  grp * S::NBUF * S::BUF;
  const int n0 = blockIdx.x * kTileN;
  const int m0 = blockIdx.y * TM;
  const int mrows = min(TM, a.M - m0);
  const int kb = blockIdx.z * a.k_slice;
  const int rows = min(a.K, kb + a.k_slice) - kb;
  const int nsteps = (rows + S::R - 1) / S::R;
  const long long c0 = 16LL * BITS * blockIdx.x;   // the tile's first byte

  // vector i of step s: row i / BITS of the step, vector i % BITS of it;
  // this warp loads vectors half * 32 VL + lane + 32 u
  auto load = [&](int s, uint4 (&v)[S::VL]) {
#pragma unroll
    for (int u = 0; u < S::VL; ++u) {
      const int i = half * 32 * S::VL + lane + 32 * u;
      const int r = i / BITS;
      const long long at = c0 + 16 * (i % BITS);
      const int k = s * S::R + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (i < S::VECS && k < rows) {
        const uint8_t* p = a.codes + (long long)(kb + k) * a.row_bytes + at;
        if (a.vec_c) {
          if (at < a.row_bytes)
            val = __ldg(reinterpret_cast<const uint4*>(p));
        } else {
          uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int e = 0; e < 16; ++e)
            if (at + e < a.row_bytes)
              w[e / 4] |= (uint32_t)__ldg(p + e) << (8 * (e % 4));
          val = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
      v[u] = val;
    }
  };

  uint4 raw[S::VL];
  if (grp < nsteps) load(grp, raw);   // in flight while x is staged

  const XT* __restrict__ x = static_cast<const XT*>(a.x);
  if (a.vec_x) {   // float32 rows of whole vectors: cp.async, zero-filled
    const int kv = a.k_slice / 4;
#pragma unroll 1
    for (int m = 0; m < TM; ++m) {
      const bool live = m < mrows;
      const XT* src = x + (long long)(m0 + m) * a.K + kb;
      for (int k4 = tid; k4 < kv; k4 += kThreads) {
        const bool in = live && 4 * k4 < rows;
        cp_async16(xs + m * a.k_slice + 4 * k4, in ? src + 4 * k4 : x,
                   in ? 16 : 0);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
  } else {         // element by element, MB rows' loads in flight
    constexpr int MB = TM < 8 ? TM : 8;
#pragma unroll 1
    for (int mb = 0; mb < TM; mb += MB)
      for (int k = tid; k < a.k_slice; k += kThreads) {
        float v[MB];
#pragma unroll
        for (int j = 0; j < MB; ++j)
          v[j] = mb + j < mrows && k < rows
              ? to_f32(x[(long long)(m0 + mb + j) * a.K + kb + k]) : 0.0f;
#pragma unroll
        for (int j = 0; j < MB; ++j) xs[(mb + j) * a.k_slice + k] = v[j];
      }
  }
  __syncthreads();

  Deq q;
  q.hi = (uint32_t)(150 - a.k_x) << 7;
  q.hi32 = (uint32_t)(150 - a.k_x) << 23;
  q.base = (8388608.0f + (BITS == 8    ? 128.0f
                          : BITS == 16 ? 32768.0f
                                       : (float)(1 << (BITS - 1)))) *
           a.inv_pow2;
  q.s = __ldg(a.scale);
  // the lane's offset into a staged code row: bytes (int8 / int16) or
  // bits (packed lanes) of column 4 lane
  const int at = BITS >= 8 ? 4 * lane * (BITS / 8) : 4 * lane * BITS;
  const float* xh = xs + half * S::TMW * a.k_slice;   // this warp's x rows

  float acc[S::TMW][4];
#pragma unroll
  for (int m = 0; m < S::TMW; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[m][e] = 0.0f;

  int it = 0;
  for (int s = grp; s < nsteps; s += S::GROUPS, ++it) {
    uint8_t* buf = gbuf + (it % S::NBUF) * S::BUF;
    if constexpr (S::H == 1) __syncwarp();   // the last step's rows are read
#pragma unroll
    for (int u = 0; u < S::VL; ++u) {
      const int i = half * 32 * S::VL + lane + 32 * u;
      if (i < S::VECS) reinterpret_cast<uint4*>(buf)[i] = raw[u];
    }
    group_sync<S::H>(grp);
    if (s + S::GROUPS < nsteps) load(s + S::GROUPS, raw);

    const int k0 = s * S::R;          // the step's first row in the slice
    const int live = min(S::R, rows - k0);
    // 4 rows a pass; at 16 and 32 rows of x a pass is ~300 instructions
    // and the loop stays rolled (unrolled, those instances were slower)
    if constexpr (TM >= 16) {
#pragma unroll 1
      for (int g = 0; 4 * g < live; ++g)
        fma_rows4<BITS, S::TMW, RBF>(buf + 4 * g * S::RB, at, q,
                                     xh + k0 + 4 * g, a.k_slice, live - 4 * g,
                                     acc);
    } else {
#pragma unroll
      for (int g = 0; g < S::R / 4; ++g) {
        if (4 * g >= live) break;      // uniform across the group
        fma_rows4<BITS, S::TMW, RBF>(buf + 4 * g * S::RB, at, q,
                                     xh + k0 + 4 * g, a.k_slice, live - 4 * g,
                                     acc);
      }
    }
  }

  // the groups' sums folded in group order, in shared memory (the two
  // warps of a group hold disjoint rows)
#pragma unroll 1
  for (int gi = 0; gi < S::GROUPS; ++gi) {
    if (grp == gi) {
#pragma unroll
      for (int m = 0; m < S::TMW; ++m) {
        float4* r4 = reinterpret_cast<float4*>(
            red + (half * S::TMW + m) * kTileN + 4 * lane);
        if (gi == 0) {
          *r4 = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
        } else {
          const float4 o = *r4;
          *r4 = make_float4(o.x + acc[m][0], o.y + acc[m][1],
                            o.z + acc[m][2], o.w + acc[m][3]);
        }
      }
    }
    __syncthreads();
  }
  float* dst = gridDim.z > 1 ? a.ws + (long long)blockIdx.z * a.M * a.N
                             : a.out;
  for (int i = tid; i < mrows * kTileN; i += kThreads) {
    const int m = i / kTileN, col = n0 + i % kTileN;
    if (col < a.N) dst[(long long)(m0 + m) * a.N + col] = red[i];
  }
}

template <int BITS, int TM, typename XT, bool RBF>
int launch(const FArgs& a, int slices, cudaStream_t stream) {
  using S = Step<BITS, TM>;
  const long long smem = 4LL * TM * a.k_slice + 4LL * TM * kTileN +
                         (long long)S::GROUPS * S::NBUF * S::BUF;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  static long long sized = 48 * 1024;   // once per instance and size
  if (smem > sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        k1_fma_kernel<BITS, TM, XT, RBF>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    sized = smem;
  }
  dim3 grid((a.N + kTileN - 1) / kTileN, (a.M + TM - 1) / TM, slices);
  k1_fma_kernel<BITS, TM, XT, RBF>
      <<<grid, kThreads, (size_t)smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return (int)err;
  const long long mn = (long long)a.M * a.N;
  const int blocks = (int)std::min<long long>((mn + 255) / 256, 132 * 8);
  tc::k1_fold_kernel<float><<<blocks, 256, 0, stream>>>(a.ws, a.out, slices,
                                                        mn);
  return (int)cudaGetLastError();
}

// float32 activations (with a float32 or a bf16 weight), or bf16
// activations against a float32 weight (a bf16 weight takes the tensor
// cores)
template <int BITS, int TM>
int launch_types(const FArgs& a, int x_bf16, int rbf, int slices,
                 cudaStream_t stream) {
  if (x_bf16)
    return rbf ? (int)cudaErrorInvalidValue
               : launch<BITS, TM, __nv_bfloat16, false>(a, slices, stream);
  return rbf ? launch<BITS, TM, float, true>(a, slices, stream)
             : launch<BITS, TM, float, false>(a, slices, stream);
}

template <int BITS>
int launch_m(const FArgs& a, int m_tile, int x_bf16, int rbf, int slices,
             cudaStream_t stream) {
  switch (m_tile) {
    case 4: return launch_types<BITS, 4>(a, x_bf16, rbf, slices, stream);
    case 8: return launch_types<BITS, 8>(a, x_bf16, rbf, slices, stream);
    case 16: return launch_types<BITS, 16>(a, x_bf16, rbf, slices, stream);
    case 32: return launch_types<BITS, 32>(a, x_bf16, rbf, slices, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace fm

// ---------------------------------------------------------------------------
// K1t on tensor cores: out (M, V) = x (M, d) @ W.T, bf16 activations, W
// (V, d) as code rows whose weight is a bf16 number
// ---------------------------------------------------------------------------

namespace tt {

using tc::Deq;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

// A thread's span of one code row: V16 16-byte vectors holding CS codes,
// KS MMA k steps of 4 codes a row. A chunk of d is the 4 spans of a quad
// (t = 0..3), CHUNK codes; RT: 16-row tiles a warp walks together.
template <int BITS>
struct Span {
  static constexpr int V16 = (BITS == 3 || BITS == 6) ? 3 : BITS == 2 ? 1 : 2;
  static constexpr int BYTES = 16 * V16;
  static constexpr int CS = BYTES * 8 / BITS;
  static constexpr int KS = CS / 4;
  static constexpr int CHUNK = 4 * CS;
  static constexpr int STAGE = KS < 4 ? KS : 4;   // k steps summed from 0
  // the span's code that element e (0..3) of k step s takes: 4s + e, but
  // for 2- and 4-bit lanes the codes of one byte position across a word
  // (one mask and a byte permute give 4 weights)
  __host__ __device__ static constexpr int pos(int s, int e) {
    return BITS == 4   ? 8 * (s / 2) + 2 * e + s % 2
           : BITS == 2 ? 16 * (s / 4) + 4 * e + s % 4
                       : 4 * s + e;
  }
};

template <int V16>
__device__ __forceinline__ uint32_t word(const uint4 (&r)[V16], int j) {
  const uint4 u = r[j / 4];
  switch (j % 4) {
    case 0: return u.x;
    case 1: return u.y;
    case 2: return u.z;
    default: return u.w;
  }
}

// The weights of elements 0..3 of k step s of one row's span (s is a
// compile-time constant once the caller's loop is unrolled).
template <int BITS>
__device__ __forceinline__ void weights(const uint4 (&r)[Span<BITS>::V16],
                                        int s, const Deq& q, float (&w)[4]) {
  constexpr int V16 = Span<BITS>::V16;
  if constexpr (BITS == 8) {
    const uint32_t v = word<V16>(r, s) ^ 0x80808080u;
#pragma unroll
    for (int e = 0; e < 4; ++e) w[e] = q(__byte_perm(v, q.hi, 0x5460u + e));
  } else if constexpr (BITS == 16) {
    const uint32_t v0 = word<V16>(r, 2 * s) ^ 0x80008000u;
    const uint32_t v1 = word<V16>(r, 2 * s + 1) ^ 0x80008000u;
    w[0] = q(__byte_perm(v0, q.hi, 0x5410u));
    w[1] = q(__byte_perm(v0, q.hi, 0x5432u));
    w[2] = q(__byte_perm(v1, q.hi, 0x5410u));
    w[3] = q(__byte_perm(v1, q.hi, 0x5432u));
  } else if constexpr (BITS == 4 || BITS == 2) {
    // byte e of the masked word: code pos(s, e), biased already
    constexpr int PER = 32 / BITS / 4;   // k steps a word
    const int sh = BITS * (s % PER);
    const uint32_t v = (word<V16>(r, s / PER) >> sh) &
                       (BITS == 4 ? 0x0F0F0F0Fu : 0x03030303u);
#pragma unroll
    for (int e = 0; e < 4; ++e) w[e] = q(__byte_perm(v, q.hi, 0x5460u + e));
  } else {
    // 3 and 6 bits: codes 4s .. 4s+3 from bit 4s BITS, over two words
    // where they cross one
    constexpr uint32_t kMask = (1u << BITS) - 1u;
    const int bit = 4 * BITS * s, o = bit >> 5, sh = bit & 31;
    const uint32_t v = sh + 4 * BITS <= 32
        ? word<V16>(r, o) >> sh
        : __funnelshift_r(word<V16>(r, o), word<V16>(r, o + 1), sh);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      w[e] = q(q.hi32 | ((v >> (e * BITS)) & kMask));
  }
}

struct TTArgs {
  const __nv_bfloat16* x;
  const uint8_t* codes;
  const float* scale;
  void* out;
  int M, d, V;
  long long row_bytes;  // bytes of one code row: d codes of BITS bits
  int nchunks;          // chunks of d, the last one ragged
  int k_x;
  float inv_pow2;
  int out_bf16;
};

// Block (persistent over 16 RT-row groups of code rows, n8 tiles NT of
// activation rows). Shared memory holds x once a block, already in B
// fragment order: [k step][n tile][lane] of uint2 (b0, b1), zeros past M
// and past d. Each warp then streams code rows straight into registers,
// the next chunk's 16-byte loads in flight while this chunk's weights are
// made and multiplied; no barrier after the staging.
template <int BITS, int NT, int RT, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
k1t_tc_kernel(const TTArgs a) {
  using S = Span<BITS>;
  constexpr int V16 = S::V16;
  extern __shared__ __align__(16) uint2 xf[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * 8 * NT;
  const int mrows = min(8 * NT, a.M - m0);
  const long long groups = (a.V + 16 * RT - 1) / (16 * RT);
  const long long gstride = (long long)gridDim.x * kWarps;
  long long grp = (long long)blockIdx.x * kWarps + warp;

  // the 16-byte vectors of the thread's span of rows g, g+8 of each tile
  auto load = [&](uint4 (&r)[RT][2][V16], long long gi, int c) {
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long v = gi * 16 * RT + 16 * i + g + 8 * h;
        const uint8_t* row = a.codes + v * a.row_bytes;
        const long long at0 = (long long)c * 4 * S::BYTES + t * S::BYTES;
#pragma unroll
        for (int u = 0; u < V16; ++u) {
          const long long at = at0 + 16 * u;
          uint4 val = make_uint4(0u, 0u, 0u, 0u);
          if constexpr (VEC) {
            if (v < a.V && at < a.row_bytes)
              val = __ldg(reinterpret_cast<const uint4*>(row + at));
          } else if (v < a.V) {
            uint32_t wv[4] = {0u, 0u, 0u, 0u};
#pragma unroll
            for (int e = 0; e < 16; ++e)
              if (at + e < a.row_bytes)
                wv[e / 4] |= (uint32_t)__ldg(row + at + e) << (8 * (e % 4));
            val = make_uint4(wv[0], wv[1], wv[2], wv[3]);
          }
          r[i][h][u] = val;
        }
      }
  };

  uint4 raw[RT][2][V16], nxt[RT][2][V16];
  if (grp < groups) load(raw, grp, 0);   // in flight while x is staged

  const uint16_t* xr = reinterpret_cast<const uint16_t*>(a.x);
  const int nsteps = a.nchunks * S::KS;
  for (int i = tid; i < nsteps * NT * 32; i += kThreads) {
    const int l = i & 31, nt = (i >> 5) % NT, K = (i >> 5) / NT;
    const int c = K / S::KS, s = K % S::KS;
    const int m = 8 * nt + (l >> 2);
    uint32_t e16[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = c * S::CHUNK + (l & 3) * S::CS + S::pos(s, e);
      e16[e] = (m < mrows && p < a.d)
          ? (uint32_t)xr[(long long)(m0 + m) * a.d + p] : 0u;
    }
    xf[i] = make_uint2(e16[0] | (e16[1] << 16), e16[2] | (e16[3] << 16));
  }
  __syncthreads();

  Deq q;
  q.hi = (uint32_t)(150 - a.k_x) << 7;
  q.hi32 = (uint32_t)(150 - a.k_x) << 23;
  q.base = (8388608.0f + (BITS == 8    ? 128.0f
                          : BITS == 16 ? 32768.0f
                                       : (float)(1 << (BITS - 1)))) *
           a.inv_pow2;
  q.s = __ldg(a.scale);

  float acc[RT][NT][4];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0.0f;

  int c = 0;
  while (grp < groups) {
    long long ngrp = grp;
    int nc = c + 1;
    if (nc == a.nchunks) { nc = 0; ngrp += gstride; }
    if (ngrp < groups) load(nxt, ngrp, nc);

    const uint2* xc = xf + (long long)c * S::KS * NT * 32 + lane;
#pragma unroll
    for (int s0 = 0; s0 < S::KS; s0 += S::STAGE) {
      // a stage's 64 products of an output summed by the tensor cores from
      // zero, then added to the running sum with one IEEE rounding (K1's
      // order of the sum)
      float dd[RT][NT][4];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dd[i][n][e] = 0.0f;
#pragma unroll
      for (int s = s0; s < s0 + S::STAGE; ++s) {
        uint2 b[NT];
#pragma unroll
        for (int n = 0; n < NT; ++n) b[n] = xc[(s * NT + n) * 32];
#pragma unroll
        for (int i = 0; i < RT; ++i) {
          float wg[4], wh[4];
          weights<BITS>(raw[i][0], s, q, wg);
          weights<BITS>(raw[i][1], s, q, wh);
          // A rows g / g+8, MMA k 2t, 2t+1 (elements 0, 1) and 2t+8, 2t+9
          // (2, 3)
          const uint32_t af[4] = {pack_bf16(wg[0], wg[1]),
                                  pack_bf16(wh[0], wh[1]),
                                  pack_bf16(wg[2], wg[3]),
                                  pack_bf16(wh[2], wh[3])};
#pragma unroll
          for (int n = 0; n < NT; ++n) mma_bf16(dd[i][n], af, b[n].x, b[n].y);
        }
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][n][e] += dd[i][n][e];
    }

    if (c == a.nchunks - 1) {
      // C fragment: code rows g (e 0, 1) and g+8 (2, 3), activation rows
      // 2t (e 0, 2) and 2t+1 (1, 3) of n tile n
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const long long v = grp * 16 * RT + 16 * i + g + 8 * (e >> 1);
            const int m = m0 + 8 * n + 2 * t + (e & 1);
            if (v < a.V && m < a.M) {
              const long long off = (long long)m * a.V + v;
              if (a.out_bf16)
                store(static_cast<__nv_bfloat16*>(a.out) + off, acc[i][n][e]);
              else
                static_cast<float*>(a.out)[off] = acc[i][n][e];
            }
            acc[i][n][e] = 0.0f;
          }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int u = 0; u < V16; ++u) raw[i][h][u] = nxt[i][h][u];
    grp = ngrp;
    c = nc;
  }
}

// shared memory of the x fragments: nchunks * KS k steps x NT x 32 lanes
template <int BITS>
long long smem_of(int d, int nt) {
  using S = Span<BITS>;
  return (long long)((d + S::CHUNK - 1) / S::CHUNK) * S::KS * nt * 32 * 8;
}

template <int BITS, int NT, int RT, bool VEC>
int launch(TTArgs a, cudaStream_t stream) {
  using S = Span<BITS>;
  a.nchunks = (a.d + S::CHUNK - 1) / S::CHUNK;
  const int smem = (int)smem_of<BITS>(a.d, NT);
  // per instance: the shared-memory cap, the SM count, and the blocks an
  // SM holds at the last shared-memory size
  static int sized = 0, sms = 0, occ_smem = -1, per_sm = 0;
  cudaError_t err = cudaSuccess;
  if (smem > sized) {
    err = cudaFuncSetAttribute(k1t_tc_kernel<BITS, NT, RT, VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    sized = smem;
  }
  if (!sms) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  if (smem != occ_smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, k1t_tc_kernel<BITS, NT, RT, VEC>, kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    occ_smem = smem;
  }
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long groups = (a.V + 16 * RT - 1) / (16 * RT);
  const long long blocks =
      std::min<long long>((groups + kWarps - 1) / kWarps,
                          (long long)sms * per_sm);
  dim3 grid((unsigned)blocks, (a.M + 8 * NT - 1) / (8 * NT));
  k1t_tc_kernel<BITS, NT, RT, VEC><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// NT n8 tiles of activation rows a block (1, 2 or 4: M up to 8, 16, or
// 32 a row of the grid), as many as M needs and shared memory holds
template <int BITS, bool VEC>
int launch_nt(const TTArgs& a, cudaStream_t stream) {
  constexpr long long kMax = 232448;
  // two 16-row tiles a warp where the registers allow (at most 128 a
  // thread, two blocks an SM): not with 4 n tiles, nor with the 48-byte
  // spans of 3- and 6-bit rows
  constexpr int RT = Span<BITS>::V16 <= 2 ? 2 : 1;
  const int want = a.M <= 8 ? 1 : a.M <= 16 ? 2 : 4;
  if (want >= 4 && smem_of<BITS>(a.d, 4) <= kMax)
    return launch<BITS, 4, 1, VEC>(a, stream);
  if (want >= 2 && smem_of<BITS>(a.d, 2) <= kMax)
    return launch<BITS, 2, RT, VEC>(a, stream);
  if (smem_of<BITS>(a.d, 1) <= kMax)
    return launch<BITS, 1, RT, VEC>(a, stream);
  return (int)cudaErrorInvalidValue;
}

template <int BITS>
int launch_vec(const TTArgs& a, cudaStream_t stream) {
  const bool vec = a.row_bytes % 16 == 0 && (uintptr_t)a.codes % 16 == 0;
  return vec ? launch_nt<BITS, true>(a, stream)
             : launch_nt<BITS, false>(a, stream);
}

}  // namespace tt

// ---------------------------------------------------------------------------
// K1t on CUDA cores: out (M, V) = x (M, d) @ W.T in float32 products
// (fmaf), every code type
// ---------------------------------------------------------------------------

namespace ft {

using tc::Deq;
using tt::Span;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

// code rows a thread holds: 4 of 32-byte spans (int8, int16, 4-bit lanes)
// or 16-byte ones (2-bit), 2 of the 48-byte spans of 3- and 6-bit lanes;
// a warp's 8 row groups g hold rows g, g + 8, ..., so a warp walks 8 R
// consecutive rows
template <int BITS>
struct Rows {
  static constexpr int R = Span<BITS>::V16 <= 2 ? 4 : 2;
};

struct FTArgs {
  const void* x;
  const uint8_t* codes;
  const float* scale;
  float* out;
  int M, d, V;
  long long row_bytes;  // bytes of one code row: d codes of BITS bits
  int nchunks;          // chunks of d, the last one ragged
  int k_x;
  float inv_pow2;
  int x_bf16;           // bf16 activations (against a float32 weight)
};

// The staged x: span j = 4 c + t of chunk c holds the MT activation rows'
// values at the CS positions thread t of a quad multiplies, in the order
// its k steps take them (slot 4 s + e: position c CHUNK + t CS + pos(s,
// e)), MT floats a slot, then 16 bytes of pad, so that the four spans a
// warp reads at once start 4 banks apart.
template <int BITS, int MT>
struct XLayout {
  static constexpr int SPAN = Span<BITS>::CS * MT + 4;   // floats
  __host__ __device__ static long long floats(int nchunks) {
    return 4LL * nchunks * SPAN;
  }
};

// Block: persistent over groups of 8 R code rows (one group a warp at a
// time), one tile of MT activation rows. x's rows are staged once a block
// as floats (zeros past M and past d), then each warp streams its code
// rows straight from device memory into registers (16-byte ld.global.nc,
// the next chunk's loads in flight while this one is multiplied) with no
// barrier after the staging. Thread (g, t) makes the weights of its span
// of rows g + 8 i (tc::Deq, the plain version's cast chain bit for bit)
// and sums R x MT outputs over its span positions in k-step order (32
// products from zero, then into the running sum), each
// x value (MT rows, one shared load) reused by its R rows; at a group's
// last chunk the quad's four sums fold by a fixed xor butterfly (every
// lane ends with the same bits) and the lanes share the stores. The
// order of every sum depends on d alone. RBF: the weight is rounded to
// bf16 (a bf16 leaf or a pending cast).
template <int BITS, int MT, bool VEC, bool RBF>
__global__ void __launch_bounds__(kThreads, MT <= 4 ? 2 : 1)
k1t_fma_kernel(const FTArgs a) {
  using S = Span<BITS>;
  using XL = XLayout<BITS, MT>;
  constexpr int V16 = S::V16, R = Rows<BITS>::R;
  extern __shared__ __align__(16) float xs[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * MT;
  const int mrows = min(MT, a.M - m0);
  const long long groups = (a.V + 8 * R - 1) / (8 * R);
  const long long gstride = (long long)gridDim.x * kWarps;
  long long grp = (long long)blockIdx.x * kWarps + warp;

  // the 16-byte vectors of the thread's span of its R rows in chunk c
  auto load = [&](uint4 (&r)[R][V16], long long gi, int c) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const long long v = gi * 8 * R + 8 * i + g;
      const uint8_t* row = a.codes + v * a.row_bytes;
      const long long at0 = (long long)c * 4 * S::BYTES + t * S::BYTES;
#pragma unroll
      for (int u = 0; u < V16; ++u) {
        const long long at = at0 + 16 * u;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if constexpr (VEC) {
          if (v < a.V && at < a.row_bytes)
            val = __ldg(reinterpret_cast<const uint4*>(row + at));
        } else if (v < a.V) {
          uint32_t wv[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int e = 0; e < 16; ++e)
            if (at + e < a.row_bytes)
              wv[e / 4] |= (uint32_t)__ldg(row + at + e) << (8 * (e % 4));
          val = make_uint4(wv[0], wv[1], wv[2], wv[3]);
        }
        r[i][u] = val;
      }
    }
  };

  uint4 raw[R][V16], nxt[R][V16];
  if (grp < groups) load(raw, grp, 0);   // in flight while x is staged

  const float* __restrict__ xf = static_cast<const float*>(a.x);
  const __nv_bfloat16* __restrict__ xh =
      static_cast<const __nv_bfloat16*>(a.x);
  const int nslots = a.nchunks * S::CHUNK;
#pragma unroll 4
  for (int i = tid; i < nslots; i += kThreads) {
    const int c = i / S::CHUNK, j = (i % S::CHUNK) / S::CS;
    const int k = i % S::CS, s = k / 4, e = k % 4;
    const int p = c * S::CHUNK + j * S::CS + S::pos(s, e);
    float* dst = xs + (long long)(4 * c + j) * XL::SPAN + k * MT;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const long long at = (long long)(m0 + m) * a.d + p;
      dst[m] = m < mrows && p < a.d
          ? (a.x_bf16 ? __bfloat162float(xh[at]) : xf[at]) : 0.0f;
    }
  }
  __syncthreads();

  Deq q;
  q.hi = (uint32_t)(150 - a.k_x) << 7;
  q.hi32 = (uint32_t)(150 - a.k_x) << 23;
  q.base = (8388608.0f + (BITS == 8    ? 128.0f
                          : BITS == 16 ? 32768.0f
                                       : (float)(1 << (BITS - 1)))) *
           a.inv_pow2;
  q.s = __ldg(a.scale);

  float acc[R][MT];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[i][m] = 0.0f;

  int c = 0;
  while (grp < groups) {
    long long ngrp = grp;
    int nc = c + 1;
    if (nc == a.nchunks) { nc = 0; ngrp += gstride; }
    if (ngrp < groups) load(nxt, ngrp, nc);

    const float* xk = xs + (long long)(4 * c + t) * XL::SPAN;
    // 32 products of an output (PB k steps) summed from zero, then added
    // to the running sum with one rounding: the running sum's error does
    // not grow with each product (the tensor-core route's order)
    constexpr int PB = S::KS < 8 ? S::KS : 8;
#pragma unroll
    for (int s0 = 0; s0 < S::KS; s0 += PB) {
      float part[R][MT];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int m = 0; m < MT; ++m) part[i][m] = 0.0f;
#pragma unroll
      for (int s = s0; s < s0 + PB; ++s) {
        float w[R][4];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          tt::weights<BITS>(raw[i], s, q, w[i]);
          if constexpr (RBF) {
#pragma unroll
            for (int e = 0; e < 4; ++e) w[i][e] = round_bf16(w[i][e]);
          }
        }
        if constexpr (MT == 1) {
          const float4 xv = *reinterpret_cast<const float4*>(xk + 4 * s);
          const float xe[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int i = 0; i < R; ++i)
              part[i][0] = fmaf(xe[e], w[i][e], part[i][0]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float xe[MT];
#pragma unroll
            for (int h = 0; h < MT / 4; ++h) {
              const float4 xv = *reinterpret_cast<const float4*>(
                  xk + (4 * s + e) * MT + 4 * h);
              xe[4 * h] = xv.x; xe[4 * h + 1] = xv.y;
              xe[4 * h + 2] = xv.z; xe[4 * h + 3] = xv.w;
            }
#pragma unroll
            for (int i = 0; i < R; ++i)
#pragma unroll
              for (int m = 0; m < MT; ++m)
                part[i][m] = fmaf(xe[m], w[i][e], part[i][m]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int m = 0; m < MT; ++m) acc[i][m] += part[i][m];
    }

    if (c == a.nchunks - 1) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const long long v = grp * 8 * R + 8 * i + g;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          float sum = acc[i][m];
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          acc[i][m] = 0.0f;
          if (m % 4 == t && m < mrows && v < a.V)
            a.out[(long long)(m0 + m) * a.V + v] = sum;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int u = 0; u < V16; ++u) raw[i][u] = nxt[i][u];
    grp = ngrp;
    c = nc;
  }
}

template <int BITS, int MT, bool VEC, bool RBF>
int launch(FTArgs a, cudaStream_t stream) {
  using S = Span<BITS>;
  a.nchunks = (a.d + S::CHUNK - 1) / S::CHUNK;
  const long long smem = 4 * XLayout<BITS, MT>::floats(a.nchunks);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  // per instance: the shared-memory cap, the SM count, and the blocks an
  // SM holds at the last shared-memory size
  static int sized = 48 * 1024, sms = 0, occ_smem = -1, per_sm = 0;
  auto kernel = k1t_fma_kernel<BITS, MT, VEC, RBF>;
  cudaError_t err = cudaSuccess;
  if (smem > sized) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    sized = (int)smem;
  }
  if (!sms) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  if (smem != occ_smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, (int)smem);
    if (err != cudaSuccess) return (int)err;
    occ_smem = (int)smem;
  }
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long groups = (a.V + 8 * Rows<BITS>::R - 1) / (8 * Rows<BITS>::R);
  const long long blocks = std::min<long long>((groups + kWarps - 1) / kWarps,
                                               (long long)sms * per_sm);
  dim3 grid((unsigned)blocks, (a.M + MT - 1) / MT);
  kernel<<<grid, kThreads, (size_t)smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int BITS, int MT, bool VEC>
int launch_types(const FTArgs& a, int rbf, cudaStream_t stream) {
  return rbf ? launch<BITS, MT, VEC, true>(a, stream)
             : launch<BITS, MT, VEC, false>(a, stream);
}

// a bf16 weight against bf16 activations takes the tensor cores
template <int BITS>
int launch_m(const FTArgs& a, int m_tile, int rbf, cudaStream_t stream) {
  if (a.x_bf16 && rbf) return (int)cudaErrorInvalidValue;
  const bool vec = a.row_bytes % 16 == 0 && (uintptr_t)a.codes % 16 == 0;
  switch (m_tile * 2 + (int)vec) {
    case 2: return launch_types<BITS, 1, false>(a, rbf, stream);
    case 3: return launch_types<BITS, 1, true>(a, rbf, stream);
    case 8: return launch_types<BITS, 4, false>(a, rbf, stream);
    case 9: return launch_types<BITS, 4, true>(a, rbf, stream);
    case 16: return launch_types<BITS, 8, false>(a, rbf, stream);
    case 17: return launch_types<BITS, 8, true>(a, rbf, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace ft

}  // namespace

// K1 on CUDA cores. x (M, K) float32 (or bf16 against a float32
// weight); codes (K, N) int8 (code_bits 8), int16 (16) or rows of packed
// 2/3/4/6-bit lanes; out (M, N) float32; ws (slices, M, N) float32 when
// slices > 1. Blocks of 128 output columns and m_tile (4, 8, 16 or 32)
// rows of x; K is cut into slices of k_slice rows (a multiple of 32), the
// last one ragged; the wrapper's plan (comm/matmul.py fma_plan) picks
// them. w_bf16 / cast_bf16: the weight is rounded to bf16 (once: rounding
// to bf16 twice is rounding once).
extern "C" int rt_dequant_matmul(const void* x, const void* codes,
                                 const void* scale, void* out, void* ws,
                                 int M, int K, int N, int code_bits, int k_x,
                                 int x_bf16, int w_bf16, int cast_bf16,
                                 int m_tile, int k_slice, int slices,
                                 void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || k_slice <= 0 || k_slice % 32 ||
      slices <= 0 || slices > 65535 || (long long)k_slice * slices < K ||
      (long long)k_slice * (slices - 1) >= K ||
      (slices > 1 && ws == nullptr) || k_x < 0 || k_x > 14 ||
      (m_tile != 4 && m_tile != 8 && m_tile != 16 && m_tile != 32) ||
      (M + m_tile - 1) / m_tile > 65535)
    return (int)cudaErrorInvalidValue;
  fm::FArgs a;
  switch (code_bits) {
    case 16: a.row_bytes = 2LL * N; break;
    case 8: a.row_bytes = N; break;
    case 6: a.row_bytes = (long long)((N + 3) / 4) * 3; break;
    case 4: a.row_bytes = (long long)((N + 1) / 2); break;
    case 3: a.row_bytes = (long long)((N + 7) / 8) * 3; break;
    case 2: a.row_bytes = (long long)((N + 3) / 4); break;
    default: return (int)cudaErrorInvalidValue;
  }
  a.x = x;
  a.codes = static_cast<const uint8_t*>(codes);
  a.scale = static_cast<const float*>(scale);
  a.out = static_cast<float*>(out);
  a.ws = static_cast<float*>(ws);
  a.M = M; a.K = K; a.N = N;
  a.k_slice = k_slice;
  a.k_x = k_x;
  a.inv_pow2 = 1.0f / (float)(1 << k_x);
  a.vec_c = a.row_bytes % 16 == 0 && (uintptr_t)codes % 16 == 0;
  a.vec_x = !x_bf16 && K % 4 == 0 && (uintptr_t)x % 16 == 0;
  const int rbf = w_bf16 || cast_bf16;
  cudaStream_t s = (cudaStream_t)stream;
  switch (code_bits) {
    case 16: return fm::launch_m<16>(a, m_tile, x_bf16, rbf, slices, s);
    case 8: return fm::launch_m<8>(a, m_tile, x_bf16, rbf, slices, s);
    case 6: return fm::launch_m<6>(a, m_tile, x_bf16, rbf, slices, s);
    case 4: return fm::launch_m<4>(a, m_tile, x_bf16, rbf, slices, s);
    case 3: return fm::launch_m<3>(a, m_tile, x_bf16, rbf, slices, s);
    default: return fm::launch_m<2>(a, m_tile, x_bf16, rbf, slices, s);
  }
}

// K1t on CUDA cores. x (M, d) float32 (or bf16 against a float32
// weight); codes (V, row bytes of d codes): int8 (code_bits 8), int16 (16)
// or packed 2/3/4/6-bit lanes; out (M, V) float32. m_tile (1, 4 or 8):
// activation rows a block; the wrapper's plan (comm/matmul.py
// t_fma_plan) picks it so that the staged x fits shared memory. w_bf16 /
// cast_bf16: the weight is rounded to bf16 (once: rounding to bf16 twice
// is rounding once).
extern "C" int rt_dequant_matmul_t(const void* x, const void* codes,
                                   const void* scale, void* out, int M, int d,
                                   int V, int code_bits, int k_x, int x_bf16,
                                   int w_bf16, int cast_bf16, int m_tile,
                                   void* stream) {
  if (M <= 0 || d <= 0 || V <= 0 || k_x < 0 || k_x > 14 ||
      (m_tile != 1 && m_tile != 4 && m_tile != 8) ||
      (M + m_tile - 1) / m_tile > 65535)
    return (int)cudaErrorInvalidValue;
  ft::FTArgs a;
  a.x = x;
  a.codes = static_cast<const uint8_t*>(codes);
  a.scale = static_cast<const float*>(scale);
  a.out = static_cast<float*>(out);
  a.M = M; a.d = d; a.V = V;
  a.k_x = k_x;
  a.inv_pow2 = 1.0f / (float)(1 << k_x);
  a.x_bf16 = x_bf16;
  const int rbf = w_bf16 || cast_bf16;
  cudaStream_t s = (cudaStream_t)stream;
  switch (code_bits) {
    case 16: a.row_bytes = 2LL * d;
             return ft::launch_m<16>(a, m_tile, rbf, s);
    case 8: a.row_bytes = d;
            return ft::launch_m<8>(a, m_tile, rbf, s);
    case 6: a.row_bytes = (long long)((d + 3) / 4) * 3;
            return ft::launch_m<6>(a, m_tile, rbf, s);
    case 4: a.row_bytes = (long long)((d + 1) / 2);
            return ft::launch_m<4>(a, m_tile, rbf, s);
    case 3: a.row_bytes = (long long)((d + 7) / 8) * 3;
            return ft::launch_m<3>(a, m_tile, rbf, s);
    case 2: a.row_bytes = (long long)((d + 3) / 4);
            return ft::launch_m<2>(a, m_tile, rbf, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K1t on tensor cores. x (M, d) bf16; codes (V, row bytes of d codes):
// int8 (code_bits 8), int16 (16) or packed 2/3/4/6-bit lanes; out (M, V)
// bf16 (out_bf16) or float32. The weight is the leaf's or the pending
// cast's bf16 number (the wrapper's route).
extern "C" int rt_dequant_matmul_t_tc(const void* x, const void* codes,
                                      const void* scale, void* out, int M,
                                      int d, int V, int code_bits, int k_x,
                                      int out_bf16, void* stream) {
  if (M <= 0 || d <= 0 || V <= 0 || k_x < 0 || k_x > 14 ||
      (M + 7) / 8 > 65535)
    return (int)cudaErrorInvalidValue;
  tt::TTArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.codes = static_cast<const uint8_t*>(codes);
  a.scale = static_cast<const float*>(scale);
  a.out = out;
  a.M = M; a.d = d; a.V = V;
  a.k_x = k_x;
  a.inv_pow2 = 1.0f / (float)(1 << k_x);
  a.out_bf16 = out_bf16;
  cudaStream_t s = (cudaStream_t)stream;
  switch (code_bits) {
    case 16: a.row_bytes = 2LL * d; return tt::launch_vec<16>(a, s);
    case 8: a.row_bytes = d; return tt::launch_vec<8>(a, s);
    case 6: a.row_bytes = (long long)((d + 3) / 4) * 3;
            return tt::launch_vec<6>(a, s);
    case 4: a.row_bytes = (long long)((d + 1) / 2);
            return tt::launch_vec<4>(a, s);
    case 3: a.row_bytes = (long long)((d + 7) / 8) * 3;
            return tt::launch_vec<3>(a, s);
    case 2: a.row_bytes = (long long)((d + 3) / 4);
            return tt::launch_vec<2>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K1 on tensor cores. x (M, K) bf16; codes (K, N) int8 (code_bits 8),
// int16 (16) or rows of packed 2/3/4/6-bit lanes (payload_nbytes(N, bits)
// bytes each); out (M, N) bf16 (out_bf16) or float32; ws (slices, M, N)
// float32 when slices > 1 (unused otherwise). Blocks of tile_n (128 or
// 256) output columns; K is cut into slices of k_slice rows (a multiple
// of 32), the last one ragged; the wrapper's plan (comm/matmul.py
// k1_plan) picks both.
extern "C" int rt_dequant_matmul_tc(const void* x, const void* codes,
                                    const void* scale, void* out, void* ws,
                                    int M, int K, int N, int code_bits,
                                    int k_x, int tile_n, int k_slice,
                                    int slices, int out_bf16, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || k_slice <= 0 ||
      k_slice % 32 || slices <= 0 || slices > 65535 ||
      (long long)k_slice * slices < K ||
      (long long)k_slice * (slices - 1) >= K ||
      (slices > 1 && ws == nullptr) || (M + 63) / 64 > 65535 ||
      k_x < 0 || k_x > 14 || (tile_n != 128 && tile_n != 256))
    return (int)cudaErrorInvalidValue;
  long long row_bytes;
  switch (code_bits) {
    case 16: row_bytes = 2LL * N; break;
    case 8: row_bytes = N; break;
    case 6: row_bytes = (long long)((N + 3) / 4) * 3; break;
    case 4: row_bytes = (long long)((N + 1) / 2); break;
    case 3: row_bytes = (long long)((N + 7) / 8) * 3; break;
    case 2: row_bytes = (long long)((N + 3) / 4); break;
    default: return (int)cudaErrorInvalidValue;
  }
  tc::TArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.codes = static_cast<const uint8_t*>(codes);
  a.scale = static_cast<const float*>(scale);
  a.out = out;
  a.ws = static_cast<float*>(ws);
  a.M = M; a.K = K; a.N = N;
  a.row_bytes = row_bytes;
  a.k_slice = k_slice;
  a.k_x = k_x;
  a.inv_pow2 = 1.0f / (float)(1 << k_x);
  a.vec_x = K % 8 == 0 && (uintptr_t)x % 16 == 0;
  a.vec_c = row_bytes % 16 == 0 && (uintptr_t)codes % 16 == 0;
  a.vec_o = N % 8 == 0 && (uintptr_t)out % 16 == 0 &&
            (uintptr_t)ws % 16 == 0;
  a.out_bf16 = out_bf16;
  cudaStream_t s = (cudaStream_t)stream;
  switch (code_bits) {
    case 16: return tc::launch_tc_n<16>(a, tile_n, slices, s);
    case 8: return tc::launch_tc_n<8>(a, tile_n, slices, s);
    case 6: return tc::launch_tc_n<6>(a, tile_n, slices, s);
    case 4: return tc::launch_tc_n<4>(a, tile_n, slices, s);
    case 3: return tc::launch_tc_n<3>(a, tile_n, slices, s);
    default: return tc::launch_tc_n<2>(a, tile_n, slices, s);
  }
}
