// K1 fused dequant-matmul: out = x @ W where W exists only as uniform Q_x
// codes (int8, int16, or 2/3/4/6-bit lanes packed per row) plus one f32
// scale. The full-precision weight never reaches device memory.
//
// Replaces repro/comm/matmul.py _matmul_pallas (_mm_body, _mm_lut_body).
// On the TPU each grid step held the whole (M, K) activation in VMEM and
// one column tile of codes, and the LUT body read sub-8-bit values from an
// SMEM table. Here the dequantization happens in registers: c / 2^k is
// exact (computed as c * 2^-k, which is the same float), so a table buys
// nothing. Each code is dequantized exactly as the reference's cast chain
// does it: (c / 2^k) * s, then rounded to the leaf dtype, then to the
// activation dtype, so the weight the product sees is bitwise the plain
// version's. Products accumulate in fp32 (fmaf) on CUDA cores; tensor
// cores (wgmma) come later.
//
// Bound: at decode (M = slots, a few rows) and chunked prefill (M = 32)
// the work is ~2 M flops per code byte, far below the card's ~295
// flop/byte balance point, so the kernel is bound by the bytes of codes
// it streams. Design: a block owns 32 output columns of an M-tile and
// walks all of K; its 512 threads split K into P interleaved partitions
// (lanes of a warp span the 32 columns, several K rows per warp load), so
// even N = 4096 gives 128 blocks of 16 warps. K is walked in chunks of
// kChunk rows: the block stages the chunk's activations in shared memory
// (as float), then every thread issues all its code loads for the chunk
// before it uses any, so each warp keeps several loads in flight. Every
// code byte is read once per M-tile. Partial sums are folded in shared
// memory in a fixed order, so the result is deterministic; K is never
// split across blocks (atomics would change the sum order from run to
// run). Ragged M, N and K edges are masked, so every shape is covered.
//
// K1t, the transposed product (rt_dequant_matmul_t): out = x @ W.T where
// W is (V, d) as code rows, the tied logit head of gemma2 (256000 rows of
// 2304 codes). Replaces the transposed branch of _matmul_pallas
// (_mm_t_body, repro/comm/matmul.py:150), which tiled code rows and
// needed V to be a multiple of its tile (_pallas_covers). Here one output
// column IS one contiguous code row, so K1's layout (a block owns 32
// output columns and walks K code rows) would read each row with a stride
// of d bytes. Instead each warp owns kTRows consecutive code rows, and its
// lanes stream them coalesced along d: int8 and int16 rows one 16-byte
// vector a lane per load (16 or 8 codes), packed or misaligned rows one
// packing group a lane per load; the loads of all kTRows rows are in
// flight before any is used. x (one activation row, or a tile of 4) is
// held in registers at the lane's columns of a chunk of d and reused
// across the warp's kTRows rows: shared memory would serve a lane's
// columns from one bank group, registers serve them free. x is read from
// L1/L2 once per chunk per warp, every code byte once per M-tile. Each
// lane sums its columns in a fixed order in fp32; the warp folds the 32
// lane sums by a fixed xor butterfly; one rounding to the output dtype.
// The weight each product sees is bitwise the plain version's cast chain,
// as in K1. Ragged V, d and M are masked. Bound: at M = 4 the head reads
// 590 MB of codes for 4.7 GFLOP, ~8 flops a byte, so it is bound by the
// bytes of codes: 0.176 ms at the H100 SXM's 3.35 TB/s (data sheet,
// 700 W). A first version with 4-byte loads and 8 rows a warp (166
// registers a thread, one block an SM) reached 12 % of that bound on an
// NVIDIA H100 80GB HBM3 at 700 W; PERF.md has both versions' times.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kCols = 32;    // output columns per block
constexpr int kChunk = 512;  // K rows staged per step (a multiple of P)

// C: columns one thread owns (one 4-byte word of int8 / int16 codes, or
// one packing group of a sub-8-bit lane); NB: bytes of a packed group.
template <int BITS> struct Lane;
template <> struct Lane<8>  { static constexpr int C = 4, NB = 4; };
template <> struct Lane<16> { static constexpr int C = 2, NB = 4; };
template <> struct Lane<2>  { static constexpr int C = 4, NB = 1; };
template <> struct Lane<3>  { static constexpr int C = 8, NB = 3; };
template <> struct Lane<4>  { static constexpr int C = 2, NB = 1; };
template <> struct Lane<6>  { static constexpr int C = 4, NB = 3; };

struct Args {
  const void* x;
  const uint8_t* codes;
  const float* scale;
  void* out;
  int M, K, N;
  long long row_bytes;  // bytes of one code row (K index)
  float inv_pow2;       // 2^-k_x, exact
  int w_bf16;           // leaf dtype is bf16: round the dequantized value
  int cast_bf16;        // pending astype(bf16): round again
  int vec;              // aligned word loads for int8 / int16 codes
};

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

// The raw word holding columns n0 .. n0+C-1 of one code row; the caller
// guarantees n0 < N. int8 / int16: little-endian lanes of the word, with
// columns past N read as 0; packed: the NB bytes of one group.
template <int BITS>
__device__ __forceinline__ uint32_t load_raw(const uint8_t* __restrict__ row,
                                             int n0, int N, int vec) {
  if constexpr (BITS == 8 || BITS == 16) {
    constexpr int W = BITS / 8;  // bytes per code
    constexpr int C = Lane<BITS>::C;
    if (vec) return __ldg(reinterpret_cast<const uint32_t*>(row + n0 * W));
    uint32_t raw = 0;
#pragma unroll
    for (int j = 0; j < C; ++j)
      if (n0 + j < N)
#pragma unroll
        for (int b = 0; b < W; ++b)
          raw |= (uint32_t)__ldg(row + (n0 + j) * W + b) << (8 * (j * W + b));
    return raw;
  } else {
    constexpr int C = Lane<BITS>::C, NB = Lane<BITS>::NB;
    const uint8_t* g = row + (long long)(n0 / C) * NB;
    uint32_t raw = 0;
#pragma unroll
    for (int b = 0; b < NB; ++b) raw |= (uint32_t)__ldg(g + b) << (8 * b);
    return raw;
  }
}

// Signed code j of a raw word (packed lanes are biased by 2^(BITS-1)).
template <int BITS>
__device__ __forceinline__ int code(uint32_t raw, int j) {
  if constexpr (BITS == 8) return (int)(int8_t)(raw >> (8 * j));
  else if constexpr (BITS == 16) return (int)(int16_t)(raw >> (16 * j));
  else return (int)((raw >> (j * BITS)) & ((1u << BITS) - 1u)) - (1 << (BITS - 1));
}

template <int BITS, int MT, typename XT, typename OT>
__global__ void __launch_bounds__(kThreads)
dequant_matmul_kernel(const Args a) {
  constexpr int C = Lane<BITS>::C;
  constexpr int CL = kCols / C;      // lanes across the block's columns
  constexpr int P = kThreads / CL;   // partitions of K
  constexpr int U = kChunk / P;      // code rows per thread per chunk
  static_assert(kChunk % P == 0, "chunk must tile the partitions");
  __shared__ float xs[MT][kChunk];
  __shared__ float red[P][kCols];

  const XT* __restrict__ x = static_cast<const XT*>(a.x);
  const int t = threadIdx.x;
  const int cl = t % CL, p = t / CL;
  const int n0 = blockIdx.x * kCols + cl * C;
  const int m0 = blockIdx.y * MT;
  const int mrows = min(MT, a.M - m0);
  const float s = __ldg(a.scale);

  float acc[MT][C];
#pragma unroll
  for (int r = 0; r < MT; ++r)
#pragma unroll
    for (int j = 0; j < C; ++j) acc[r][j] = 0.0f;

  for (int k0 = 0; k0 < a.K; k0 += kChunk) {
    // stage this chunk's activations (zeros past M and K)
    for (int i = t; i < MT * kChunk; i += kThreads) {
      const int r = i / kChunk, k = k0 + i % kChunk;
      xs[r][i % kChunk] = (r < mrows && k < a.K)
          ? to_f32(x[(long long)(m0 + r) * a.K + k]) : 0.0f;
    }
    __syncthreads();
    if (n0 < a.N) {
      uint32_t raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {  // all loads first, then the math
        const int k = k0 + p + u * P;
        raw[u] = k < a.K ? load_raw<BITS>(a.codes + (long long)k * a.row_bytes,
                                          n0, a.N, a.vec) : 0u;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (k0 + p + u * P < a.K) {
          float w[C];
#pragma unroll
          for (int j = 0; j < C; ++j) {
            float v = ((float)code<BITS>(raw[u], j) * a.inv_pow2) * s;
            if (a.w_bf16) v = round_bf16(v);
            if (a.cast_bf16) v = round_bf16(v);
            w[j] = v;
          }
#pragma unroll
          for (int r = 0; r < MT; ++r) {
            if (r < mrows) {
              const float xv = xs[r][p + u * P];
#pragma unroll
              for (int j = 0; j < C; ++j) acc[r][j] = fmaf(xv, w[j], acc[r][j]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  // fold the P partial sums of each output in a fixed order
  OT* __restrict__ out = static_cast<OT*>(a.out);
#pragma unroll
  for (int r = 0; r < MT; ++r) {
    if (r < mrows) {  // uniform across the block
#pragma unroll
      for (int j = 0; j < C; ++j) red[p][cl * C + j] = acc[r][j];
      __syncthreads();
      if (t < kCols) {
        float sum = 0.0f;
        for (int q = 0; q < P; ++q) sum += red[q][t];
        const int col = blockIdx.x * kCols + t;
        if (col < a.N) store(out + (long long)(m0 + r) * a.N + col, sum);
      }
      __syncthreads();
    }
  }
}

template <int BITS, int MT, typename XT, typename OT>
int launch(const Args& a, cudaStream_t stream) {
  dim3 grid((a.N + kCols - 1) / kCols, (a.M + MT - 1) / MT);
  dequant_matmul_kernel<BITS, MT, XT, OT><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int BITS, typename XT, typename OT>
int launch_tile(const Args& a, cudaStream_t stream) {
  return a.M <= 4 ? launch<BITS, 4, XT, OT>(a, stream)
                  : launch<BITS, 8, XT, OT>(a, stream);
}

template <int BITS>
int launch_types(const Args& a, int x_bf16, int out_bf16, cudaStream_t stream) {
  if (!x_bf16 && !out_bf16) return launch_tile<BITS, float, float>(a, stream);
  if (x_bf16 && out_bf16)
    return launch_tile<BITS, __nv_bfloat16, __nv_bfloat16>(a, stream);
  if (x_bf16) return launch_tile<BITS, __nv_bfloat16, float>(a, stream);
  return (int)cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// K1t: out (M, V) = x (M, d) @ W.T, W (V, d) as code rows
// ---------------------------------------------------------------------------

constexpr int kTThreads = 256;
constexpr int kTWarps = kTThreads / 32;
constexpr int kTRows = 4;    // code rows (output columns) per warp
constexpr int kTCols = 16;   // x columns a lane holds per chunk, per row

// How a lane's columns of a chunk of d sit in a code row. VEC (int8 /
// int16 rows whose 16-byte vectors are aligned): one 16-byte load of
// COLS = 16 / W contiguous codes. Otherwise one packing group (a 4-byte
// word of int8 / int16 codes, or NB bytes of a packed lane) per load,
// the lane's U groups 32 groups apart, so a warp's load is coalesced.
template <int BITS, bool VEC> struct TUnit;
template <int BITS> struct TUnit<BITS, true> {
  static_assert(BITS == 8 || BITS == 16, "vector loads of whole codes");
  static constexpr int W = BITS / 8, COLS = 16 / W, WORDS = 4;
  __device__ static int col(int lane, int i) { return lane * COLS + i; }
  __device__ static int at(const uint32_t* raw, int i) {
    if constexpr (BITS == 8) return (int)(int8_t)(raw[i / 4] >> (8 * (i % 4)));
    else return (int)(int16_t)(raw[i / 2] >> (16 * (i % 2)));
  }
};
template <int BITS> struct TUnit<BITS, false> {
  static constexpr int C = Lane<BITS>::C, COLS = kTCols, WORDS = kTCols / C;
  static_assert(kTCols % C == 0, "a lane holds whole groups");
  __device__ static int col(int lane, int i) {
    return ((i / C) * 32 + lane) * C + i % C;
  }
  __device__ static int at(const uint32_t* raw, int i) {
    return code<BITS>(raw[i / C], i % C);
  }
};

// x[0 .. n) as floats, n a multiple of 16 bytes' worth, p 16-byte aligned
template <typename XT, int N>
__device__ __forceinline__ void load_x_vec(const XT* __restrict__ p,
                                           float* out) {
  constexpr int PER = 16 / (int)sizeof(XT);
  static_assert(N % PER == 0, "whole vectors");
#pragma unroll
  for (int v = 0; v < N / PER; ++v) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + v);
    const XT* e = reinterpret_cast<const XT*>(&u);
#pragma unroll
    for (int j = 0; j < PER; ++j) out[v * PER + j] = to_f32(e[j]);
  }
}

// a.K = d (the contracted width, codes per row), a.N = V (code rows).
// A chunk is 32 * COLS columns of d; each lane holds x at its COLS
// columns of the chunk for every activation row in registers, so x is
// read once per chunk for all kTRows code rows of the warp.
template <int BITS, bool VEC, int TM, typename XT, typename OT>
__global__ void __launch_bounds__(kTThreads)
dequant_matmul_t_kernel(const Args a) {
  using T = TUnit<BITS, VEC>;
  constexpr int COLS = T::COLS, CW = 32 * COLS;

  const XT* __restrict__ x = static_cast<const XT*>(a.x);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m0 = blockIdx.y * TM;
  const int mrows = min(TM, a.M - m0);
  const long long v0 =
      ((long long)blockIdx.x * kTWarps + warp) * kTRows;
  if (v0 >= a.N) return;  // no barrier below: whole warps may leave
  const float s = __ldg(a.scale);
  // (c * 2^-k) * s == c * (2^-k * s) bit for bit while 2^-k * s is a
  // normal float (both round the same exact product once); rounding to
  // bf16 twice is rounding once (the leaf's bf16, then the cast's)
  const float s2 = s * a.inv_pow2;
  const bool fold = fabsf(s2) >= 1.17549435e-38f;
  const bool rb = a.w_bf16 || a.cast_bf16;

  float acc[kTRows][TM];
#pragma unroll
  for (int i = 0; i < kTRows; ++i)
#pragma unroll
    for (int r = 0; r < TM; ++r) acc[i][r] = 0.0f;

  for (int k0 = 0; k0 < a.K; k0 += CW) {
    uint32_t raw[kTRows][T::WORDS];
#pragma unroll
    for (int i = 0; i < kTRows; ++i) {  // all loads first, then the math
      const uint8_t* row = a.codes + (v0 + i) * a.row_bytes;
      const bool live = v0 + i < a.N;
      if constexpr (VEC) {
        const int c0 = k0 + lane * COLS;
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (live && c0 < a.K)
          u = __ldg(reinterpret_cast<const uint4*>(row + c0 * T::W));
        raw[i][0] = u.x; raw[i][1] = u.y; raw[i][2] = u.z; raw[i][3] = u.w;
      } else {
#pragma unroll
        for (int g = 0; g < T::WORDS; ++g) {
          const int c0 = k0 + T::col(lane, g * T::C);
          raw[i][g] = (live && c0 < a.K)
              ? load_raw<BITS>(row, c0, a.K, a.vec) : 0u;
        }
      }
    }
    float xr[TM][COLS];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const XT* xrow = x + (long long)(m0 + r) * a.K + k0;
      if constexpr (VEC) {
        if (r < mrows && k0 + lane * COLS < a.K)
          load_x_vec<XT, COLS>(xrow + lane * COLS, xr[r]);
        else
#pragma unroll
          for (int i = 0; i < COLS; ++i) xr[r][i] = 0.0f;
      } else {
#pragma unroll
        for (int i = 0; i < COLS; ++i) {
          const int col = T::col(lane, i);
          xr[r][i] = (r < mrows && k0 + col < a.K) ? to_f32(xrow[col])
                                                    : 0.0f;
        }
      }
    }
    // a vector lies wholly inside d or wholly past it
    if (VEC && k0 + lane * COLS >= a.K) continue;
#pragma unroll
    for (int i = 0; i < kTRows; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        if (VEC || k0 + T::col(lane, j) < a.K) {
          float w = fold ? (float)T::at(raw[i], j) * s2
                         : ((float)T::at(raw[i], j) * a.inv_pow2) * s;
          if (rb) w = round_bf16(w);
#pragma unroll
          for (int r = 0; r < TM; ++r)
            acc[i][r] = fmaf(xr[r][j], w, acc[i][r]);
        }
      }
  }

  // fold the 32 lane sums of each output by a fixed xor butterfly (every
  // lane ends with the same bits); lane 0 writes
  OT* __restrict__ out = static_cast<OT*>(a.out);
#pragma unroll
  for (int i = 0; i < kTRows; ++i) {
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      float v = acc[i][r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      const long long col = v0 + i;
      if (lane == 0 && r < mrows && col < a.N)
        store(out + (long long)(m0 + r) * a.N + col, v);
    }
  }
}

template <int BITS, bool VEC, int TM, typename XT, typename OT>
int launch_t(const Args& a, cudaStream_t stream) {
  const long long per_block = (long long)kTWarps * kTRows;
  dim3 grid((unsigned)((a.N + per_block - 1) / per_block),
            (a.M + TM - 1) / TM);
  dequant_matmul_t_kernel<BITS, VEC, TM, XT, OT>
      <<<grid, kTThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// vec16: int8 / int16 rows and x whose 16-byte vectors are aligned; one
// activation row gets its own instance (M = 1: the last position of a
// chunk, one slot)
template <int BITS, typename XT, typename OT>
int launch_t_tile(const Args& a, int vec16, cudaStream_t stream) {
  if constexpr (BITS == 8 || BITS == 16) {
    if (vec16)
      return a.M == 1 ? launch_t<BITS, true, 1, XT, OT>(a, stream)
                      : launch_t<BITS, true, 4, XT, OT>(a, stream);
  }
  return launch_t<BITS, false, 4, XT, OT>(a, stream);
}

template <int BITS>
int launch_t_types(const Args& a, int vec16, int x_bf16, int out_bf16,
                   cudaStream_t stream) {
  if (!x_bf16 && !out_bf16)
    return launch_t_tile<BITS, float, float>(a, vec16, stream);
  if (x_bf16 && out_bf16)
    return launch_t_tile<BITS, __nv_bfloat16, __nv_bfloat16>(a, vec16,
                                                              stream);
  if (x_bf16) return launch_t_tile<BITS, __nv_bfloat16, float>(a, vec16,
                                                              stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int rt_dequant_matmul(const void* x, const void* codes,
                                 const void* scale, void* out, int M, int K,
                                 int N, int code_bits, int k_x, int x_bf16,
                                 int w_bf16, int cast_bf16, int out_bf16,
                                 void* stream) {
  Args a;
  a.x = x;
  a.codes = static_cast<const uint8_t*>(codes);
  a.scale = static_cast<const float*>(scale);
  a.out = out;
  a.M = M; a.K = K; a.N = N;
  a.inv_pow2 = 1.0f / (float)(1 << k_x);
  a.w_bf16 = w_bf16;
  a.cast_bf16 = cast_bf16;
  a.vec = 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (code_bits) {
    case 8:
      a.row_bytes = N;
      a.vec = (N % 4 == 0) && ((uintptr_t)codes % 4 == 0);
      return launch_types<8>(a, x_bf16, out_bf16, s);
    case 16:
      a.row_bytes = 2LL * N;
      a.vec = (N % 2 == 0) && ((uintptr_t)codes % 4 == 0);
      return launch_types<16>(a, x_bf16, out_bf16, s);
    case 2:
      a.row_bytes = (long long)((N + 3) / 4) * 1;
      return launch_types<2>(a, x_bf16, out_bf16, s);
    case 3:
      a.row_bytes = (long long)((N + 7) / 8) * 3;
      return launch_types<3>(a, x_bf16, out_bf16, s);
    case 4:
      a.row_bytes = (long long)((N + 1) / 2) * 1;
      return launch_types<4>(a, x_bf16, out_bf16, s);
    case 6:
      a.row_bytes = (long long)((N + 3) / 4) * 3;
      return launch_types<6>(a, x_bf16, out_bf16, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// x (M, d), codes (V, row bytes of d codes), out (M, V)
extern "C" int rt_dequant_matmul_t(const void* x, const void* codes,
                                   const void* scale, void* out, int M, int d,
                                   int V, int code_bits, int k_x, int x_bf16,
                                   int w_bf16, int cast_bf16, int out_bf16,
                                   void* stream) {
  Args a;
  a.x = x;
  a.codes = static_cast<const uint8_t*>(codes);
  a.scale = static_cast<const float*>(scale);
  a.out = out;
  a.M = M; a.K = d; a.N = V;
  a.inv_pow2 = 1.0f / (float)(1 << k_x);
  a.w_bf16 = w_bf16;
  a.cast_bf16 = cast_bf16;
  a.vec = 0;
  cudaStream_t s = (cudaStream_t)stream;
  const bool aligned = (uintptr_t)codes % 16 == 0 && (uintptr_t)x % 16 == 0;
  switch (code_bits) {
    case 8:
      a.row_bytes = d;
      a.vec = (d % 4 == 0) && ((uintptr_t)codes % 4 == 0);
      return launch_t_types<8>(a, aligned && d % 16 == 0, x_bf16, out_bf16,
                               s);
    case 16:
      a.row_bytes = 2LL * d;
      a.vec = (d % 2 == 0) && ((uintptr_t)codes % 4 == 0);
      return launch_t_types<16>(a, aligned && d % 8 == 0, x_bf16, out_bf16,
                                s);
    case 2:
      a.row_bytes = (long long)((d + 3) / 4) * 1;
      return launch_t_types<2>(a, 0, x_bf16, out_bf16, s);
    case 3:
      a.row_bytes = (long long)((d + 7) / 8) * 3;
      return launch_t_types<3>(a, 0, x_bf16, out_bf16, s);
    case 4:
      a.row_bytes = (long long)((d + 1) / 2) * 1;
      return launch_t_types<4>(a, 0, x_bf16, out_bf16, s);
    case 6:
      a.row_bytes = (long long)((d + 3) / 4) * 3;
      return launch_t_types<6>(a, 0, x_bf16, out_bf16, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
