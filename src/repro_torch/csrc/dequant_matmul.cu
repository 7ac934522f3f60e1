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
