// The paper's grids and the wire's lanes in device code, shared by every
// kernel that quantizes, dequantizes or packs: K4 (quantize.cu), K11 and
// K12 (dequantize.cu), K16 (adam_ef.cu), K6 and K7 (codec.cu). One
// definition, so the wire's codes cannot drift from the optimizer's.
//
// Each function is the device form of a plain function of
// repro_torch/opt/grids.py or repro_torch/comm/bits.py and rounds as it
// does: one IEEE rounding per operation (__f*_rn, no fma contraction, no
// fast math), so the kernels are bitwise their plain versions.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// 2^e as a float, exact for -126 <= e <= 127 (the uniform grid's 2^-k).
__device__ __forceinline__ float pow2i(int e) {
  return __int_as_float((127 + e) << 23);
}

// |x| bits order like the values for nonnegative floats (NaN above +inf),
// so an atomicMax on them is an exact max in any order.
__device__ __forceinline__ unsigned int abs_bits(float v) {
  return __float_as_uint(v) & 0x7fffffffu;
}

// ---------------------------------------------------------------------------
// log grid (the paper's Q_g): grids.log_quantize / log_dequantize
// ---------------------------------------------------------------------------

// The grid's decision points, the reference's own values
// (grids.log_grid_table, one table on the device): g[j] is the midpoint
// between levels 2^-j and 2^-(j+1) (j <= 125), strictly inside
// [2^-(j+1), 2^-j); g[kZeroAt + k] is the zero threshold of the k grid.
// The levels come from the lane table (lut_level), which holds the
// reference's values as well.
constexpr int kGridLen = 256;
constexpr int kZeroAt = 128;
constexpr int kMaxLogK = 126;  // int8 codes hold +/-(k + 1)

struct LogGrid {
  float s;          // the scale as given (deq multiplies by it)
  float s_div;      // max(s, 1e-30): the quantizer's divisor
  float zero;       // the zero threshold, about 2^-(k+1)
  const float* mid; // the midpoints g[0 .. 125]
  int k;
};

__device__ __forceinline__ LogGrid make_log_grid(float s, int k,
                                                 const float* g) {
  LogGrid q;
  q.s = s;
  q.s_div = s < 1e-30f ? 1e-30f : s;  // NaN passes through, as max()
  q.k = k;
  q.zero = g[kZeroAt + k];
  q.mid = g;
  return q;
}

// Nearest-in-linear-space level: the number of decision points (the
// zero threshold, then the midpoints) that y = |x| / s reaches, compared
// exactly (no log2 or exp2). The binade [2^E, 2^(E+1)) of a y below 1
// holds one midpoint, j = -E-1, and every midpoint of a deeper binade
// lies below y: so the count is k - j plus [y >= mid[j]] when j < k, and
// 1 (the zero threshold alone) when the binade lies below the grid.
__device__ __forceinline__ int log_code(float x, const LogGrid& q) {
  const float y = __fdiv_rn(fabsf(x), q.s_div);
  int mag;
  if (x == 0.0f || y < q.zero) {
    mag = 0;
  } else if (y != y) {
    mag = q.k > 0 ? q.k : 1;  // the reference's magnitude for a NaN y
  } else if (y >= 1.0f) {
    mag = q.k + 1;
  } else {
    // j = -E-1 with E the unbiased exponent; a subnormal y reads as
    // E = -127, below every grid
    const int j = 126 - ((__float_as_int(y) >> 23) & 0xff);
    mag = j >= q.k ? 1 : q.k - j + (y >= q.mid[j]);
  }
  return x < 0.0f ? -mag : mag;
}

// log_code as one read of a per-binade table, for kernels whose codes are
// bound by instructions (K7 and #5, codec.cu): y's binade (its exponent
// field e, 0 for zero and the subnormals) holds one (base, threshold bits)
// pair, built once a block from the same decision points by log_binade,
// and the magnitude is base + [bits(y) >= threshold] (bits order like the
// values for y >= 0). Binades below 2^-k (j = 126 - e >= k) hold the zero
// threshold or lie wholly on one side of it; those from 2^-k up hold
// midpoint j, wholly above the threshold (it sits near 2^-(k+1)); y >= 1,
// inf and NaN read e >= 127. A NaN y and x == 0 are decided apart, as
// log_code decides them, so both forms give every code alike.
constexpr unsigned kNever = 0xffffffffu;   // a threshold no y reaches

__device__ __forceinline__ uint2 log_binade(int e, int k, const float* g) {
  if (e >= 127) return make_uint2(k + 1, kNever);
  const int j = 126 - e;
  if (j < k) return make_uint2(k - j, __float_as_uint(g[j]));
  const unsigned lo = (unsigned)e << 23, hi = (unsigned)(e + 1) << 23;
  const unsigned z = __float_as_uint(g[kZeroAt + k]);
  if (z <= lo) return make_uint2(1, kNever);
  if (z >= hi) return make_uint2(0, kNever);
  return make_uint2(0, z);
}

// s_div = max(s, 1e-30) as make_log_grid's; nan_mag = k > 0 ? k : 1
__device__ __forceinline__ int log_code_binade(float x, float s_div,
                                               int nan_mag, const uint2* bin) {
  const float y = __fdiv_rn(fabsf(x), s_div);
  const unsigned yb = __float_as_uint(y);
  const uint2 t = bin[(yb >> 23) & 0xff];
  int mag = (int)t.x + (yb >= t.y);
  mag = y != y ? nan_mag : mag;
  mag = x == 0.0f ? 0 : mag;
  return x < 0.0f ? -mag : mag;
}

// The table form: tbl[c + half] * s, tbl holding every lane code's
// scale-1 level (grids.log_dequant_table, index = code + half); codes
// outside the lane clip to its ends. One rounding, as the reference's
// sign(c) * val * scale.
__device__ __forceinline__ float lut_level(const float* tbl, int half, int c,
                                          float s) {
  const int idx = min(max(c + half, 0), 2 * half - 1);
  return __fmul_rn(tbl[idx], s);
}

// ---------------------------------------------------------------------------
// uniform grid (the paper's Q_x): grids.uniform_quantize / _dequantize
// ---------------------------------------------------------------------------

// round_half_even(clip(x / s_div, -1, 1) * 2^k), as a float; s_div is
// max(s, 1e-30), pow2 = 2^k. y * 2^k is exact.
__device__ __forceinline__ float uniform_code(float x, float s_div,
                                              float pow2) {
  const float y = fminf(fmaxf(__fdiv_rn(x, s_div), -1.0f), 1.0f);
  return rintf(__fmul_rn(y, pow2));
}

// (c / 2^k) * s: the division by a power of two is exact.
__device__ __forceinline__ float uniform_level(float c, float pow2, float s) {
  return __fmul_rn(__fdiv_rn(c, pow2), s);
}

// ---------------------------------------------------------------------------
// lanes: comm/bits.py pack_lanes / unpack_lanes, one packing group
// ---------------------------------------------------------------------------

// Codes per whole-byte group, lcm(bits, 8) / bits, and its bytes.
__host__ __device__ constexpr int group_codes(int bits) {
  return bits == 3 ? 8 : bits == 6 ? 4 : bits >= 8 ? 1 : 8 / bits;
}
__host__ __device__ constexpr int group_nbytes(int bits) {
  return bits == 3 || bits == 6 ? 3 : bits == 16 ? 2 : 1;
}

// One group of signed codes -> its bytes. Lanes below 8 bits hold
// code + 2^(bits-1), little-endian within the group; 8-bit lanes the
// two's-complement byte, 16-bit lanes the little-endian int16.
template <int BITS>
__device__ __forceinline__ void pack_group(const int* codes, uint8_t* out) {
  if constexpr (BITS == 16) {
    const unsigned int u = (unsigned int)codes[0] & 0xffffu;
    out[0] = (uint8_t)(u & 0xffu);
    out[1] = (uint8_t)(u >> 8);
  } else if constexpr (BITS == 8) {
    out[0] = (uint8_t)((unsigned int)codes[0] & 0xffu);
  } else {
    constexpr int G = group_codes(BITS), NB = group_nbytes(BITS);
    constexpr unsigned int mask = (1u << BITS) - 1u;
    constexpr int bias = 1 << (BITS - 1);
    unsigned int val = 0u;
#pragma unroll
    for (int j = 0; j < G; ++j)
      val |= ((unsigned int)(codes[j] + bias) & mask) << (j * BITS);
#pragma unroll
    for (int b = 0; b < NB; ++b) out[b] = (uint8_t)((val >> (8 * b)) & 0xffu);
  }
}

template <int BITS>
__device__ __forceinline__ void unpack_group(const uint8_t* in, int* codes) {
  if constexpr (BITS == 16) {
    codes[0] = (int)(int16_t)((unsigned int)in[0] | ((unsigned int)in[1] << 8));
  } else if constexpr (BITS == 8) {
    codes[0] = (int)(int8_t)in[0];
  } else {
    constexpr int G = group_codes(BITS), NB = group_nbytes(BITS);
    constexpr unsigned int mask = (1u << BITS) - 1u;
    constexpr int bias = 1 << (BITS - 1);
    unsigned int val = 0u;
#pragma unroll
    for (int b = 0; b < NB; ++b) val |= (unsigned int)in[b] << (8 * b);
#pragma unroll
    for (int j = 0; j < G; ++j)
      codes[j] = (int)((val >> (j * BITS)) & mask) - bias;
  }
}

// ---------------------------------------------------------------------------
// launch geometry
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;

// Blocks for `work` items in each of `rows` grid rows: enough to cover the
// work, at most ~16 blocks per SM over the whole grid (grid-stride beyond).
inline unsigned int blocks_per_row(long long work, int rows) {
  long long want = (work + kThreads - 1) / kThreads;
  long long fill = (2048 + rows - 1) / rows;
  if (want > fill) want = fill;
  return (unsigned int)(want < 1 ? 1 : want);
}

}  // namespace rt
