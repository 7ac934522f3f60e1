// K7 fused EF encode and K6 fused decode: the two wire kernels of the
// distributed step (Algorithms 2+3), on both channels.
//
// K7 replaces repro/comm/kernels.py ef_encode_pallas (_ef_encode_body,
// _ef_encode_lut_body): x (Delta+e on the update exchange, a master chunk
// on the weight broadcast) and one scale become the packed payload rows
// of comm/bits.py pack_rows(pad_rows(codes, n_rows)) and the residual
// e' = x - deq(codes). The log kind quantizes as K16 does (rt::log_code,
// exact midpoint comparison) and its residual is x - level * s (K16's
// ef1); the uniform kind quantizes as K4 does (rt::uniform_code), clips
// the codes to the lane (+/-clip_abs: k_x = 7 rides 8-bit lanes at
// +/-127) and its residual is x - (c / 2^k) * s.
//
// K6 replaces repro/comm/kernels.py decode_pallas (_decode_body,
// _decode_lut_body): payload rows and one scale per row (each source
// worker's own) become float32 values, log codes through the lane table
// in shared memory (K11's lut[c + half] * s), uniform codes as
// (c / 2^k) * s (K12). It writes element (row, j) at row * c + j of a flat
// output when that index is below out_n, so a caller can decode straight
// into a tensor of the leaf's numel and drop the rows' padding.
//
// Both are bound by bytes: K7 reads 4 B and writes 4 B (e') plus bits/8
// per element (8.5 B for log:6 on 4-bit lanes, 9 B for uniform:7 on 8-bit
// lanes); K6 reads bits/8 and writes 4 B. The TPU kernels worked on
// (rows, lanes_in) VMEM tiles padded to a multiple of the tiling; here one
// thread packs or unpacks one whole-byte group (lcm(bits, 8) bits: 2, 4,
// 8 codes or 1 for 8- and 16-bit lanes), reading the unpadded flat x:
// elements past the row or past n are zero codes, so no padded copy of x
// exists. One grid row of blocks per payload row, grid-stride over the
// row's groups. Every operation is one IEEE rounding (no fma, no fast
// math): both kernels are bitwise their plain versions.
#include "grids.cuh"

namespace {

using rt::kThreads;
constexpr int kMaxTable = 256;  // lanes up to 8 bits
constexpr int kLog = 0;
constexpr int kUniform = 1;

// x and e_out carry no __restrict__: a caller may write e' over x (each
// element is read, then written, by one thread).
template <int BITS, int KIND>
__global__ void ef_encode_kernel(const float* x,
                                 const float* __restrict__ scale,
                                 uint8_t* __restrict__ payload, float* e_out,
                                 long long n, long long c, long long row_bytes,
                                 int k, int clip_abs) {
  constexpr int G = rt::group_codes(BITS), NB = rt::group_nbytes(BITS);
  const float s = scale[0];
  rt::LogGrid lg;
  float s_div = 0.0f, pow2 = 0.0f, top = 0.0f;
  if constexpr (KIND == kLog) {
    lg = rt::make_log_grid(s, k);
  } else {
    s_div = fmaxf(s, 1e-30f);  // as K4
    pow2 = (float)(1 << k);
    top = (float)clip_abs;
  }
  const long long row0 = (long long)blockIdx.y * c;
  uint8_t* prow = payload + (long long)blockIdx.y * row_bytes;
  const long long groups = (c + G - 1) / G;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < groups; j += stride) {
    int codes[G];
#pragma unroll
    for (int t = 0; t < G; ++t) {
      const long long col = j * G + t;
      const long long i = row0 + col;
      int code = 0;
      if (col < c && i < n) {
        const float xv = x[i];
        float level;
        if constexpr (KIND == kLog) {
          code = rt::log_code(xv, lg);
          level = __fmul_rn(rt::log_level(code, k), s);
        } else {
          float cf = rt::uniform_code(xv, s_div, pow2);
          if (clip_abs > 0) cf = fminf(fmaxf(cf, -top), top);
          code = (int)cf;
          level = rt::uniform_level(cf, pow2, s);
        }
        e_out[i] = __fsub_rn(xv, level);
      }
      codes[t] = code;
    }
    rt::pack_group<BITS>(codes, prow + j * NB);
  }
}

template <int BITS, int KIND>
__global__ void decode_kernel(const uint8_t* __restrict__ payload,
                              const float* __restrict__ scales,
                              const float* __restrict__ table, int half,
                              float* __restrict__ out, long long out_n,
                              long long c, long long row_bytes, int k) {
  constexpr int G = rt::group_codes(BITS), NB = rt::group_nbytes(BITS);
  __shared__ float tbl[kMaxTable];
  if constexpr (KIND == kLog) {
    for (int i = threadIdx.x; i < 2 * half; i += blockDim.x) tbl[i] = table[i];
    __syncthreads();
  }
  const float s = scales[blockIdx.y];
  const float pow2 = (float)(1 << k);
  const long long row0 = (long long)blockIdx.y * c;
  const uint8_t* prow = payload + (long long)blockIdx.y * row_bytes;
  const long long groups = (c + G - 1) / G;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < groups; j += stride) {
    int codes[G];
    rt::unpack_group<BITS>(prow + j * NB, codes);
#pragma unroll
    for (int t = 0; t < G; ++t) {
      const long long col = j * G + t;
      const long long i = row0 + col;
      if (col < c && i < out_n) {
        if constexpr (KIND == kLog)
          out[i] = rt::lut_level(tbl, half, codes[t], s);
        else
          out[i] = rt::uniform_level((float)codes[t], pow2, s);
      }
    }
  }
}

template <int BITS, int KIND>
int launch_encode(const void* x, const void* scale, void* payload,
                  void* e_out, long long n, int n_rows, long long c,
                  long long row_bytes, int k, int clip_abs,
                  cudaStream_t stream) {
  const long long groups = (c + rt::group_codes(BITS) - 1) /
                           rt::group_codes(BITS);
  dim3 grid(rt::blocks_per_row(groups, n_rows), n_rows);
  ef_encode_kernel<BITS, KIND><<<grid, kThreads, 0, stream>>>(
      (const float*)x, (const float*)scale, (uint8_t*)payload, (float*)e_out,
      n, c, row_bytes, k, clip_abs);
  return (int)cudaGetLastError();
}

template <int BITS, int KIND>
int launch_decode(const void* payload, const void* scales, const void* table,
                  int half, void* out, long long out_n, int n_rows,
                  long long c, long long row_bytes, int k,
                  cudaStream_t stream) {
  const long long groups = (c + rt::group_codes(BITS) - 1) /
                           rt::group_codes(BITS);
  dim3 grid(rt::blocks_per_row(groups, n_rows), n_rows);
  decode_kernel<BITS, KIND><<<grid, kThreads, 0, stream>>>(
      (const uint8_t*)payload, (const float*)scales, (const float*)table,
      half, (float*)out, out_n, c, row_bytes, k);
  return (int)cudaGetLastError();
}

bool valid_geometry(int kind, int bits, int n_rows, long long c,
                    long long row_bytes, int k) {
  if (kind != kLog && kind != kUniform) return false;
  if (n_rows < 1 || n_rows > 65535 || c < 1 || k < 0 || k > 30) return false;
  const int g = rt::group_codes(bits), nb = rt::group_nbytes(bits);
  return row_bytes == (c + g - 1) / g * nb;
}

}  // namespace

#define RT_BITS_CASES(CASE) \
  CASE(2) CASE(3) CASE(4) CASE(6) CASE(8) CASE(16)

extern "C" int rt_ef_encode_rows(const void* x, const void* scale,
                                 void* payload, void* e_out, long long n,
                                 int n_rows, long long c, long long row_bytes,
                                 int kind, int bits, int k, int clip_abs,
                                 void* stream) {
  if (!valid_geometry(kind, bits, n_rows, c, row_bytes, k))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define CASE(B)                                                             \
  if (bits == B)                                                            \
    return kind == kLog                                                     \
               ? launch_encode<B, kLog>(x, scale, payload, e_out, n, n_rows, \
                                        c, row_bytes, k, clip_abs, st)       \
               : launch_encode<B, kUniform>(x, scale, payload, e_out, n,     \
                                            n_rows, c, row_bytes, k,         \
                                            clip_abs, st);
  RT_BITS_CASES(CASE)
#undef CASE
  return (int)cudaErrorInvalidValue;
}

extern "C" int rt_decode_rows(const void* payload, const void* scales,
                              const void* table, int half, void* out,
                              long long out_n, int n_rows, long long c,
                              long long row_bytes, int kind, int bits, int k,
                              void* stream) {
  if (!valid_geometry(kind, bits, n_rows, c, row_bytes, k))
    return (int)cudaErrorInvalidValue;
  if (kind == kLog && (half < 1 || 2 * half > kMaxTable))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define CASE(B)                                                              \
  if (bits == B)                                                             \
    return kind == kLog                                                      \
               ? launch_decode<B, kLog>(payload, scales, table, half, out,   \
                                        out_n, n_rows, c, row_bytes, k, st)  \
               : launch_decode<B, kUniform>(payload, scales, table, half,    \
                                            out, out_n, n_rows, c,           \
                                            row_bytes, k, st);
  RT_BITS_CASES(CASE)
#undef CASE
  return (int)cudaErrorInvalidValue;
}
