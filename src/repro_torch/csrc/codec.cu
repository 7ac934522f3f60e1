// The wire kernels of the distributed step: K7 fused EF encode, #5 fused
// encode (its quantize + pack launch) and K6 fused decode.
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
// #5 replaces repro/comm/kernels.py encode_pallas (_encode2_body,
// _encode2_ternary_body, _encode1_body): amax + quantize + pack, no
// residual. The TPU kernel is one pallas_call over a (2, nb) grid whose
// phase 0 folds block amaxes into an SMEM scalar that phase 1 reads;
// that works only because a TPU grid runs in order. CUDA blocks do not,
// so #5 is two launches on one stream, with no host sync between them:
// K3's amax kernel (quantize.cu, rt_amax_rows over the flat x as one row,
// called as it is) folds max|x| into a device word, then the encode
// kernel below reads the word, applies where(amax > 0, amax, 1) (guard)
// and quantizes + packs. With a known scale (the absolute uniform grid,
// _encode1_body) the second launch runs alone. It is K7's kernel with
// the residual compiled out (EF = false) and a third kind, ternary
// (TernGrad): code = sign(x) * (u < |x| / max(s, 1e-30)), u the caller's
// uniforms over the flat x, read at x's index.
//
// K6 replaces repro/comm/kernels.py decode_pallas (_decode_body,
// _decode_lut_body): payload rows and one scale per row (each source
// worker's own) become float32 values, log codes through the lane table
// in shared memory (K11's lut[c + half] * s), uniform codes as
// (c / 2^k) * s (K12), ternary codes as c * s. It writes element (row, j)
// at row * c + j of a flat output when that index is below out_n, so a
// caller can decode straight into a tensor of the leaf's numel and drop
// the rows' padding.
//
// All are bound by bytes: K7 reads 4 B and writes 4 B (e') plus bits/8
// per element (8.5 B for log:6 on 4-bit lanes, 9 B for uniform:7 on 8-bit
// lanes); #5 reads 4 B (8 B with the uniforms) and writes bits/8, plus
// K3's 4 B read for an amax scale (12.25 B for ternary on 2-bit lanes);
// K6 reads bits/8 and writes 4 B. The TPU kernels worked on (rows,
// lanes_in) VMEM tiles padded to a multiple of the tiling; here one
// thread packs or unpacks one whole-byte group (lcm(bits, 8) bits: 2, 4,
// 8 codes or 1 for 8- and 16-bit lanes), reading the unpadded flat x:
// elements past the row or past n are zero codes, so no padded copy of x
// exists. One grid row of blocks per payload row, grid-stride over the
// row's groups. Every operation is one IEEE rounding (no fma, no fast
// math): the kernels are bitwise their plain versions.
#include "grids.cuh"

#define RT_BITS_CASES(CASE) \
  CASE(2) CASE(3) CASE(4) CASE(6) CASE(8) CASE(16)

namespace {

using rt::kThreads;
constexpr int kMaxTable = 256;  // lanes up to 8 bits
constexpr int kLog = 0;
constexpr int kUniform = 1;
constexpr int kTernary = 2;

// One encode's operands. x and e_out carry no __restrict__: K7 may write
// e' over x (each element is read, then written, by one thread).
struct Encode {
  const float* x;
  const float* u;        // ternary: uniforms over the flat x
  const float* scale;    // one float on the device
  float* scale_out;      // the scale used, or nullptr
  uint8_t* payload;
  float* e_out;          // K7's residual (EF only)
  long long n, c, row_bytes;
  int k, clip_abs, guard;
};

template <int BITS, int KIND, bool EF>
__global__ void encode_kernel(const Encode a) {
  constexpr int G = rt::group_codes(BITS), NB = rt::group_nbytes(BITS);
  float s = a.scale[0];
  if (a.guard) s = s > 0.0f ? s : 1.0f;  // where(amax > 0, amax, 1)
  if (a.scale_out != nullptr && blockIdx.x == 0 && blockIdx.y == 0 &&
      threadIdx.x == 0)
    a.scale_out[0] = s;
  rt::LogGrid lg;
  float s_div = 0.0f, pow2 = 0.0f, top = 0.0f;
  if constexpr (KIND == kLog) {
    lg = rt::make_log_grid(s, a.k);
  } else if constexpr (KIND == kUniform) {
    s_div = fmaxf(s, 1e-30f);  // as K4
    pow2 = (float)(1 << a.k);
    top = (float)a.clip_abs;
  } else {
    s_div = s < 1e-30f ? 1e-30f : s;  // NaN passes through, as max()
  }
  const long long row0 = (long long)blockIdx.y * a.c;
  uint8_t* prow = a.payload + (long long)blockIdx.y * a.row_bytes;
  const long long groups = (a.c + G - 1) / G;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < groups; j += stride) {
    int codes[G];
#pragma unroll
    for (int t = 0; t < G; ++t) {
      const long long col = j * G + t;
      const long long i = row0 + col;
      int code = 0;
      if (col < a.c && i < a.n) {
        const float xv = a.x[i];
        float level = 0.0f;
        if constexpr (KIND == kLog) {
          code = rt::log_code(xv, lg);
          level = __fmul_rn(rt::log_level(code, a.k), s);
        } else if constexpr (KIND == kUniform) {
          float cf = rt::uniform_code(xv, s_div, pow2);
          if (a.clip_abs > 0) cf = fminf(fmaxf(cf, -top), top);
          code = (int)cf;
          level = rt::uniform_level(cf, pow2, s);
        } else {
          const float p = __fdiv_rn(fabsf(xv), s_div);
          code = a.u[i] < p ? (xv > 0.0f) - (xv < 0.0f) : 0;
        }
        if constexpr (EF) a.e_out[i] = __fsub_rn(xv, level);
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
        else if constexpr (KIND == kUniform)
          out[i] = rt::uniform_level((float)codes[t], pow2, s);
        else
          out[i] = __fmul_rn((float)codes[t], s);
      }
    }
  }
}

template <int BITS, int KIND, bool EF>
int launch_encode(const Encode& a, int n_rows, cudaStream_t stream) {
  const long long groups = (a.c + rt::group_codes(BITS) - 1) /
                           rt::group_codes(BITS);
  dim3 grid(rt::blocks_per_row(groups, n_rows), n_rows);
  encode_kernel<BITS, KIND, EF><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int BITS>
int launch_encode_kind(const Encode& a, int kind, bool ef, int n_rows,
                       cudaStream_t st) {
  if (ef)
    return kind == kLog ? launch_encode<BITS, kLog, true>(a, n_rows, st)
                        : launch_encode<BITS, kUniform, true>(a, n_rows, st);
  if (kind == kLog) return launch_encode<BITS, kLog, false>(a, n_rows, st);
  if (kind == kUniform)
    return launch_encode<BITS, kUniform, false>(a, n_rows, st);
  return launch_encode<BITS, kTernary, false>(a, n_rows, st);
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

template <int BITS>
int launch_decode_kind(int kind, const void* payload, const void* scales,
                       const void* table, int half, void* out,
                       long long out_n, int n_rows, long long c,
                       long long row_bytes, int k, cudaStream_t st) {
  if (kind == kLog)
    return launch_decode<BITS, kLog>(payload, scales, table, half, out,
                                     out_n, n_rows, c, row_bytes, k, st);
  if (kind == kUniform)
    return launch_decode<BITS, kUniform>(payload, scales, table, half, out,
                                         out_n, n_rows, c, row_bytes, k, st);
  return launch_decode<BITS, kTernary>(payload, scales, table, half, out,
                                       out_n, n_rows, c, row_bytes, k, st);
}

bool valid_geometry(int kind, int bits, int n_rows, long long c,
                    long long row_bytes, int k) {
  if (kind != kLog && kind != kUniform && kind != kTernary) return false;
  if (n_rows < 1 || n_rows > 65535 || c < 1 || k < 0 || k > 30) return false;
  const int g = rt::group_codes(bits), nb = rt::group_nbytes(bits);
  return row_bytes == (c + g - 1) / g * nb;
}

int encode_rows(const Encode& a, int n_rows, int kind, int bits, bool ef,
                cudaStream_t st) {
  if (!valid_geometry(kind, bits, n_rows, a.c, a.row_bytes, a.k))
    return (int)cudaErrorInvalidValue;
  if (ef && kind == kTernary) return (int)cudaErrorInvalidValue;
#define CASE(B) \
  if (bits == B) return launch_encode_kind<B>(a, kind, ef, n_rows, st);
  RT_BITS_CASES(CASE)
#undef CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int rt_ef_encode_rows(const void* x, const void* scale,
                                 void* payload, void* e_out, long long n,
                                 int n_rows, long long c, long long row_bytes,
                                 int kind, int bits, int k, int clip_abs,
                                 void* stream) {
  const Encode a{(const float*)x, nullptr, (const float*)scale, nullptr,
                 (uint8_t*)payload, (float*)e_out, n, c, row_bytes, k,
                 clip_abs, 0};
  return encode_rows(a, n_rows, kind, bits, true, (cudaStream_t)stream);
}

extern "C" int rt_encode_rows(const void* x, const void* u, const void* scale,
                              int guard, void* scale_out, void* payload,
                              long long n, int n_rows, long long c,
                              long long row_bytes, int kind, int bits, int k,
                              int clip_abs, void* stream) {
  if (kind == kTernary && u == nullptr) return (int)cudaErrorInvalidValue;
  const Encode a{(const float*)x, (const float*)u, (const float*)scale,
                 (float*)scale_out, (uint8_t*)payload, nullptr, n, c,
                 row_bytes, k, clip_abs, guard};
  return encode_rows(a, n_rows, kind, bits, false, (cudaStream_t)stream);
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
#define CASE(B)                                                          \
  if (bits == B)                                                         \
    return launch_decode_kind<B>(kind, payload, scales, table, half, out, \
                                 out_n, n_rows, c, row_bytes, k, st);
  RT_BITS_CASES(CASE)
#undef CASE
  return (int)cudaErrorInvalidValue;
}
