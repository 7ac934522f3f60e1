// K11 log-grid dequantize and K12 per-row uniform dequantize.
//
// K11 replaces repro/comm/kernels.py log_dequantize_pallas: int8 Q_g codes
// and a scale become float32 table[c] * scale, where table holds the scale-1
// value of every lane code (sign(c) * 2^(|c|-k-1), 0 for c = 0), built on
// the host and handed over as a small device tensor. Each block copies it
// into shared memory: lanes of a warp look up different codes, which a
// __constant__ table would serve one address at a time. One rounding (the
// multiply by the scale), as the reference's sign(c) * val * scale.
// Bound by bytes: 1 read and 4 written per element.
//
// K12 replaces repro/comm/kernels.py uniform_dequantize_pallas: int8/int16
// Q_x codes become (c / 2^k) * s in float32, one scale per row of a
// (rows, n) view (the division by a power of two is exact; IEEE multiply,
// no fast math), bitwise repro/opt/grids.py uniform_dequantize. Bound by
// bytes: 2 read and 4 written per element for int16 codes.
//
// Design for both: grid-stride loops, 4 codes a thread (char4/short4 loads,
// float4 stores) where the length and alignment allow, a scalar tail for
// ragged lengths; K12 takes one grid row of blocks per tensor row.
#include "grids.cuh"

namespace {

using rt::blocks_per_row;
using rt::kThreads;
constexpr int kMaxTable = 256;  // every int8 lane

__global__ void log_dequantize_kernel(const int8_t* __restrict__ codes,
                                      const float* __restrict__ scale,
                                      const float* __restrict__ table,
                                      int half, float* __restrict__ out,
                                      long long n, int vec4) {
  __shared__ float tbl[kMaxTable];
  for (int i = threadIdx.x; i < 2 * half; i += blockDim.x) tbl[i] = table[i];
  __syncthreads();
  const float s = scale[0];
  auto deq = [&](int8_t c) { return rt::lut_level(tbl, half, c, s); };
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (vec4) {
    const long long n4 = n / 4;
    for (long long i = start; i < n4; i += stride) {
      const char4 c = reinterpret_cast<const char4*>(codes)[i];
      reinterpret_cast<float4*>(out)[i] =
          make_float4(deq(c.x), deq(c.y), deq(c.z), deq(c.w));
    }
    done = n4 * 4;
  }
  for (long long i = done + start; i < n; i += stride) out[i] = deq(codes[i]);
}

template <typename CT, typename CT4>
__global__ void uniform_dequantize_kernel(const CT* __restrict__ codes,
                                          const float* __restrict__ scale,
                                          float* __restrict__ out,
                                          long long n, float pow2, int vec4) {
  const int r = blockIdx.y;
  const float s = scale[r];
  const CT* crow = codes + (long long)r * n;
  float* orow = out + (long long)r * n;
  auto deq = [&](CT c) { return rt::uniform_level((float)c, pow2, s); };
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (vec4) {
    const long long n4 = n / 4;
    for (long long i = start; i < n4; i += stride) {
      const CT4 c = reinterpret_cast<const CT4*>(crow)[i];
      reinterpret_cast<float4*>(orow)[i] =
          make_float4(deq(c.x), deq(c.y), deq(c.z), deq(c.w));
    }
    done = n4 * 4;
  }
  for (long long i = done + start; i < n; i += stride) orow[i] = deq(crow[i]);
}

}  // namespace

extern "C" int rt_log_dequantize(const void* codes, const void* scale,
                                 const void* table, int half, void* out,
                                 long long n, void* stream) {
  if (half < 1 || 2 * half > kMaxTable) return (int)cudaErrorInvalidValue;
  // one flat tensor: the scalar tail covers n % 4
  const int vec4 = ((uintptr_t)codes % 4 == 0) && ((uintptr_t)out % 16 == 0);
  log_dequantize_kernel<<<blocks_per_row(vec4 ? n / 4 : n, 1), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const int8_t*)codes, (const float*)scale, (const float*)table, half,
      (float*)out, n, vec4);
  return (int)cudaGetLastError();
}

extern "C" int rt_uniform_dequantize_rows(const void* codes, const void* scale,
                                          void* out, int rows, long long n,
                                          int k_x, int code_bytes,
                                          void* stream) {
  if (k_x < 0 || k_x > 30) return (int)cudaErrorInvalidValue;
  // every row starts aligned only when n % 4 == 0
  const int vec4 = (n % 4 == 0) && ((uintptr_t)out % 16 == 0) &&
                   ((uintptr_t)codes % (4 * code_bytes) == 0);
  dim3 grid(blocks_per_row(vec4 ? n / 4 : n, rows), rows);
  const float pow2 = (float)(1 << k_x);
  if (code_bytes == 1) {
    uniform_dequantize_kernel<int8_t, char4>
        <<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            (const int8_t*)codes, (const float*)scale, (float*)out, n, pow2,
            vec4);
  } else if (code_bytes == 2) {
    uniform_dequantize_kernel<int16_t, short4>
        <<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            (const int16_t*)codes, (const float*)scale, (float*)out, n, pow2,
            vec4);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
