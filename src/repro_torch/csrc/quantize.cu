// K3 per-row amax and K4 per-row uniform quantize (the Q_x residency
// passes behind quantize_params), #10 log quantize and #13 ternary
// quantize (the code-level Q_g and TernGrad quantizers).
//
// Replaces repro/comm/kernels.py amax_pallas, uniform_quantize_pallas,
// log_quantize_pallas and ternary_quantize_pallas.
// The TPU amax carried a running max through SMEM scratch across a grid
// that runs in order; CUDA blocks run in no order, so each block reduces
// its share of a row and folds it into the row's result with atomicMax
// on the bits of the nonnegative float (|x| bits order like the values,
// NaN above +inf, so max is exact and the scale stays bitwise).
//
// All four passes are bound by bytes: amax reads the leaf once; quantize
// reads it once more and writes 1 or 2 bytes per element; #10 reads 4 B
// and writes 1 B per element (5 B); #13 reads x and the caller's
// uniforms and writes 1 B (9 B). Design: 16-byte float4 loads where the
// row length and alignment allow (#10 and #13: the float4 body, then a
// tail of at most 3 elements), one grid row of blocks per tensor row (a
// stacked (L, ...) leaf gets its L scales in one launch), enough blocks
// per row to fill the 132 SMs. #10 and #13 read their one scale from
// device memory, so no caller waits for the amax pass on the host.
//
// Arithmetic of K4 follows repro/opt/grids.py uniform_quantize exactly:
// y = clip(x / max(s, 1e-30), -1, 1); code = round_half_even(y * 2^k)
// (rt::uniform_code in grids.cuh). #10 is grids.log_quantize as K16 and
// K7 already compute it (rt::log_code: the reference's decision points,
// grids.log_grid_table, compared exactly, no log2 or exp2; k up to
// 126). #13 is grids.ternary_quantize, sign(x) *
// [u < |x| / max(s, 1e-30)]: the division is the IEEE division (no
// reciprocal), the rule #5's ternary kind holds bitwise. No fast math.
#include "grids.cuh"

namespace {

using rt::abs_bits;
using rt::blocks_per_row;
using rt::kThreads;

__global__ void amax_rows_kernel(const float* __restrict__ x,
                                 unsigned int* __restrict__ out,
                                 long long n, int vec4) {
  const int r = blockIdx.y;
  const float* row = x + (long long)r * n;
  unsigned int m = 0u;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (vec4) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
    const long long n4 = n / 4;
    for (long long i = start; i < n4; i += stride) {
      float4 v = row4[i];
      m = max(m, max(max(abs_bits(v.x), abs_bits(v.y)),
                     max(abs_bits(v.z), abs_bits(v.w))));
    }
  } else {
    for (long long i = start; i < n; i += stride) m = max(m, abs_bits(row[i]));
  }
  for (int off = 16; off > 0; off >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ unsigned int warp_max[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < (int)(blockDim.x >> 5) ? warp_max[lane] : 0u;
    for (int off = 16; off > 0; off >>= 1)
      m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (lane == 0) atomicMax(out + r, m);
  }
}

template <typename CT>
__global__ void uniform_quantize_kernel(const float* __restrict__ x,
                                        const float* __restrict__ scale,
                                        CT* __restrict__ codes, long long n,
                                        float pow2, int vec4) {
  const int r = blockIdx.y;
  const float s = fmaxf(scale[r], 1e-30f);
  const float* row = x + (long long)r * n;
  CT* crow = codes + (long long)r * n;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (vec4) {
    const float4* row4 = reinterpret_cast<const float4*>(row);
    const long long n4 = n / 4;
    for (long long i = start; i < n4; i += stride) {
      float4 v = row4[i];
      CT c[4] = {(CT)rt::uniform_code(v.x, s, pow2),
                 (CT)rt::uniform_code(v.y, s, pow2),
                 (CT)rt::uniform_code(v.z, s, pow2),
                 (CT)rt::uniform_code(v.w, s, pow2)};
      if (sizeof(CT) == 1) {
        char4 o = make_char4(c[0], c[1], c[2], c[3]);
        reinterpret_cast<char4*>(crow)[i] = o;
      } else {
        short4 o = make_short4(c[0], c[1], c[2], c[3]);
        reinterpret_cast<short4*>(crow)[i] = o;
      }
    }
  } else {
    for (long long i = start; i < n; i += stride)
      crow[i] = (CT)rt::uniform_code(row[i], s, pow2);
  }
}

__device__ __forceinline__ int8_t ternary_code(float x, float u, float s_div) {
  const float p = __fdiv_rn(fabsf(x), s_div);
  return u < p ? (int8_t)((x > 0.0f) - (x < 0.0f)) : (int8_t)0;
}

__global__ void log_quantize_kernel(const float* __restrict__ x,
                                    const float* __restrict__ scale,
                                    const float* __restrict__ grid,
                                    int8_t* __restrict__ codes, long long n,
                                    int k, int vec4) {
  const rt::LogGrid q = rt::make_log_grid(scale[0], k, grid);
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long n4 = vec4 ? n / 4 : 0;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  char4* c4 = reinterpret_cast<char4*>(codes);
  for (long long i = start; i < n4; i += stride) {
    const float4 v = x4[i];
    c4[i] = make_char4(rt::log_code(v.x, q), rt::log_code(v.y, q),
                       rt::log_code(v.z, q), rt::log_code(v.w, q));
  }
  for (long long i = 4 * n4 + start; i < n; i += stride)
    codes[i] = (int8_t)rt::log_code(x[i], q);
}

__global__ void ternary_quantize_kernel(const float* __restrict__ x,
                                        const float* __restrict__ u,
                                        const float* __restrict__ scale,
                                        int8_t* __restrict__ codes,
                                        long long n, int vec4) {
  const float s = scale[0];
  const float s_div = s < 1e-30f ? 1e-30f : s;  // NaN passes through
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long n4 = vec4 ? n / 4 : 0;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* u4 = reinterpret_cast<const float4*>(u);
  char4* c4 = reinterpret_cast<char4*>(codes);
  for (long long i = start; i < n4; i += stride) {
    const float4 v = x4[i], w = u4[i];
    c4[i] = make_char4(ternary_code(v.x, w.x, s_div),
                       ternary_code(v.y, w.y, s_div),
                       ternary_code(v.z, w.z, s_div),
                       ternary_code(v.w, w.w, s_div));
  }
  for (long long i = 4 * n4 + start; i < n; i += stride)
    codes[i] = ternary_code(x[i], u[i], s_div);
}

}  // namespace

extern "C" int rt_amax_rows(const void* x, void* out_bits, int rows,
                            long long n, void* stream) {
  const int vec4 = (n % 4 == 0) && ((uintptr_t)x % 16 == 0);
  dim3 grid(blocks_per_row(vec4 ? n / 4 : n, rows), rows);
  amax_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (unsigned int*)out_bits, n, vec4);
  return (int)cudaGetLastError();
}

extern "C" int rt_uniform_quantize_rows(const void* x, const void* scale,
                                        void* codes, int rows, long long n,
                                        int k_x, int code_bytes,
                                        void* stream) {
  const int vec4 = (n % 4 == 0) && ((uintptr_t)x % 16 == 0) &&
                   ((uintptr_t)codes % (4 * code_bytes) == 0);
  dim3 grid(blocks_per_row(vec4 ? n / 4 : n, rows), rows);
  const float pow2 = (float)(1 << k_x);
  if (code_bytes == 1) {
    uniform_quantize_kernel<int8_t><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)scale, (int8_t*)codes, n, pow2, vec4);
  } else if (code_bytes == 2) {
    uniform_quantize_kernel<int16_t><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)scale, (int16_t*)codes, n, pow2, vec4);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int rt_log_quantize(const void* x, const void* scale,
                               const void* grid, void* codes, long long n,
                               int k_g, void* stream) {
  if (n < 1 || k_g < 0 || k_g > rt::kMaxLogK || grid == nullptr)
    return (int)cudaErrorInvalidValue;
  const int vec4 = ((uintptr_t)x % 16 == 0) && ((uintptr_t)codes % 4 == 0);
  log_quantize_kernel<<<blocks_per_row(vec4 ? n / 4 : n, 1), kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const float*)x, (const float*)scale, (const float*)grid,
      (int8_t*)codes, n, k_g, vec4);
  return (int)cudaGetLastError();
}

extern "C" int rt_ternary_quantize(const void* x, const void* u,
                                   const void* scale, void* codes,
                                   long long n, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int vec4 = ((uintptr_t)x % 16 == 0) && ((uintptr_t)u % 16 == 0) &&
                   ((uintptr_t)codes % 4 == 0);
  ternary_quantize_kernel<<<blocks_per_row(vec4 ? n / 4 : n, 1), kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const float*)x, (const float*)u, (const float*)scale, (int8_t*)codes,
      n, vec4);
  return (int)cudaGetLastError();
}
