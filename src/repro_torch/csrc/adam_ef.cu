// K15 Adam+EF moments and K16 EF quantize: the two passes of the paper's
// leaf update (Algorithm 1 lines 3-6) behind qadam.update.
//
// Replace repro/kernels/adam_ef.py adam_moments_pallas (_moments_kernel)
// and ef_quantize_pallas (_ef_quantize_kernel).
//
// K15 reads (g, m, v, e) once and writes (m', v', Delta+e): 28 bytes per
// element, bound by bytes; m' and v' may overwrite m and v in place. The
// TPU kernel wrote one amax partial per grid step and reduced them
// outside; CUDA blocks run in no order, so each block reduces
// max|Delta+e| over its share and folds it into one device word with
// atomicMax on the bits of the nonnegative float (|x| bits order like the
// values, NaN above +inf), exact in any order, as K3 does.
// The hyperparameters [alpha_t, beta, theta_t, eps] arrive as a (4,)
// float32 device tensor: no host scalar, so a step never reads the device.
//
// Every operation is pinned to one IEEE rounding (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn, __fsqrt_rn) in the order of
// repro/opt/grids.py adam_ef_moments, with no fma contraction, so the
// plain PyTorch version (separate elementwise kernels) is bitwise equal.
//
// K16 reads Delta+e and the scale and writes int8 log-grid codes and
// e' = (Delta+e) - deq(codes): 9 bytes per element. The level is found by
// comparing y = |x| / max(s, 1e-30) against the grid's decision points
// (the reference's zero threshold and midpoints, grids.log_grid_table:
// 2^-(k+1) and 0.75 * 2^-j for shallow grids, an ulp or more off them
// for deep ones), with no log2 or exp2, one table read for y's binade;
// deq is the lane table's level times the scale, as log_dequantize
// computes it, not Delta+e - e'.
//
// Design for both: grid-stride loops with 16-byte float4 loads where the
// length and alignment allow (a scalar tail covers ragged lengths), at
// most ~16 blocks per SM in flight.
//
// The log grid's code (rt::log_code) and level (rt::lut_level) live in
// grids.cuh, shared with the wire's K7.
#include "grids.cuh"

namespace {

using rt::abs_bits;
using rt::kThreads;

struct Hyper {
  float alpha, beta, theta, eps, one_m_beta, one_m_theta;
};

__device__ __forceinline__ float moments1(float g, float m, float v, float e,
                                          const Hyper& h, float* m_new,
                                          float* v_new) {
  // v' = theta * v + ((1 - theta) * g) * g
  const float vn = __fadd_rn(__fmul_rn(h.theta, v),
                             __fmul_rn(__fmul_rn(h.one_m_theta, g), g));
  // m' = beta * m + (1 - beta) * g
  const float mn = __fadd_rn(__fmul_rn(h.beta, m), __fmul_rn(h.one_m_beta, g));
  *m_new = mn;
  *v_new = vn;
  // Delta + e = (alpha * m') / sqrt(v' + eps) + e
  return __fadd_rn(__fdiv_rn(__fmul_rn(h.alpha, mn),
                             __fsqrt_rn(__fadd_rn(vn, h.eps))), e);
}

__device__ __forceinline__ void fold_amax(unsigned int m,
                                          unsigned int* __restrict__ out) {
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
    if (lane == 0) atomicMax(out, m);
  }
}

// m_out and v_out may be m and v themselves (the optimizer updates its
// state in place): each element is read, then written, by one thread, so
// those four pointers carry no __restrict__.
__global__ void adam_moments_kernel(
    const float* __restrict__ g, const float* m, const float* v,
    const float* __restrict__ e, const float* __restrict__ hp, float* m_out,
    float* v_out, float* __restrict__ de_out,
    unsigned int* __restrict__ amax_bits, long long n, int vec4) {
  Hyper h;
  h.alpha = hp[0];
  h.beta = hp[1];
  h.theta = hp[2];
  h.eps = hp[3];
  h.one_m_beta = __fsub_rn(1.0f, h.beta);
  h.one_m_theta = __fsub_rn(1.0f, h.theta);
  unsigned int mx = 0u;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (vec4) {
    const long long n4 = n / 4;
    for (long long i = start; i < n4; i += stride) {
      const float4 g4 = reinterpret_cast<const float4*>(g)[i];
      const float4 m4 = reinterpret_cast<const float4*>(m)[i];
      const float4 v4 = reinterpret_cast<const float4*>(v)[i];
      const float4 e4 = reinterpret_cast<const float4*>(e)[i];
      float4 mo, vo, d;
      d.x = moments1(g4.x, m4.x, v4.x, e4.x, h, &mo.x, &vo.x);
      d.y = moments1(g4.y, m4.y, v4.y, e4.y, h, &mo.y, &vo.y);
      d.z = moments1(g4.z, m4.z, v4.z, e4.z, h, &mo.z, &vo.z);
      d.w = moments1(g4.w, m4.w, v4.w, e4.w, h, &mo.w, &vo.w);
      reinterpret_cast<float4*>(m_out)[i] = mo;
      reinterpret_cast<float4*>(v_out)[i] = vo;
      reinterpret_cast<float4*>(de_out)[i] = d;
      mx = max(mx, max(max(abs_bits(d.x), abs_bits(d.y)),
                       max(abs_bits(d.z), abs_bits(d.w))));
    }
    done = n4 * 4;
  }
  for (long long i = done + start; i < n; i += stride) {
    float mo, vo;
    const float d = moments1(g[i], m[i], v[i], e[i], h, &mo, &vo);
    m_out[i] = mo;
    v_out[i] = vo;
    de_out[i] = d;
    mx = max(mx, abs_bits(d));
  }
  fold_amax(mx, amax_bits);
}

struct LogLevels {
  const float* table;  // the lane's levels (grids.log_dequant_table)
  int half;
};

__device__ __forceinline__ void ef1(float x, const rt::LogGrid& q,
                                    const LogLevels& lv, int8_t* c,
                                    float* e_new) {
  *c = (int8_t)rt::log_code(x, q);
  *e_new = __fsub_rn(x, rt::lut_level(lv.table, lv.half, *c, q.s));
}

__global__ void ef_quantize_kernel(const float* __restrict__ de,
                                   const float* __restrict__ scale,
                                   const float* __restrict__ grid,
                                   const LogLevels lv,
                                   int8_t* __restrict__ codes,
                                   float* __restrict__ e_out, long long n,
                                   int k, int vec4) {
  const rt::LogGrid q = rt::make_log_grid(scale[0], k, grid);
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (vec4) {
    const long long n4 = n / 4;
    for (long long i = start; i < n4; i += stride) {
      const float4 x = reinterpret_cast<const float4*>(de)[i];
      char4 c;
      float4 r;
      int8_t cx, cy, cz, cw;
      ef1(x.x, q, lv, &cx, &r.x);
      ef1(x.y, q, lv, &cy, &r.y);
      ef1(x.z, q, lv, &cz, &r.z);
      ef1(x.w, q, lv, &cw, &r.w);
      c = make_char4(cx, cy, cz, cw);
      reinterpret_cast<char4*>(codes)[i] = c;
      reinterpret_cast<float4*>(e_out)[i] = r;
    }
    done = n4 * 4;
  }
  for (long long i = done + start; i < n; i += stride) {
    int8_t c;
    float r;
    ef1(de[i], q, lv, &c, &r);
    codes[i] = c;
    e_out[i] = r;
  }
}

unsigned int n_blocks(long long work) {
  return rt::blocks_per_row(work, 1);  // one flat row
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

extern "C" int rt_adam_moments(const void* g, const void* m, const void* v,
                               const void* e, const void* hp, void* m_out,
                               void* v_out, void* de_out, void* amax_bits,
                               long long n, void* stream) {
  const int vec4 = aligned16(g) && aligned16(m) && aligned16(v) &&
                   aligned16(e) && aligned16(m_out) && aligned16(v_out) &&
                   aligned16(de_out);
  adam_moments_kernel<<<n_blocks(vec4 ? n / 4 : n), kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const float*)g, (const float*)m, (const float*)v, (const float*)e,
      (const float*)hp, (float*)m_out, (float*)v_out, (float*)de_out,
      (unsigned int*)amax_bits, n, vec4);
  return (int)cudaGetLastError();
}

extern "C" int rt_ef_quantize(const void* de, const void* scale,
                              const void* grid, const void* table, int half,
                              void* codes, void* e_out, long long n, int k_g,
                              void* stream) {
  if (k_g < 0 || k_g > rt::kMaxLogK || grid == nullptr || table == nullptr ||
      half < 1)
    return (int)cudaErrorInvalidValue;
  const int vec4 = aligned16(de) && aligned16(e_out) &&
                   ((uintptr_t)codes % 4 == 0);
  ef_quantize_kernel<<<n_blocks(vec4 ? n / 4 : n), kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const float*)de, (const float*)scale, (const float*)grid,
      LogLevels{(const float*)table, half}, (int8_t*)codes, (float*)e_out, n,
      k_g, vec4);
  return (int)cudaGetLastError();
}
