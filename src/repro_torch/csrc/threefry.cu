// threefry2x32, the reference's counter-based generator: the keys of a
// training step and the uniforms of TernGrad's stochastic codes, bitwise
// jax.random's (jax_threefry_partitionable, the default since jax 0.5).
//
// Replaces no Pallas kernel: the reference draws its uniforms with XLA's
// threefry behind jax.random.uniform (repro/core/quantizers.py
// ternary_encode, repro/opt/engine.py quantize_ternary, repro/comm/codec.py
// Codec._draw), outside its kernels, and #13 and #5's ternary kind read
// them. Counter-based, a draw is a pure function of (key, element index),
// so the port's draws are the reference's, and a key a pure function of
// the state key or of (seed, step, leaf, worker): with the step count and
// the keys in device memory a CUDA graph of a step replays with each
// step's own draws.
//
// rt_threefry_keys writes a step's per-leaf keys into an (L, 2) table in
// one launch of one block: the distributed chain (repro/dist/step.py,
// fold_in(fold_in(fold_in(PRNGKey(seed), t), leaf), worker), t read from
// device memory) or Algorithm 1's (repro/core/qadam.py: key, sub =
// split(key); split(sub, L); the state key advanced in place, after a
// barrier that follows every thread's read of it).
//
// rt_threefry_uniform writes jax.random.uniform(keys[leaf], (n,)) over
// elements start .. start + n - 1: one threefry a element (64-bit element
// index as the counter pair (hi, lo)), bits = y0 ^ y1, the float
// bitcast((bits >> 9) | 0x3F800000) - 1, max(0, .). Bound: it reads
// nothing and writes 4 B a element, and does about 85 int32 operations a
// element (20 rounds of add, funnel-shift rotate and xor, five key
// injections of three adds, the counter and the float), so it is bound by
// the SMs' int32 rate, not by memory. Design: the rotations are
// __funnelshift_l (one SHF each), each thread makes four consecutive
// elements per pass and stores them as one float4 where the output is
// 16-byte aligned (a scalar tail), a grid-stride loop over at most 2048
// blocks. No fast math (none is needed: the only float operation, the
// subtraction of 1, is exact).
#include <cuda_runtime.h>
#include <stdint.h>

#include "grids.cuh"

namespace {

using rt::blocks_per_row;
using rt::kThreads;

__device__ __forceinline__ void threefry2x32(unsigned k0, unsigned k1,
                                             unsigned& x0, unsigned& x1) {
  const unsigned k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
#define RT_ROUND(r)                    \
  {                                    \
    x0 += x1;                          \
    x1 = __funnelshift_l(x1, x1, r);   \
    x1 ^= x0;                          \
  }
  RT_ROUND(13) RT_ROUND(15) RT_ROUND(26) RT_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  RT_ROUND(17) RT_ROUND(29) RT_ROUND(16) RT_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  RT_ROUND(13) RT_ROUND(15) RT_ROUND(26) RT_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  RT_ROUND(17) RT_ROUND(29) RT_ROUND(16) RT_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  RT_ROUND(13) RT_ROUND(15) RT_ROUND(26) RT_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
#undef RT_ROUND
}

__device__ __forceinline__ float uniform_at(unsigned k0, unsigned k1,
                                            unsigned long long i) {
  unsigned x0 = (unsigned)(i >> 32), x1 = (unsigned)i;
  threefry2x32(k0, k1, x0, x1);
  const unsigned bits = ((x0 ^ x1) >> 9) | 0x3F800000u;
  return fmaxf(__uint_as_float(bits) - 1.0f, 0.0f);
}

__global__ void threefry_uniform_kernel(float* __restrict__ out, long long n,
                                        unsigned long long start,
                                        const int* __restrict__ keys,
                                        int leaf, int vec4) {
  const unsigned k0 = (unsigned)keys[2 * leaf];
  const unsigned k1 = (unsigned)keys[2 * leaf + 1];
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (vec4) {
    const long long n4 = n / 4;
    float4* out4 = reinterpret_cast<float4*>(out);
    for (long long q = first; q < n4; q += stride) {
      const unsigned long long i = start + 4ull * (unsigned long long)q;
      float4 v;
      v.x = uniform_at(k0, k1, i);
      v.y = uniform_at(k0, k1, i + 1);
      v.z = uniform_at(k0, k1, i + 2);
      v.w = uniform_at(k0, k1, i + 3);
      out4[q] = v;
    }
    done = n4 * 4;
  }
  for (long long i = done + first; i < n; i += stride)
    out[i] = uniform_at(k0, k1, start + (unsigned long long)i);
}

// mode 0: the distributed chain from (seed_hi, seed_lo) and *t; mode 1:
// Algorithm 1's chain from *key, advanced in place. One block.
__global__ void threefry_keys_kernel(int* __restrict__ keys_out, int* key,
                                     unsigned seed_hi, unsigned seed_lo,
                                     const long long* __restrict__ t,
                                     int n_leaves, unsigned worker,
                                     int mode) {
  unsigned k0 = seed_hi, k1 = seed_lo;
  unsigned b0 = 0u, b1;
  if (mode == 0) {
    b1 = (unsigned)(*t);                 // fold_in(PRNGKey(seed), t)
  } else {
    k0 = (unsigned)key[0];
    k1 = (unsigned)key[1];
    b1 = 1u;                             // split(key)[1], the step's sub
  }
  threefry2x32(k0, k1, b0, b1);
  for (int l = threadIdx.x; l < n_leaves; l += blockDim.x) {
    unsigned y0 = 0u, y1 = (unsigned)l;  // fold_in(base, l) == split(.)[l]
    threefry2x32(b0, b1, y0, y1);
    if (mode == 0) {                     // fold_in(., worker)
      unsigned z0 = 0u, z1 = worker;
      threefry2x32(y0, y1, z0, z1);
      y0 = z0;
      y1 = z1;
    }
    keys_out[2 * l] = (int)y0;
    keys_out[2 * l + 1] = (int)y1;
  }
  if (mode == 1) {
    __syncthreads();                     // every thread has read *key
    if (threadIdx.x == 0) {
      unsigned y0 = 0u, y1 = 0u;         // split(key)[0], the next key
      threefry2x32(k0, k1, y0, y1);
      key[0] = (int)y0;
      key[1] = (int)y1;
    }
  }
}

}  // namespace

extern "C" int rt_threefry_keys(void* keys_out, void* key, unsigned seed_hi,
                                unsigned seed_lo, const void* t,
                                int n_leaves, unsigned worker, int mode,
                                void* stream) {
  if (n_leaves < 0 || (mode != 0 && mode != 1) ||
      (mode == 0 && t == nullptr) || (mode == 1 && key == nullptr) ||
      (n_leaves > 0 && keys_out == nullptr))
    return (int)cudaErrorInvalidValue;
  threefry_keys_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (int*)keys_out, (int*)key, seed_hi, seed_lo, (const long long*)t,
      n_leaves, worker, mode);
  return (int)cudaGetLastError();
}

extern "C" int rt_threefry_uniform(void* out, long long n, long long start,
                                   const void* keys, int leaf,
                                   void* stream) {
  if (n < 1 || start < 0 || leaf < 0) return (int)cudaErrorInvalidValue;
  const int vec4 = ((uintptr_t)out % 16 == 0);
  threefry_uniform_kernel<<<blocks_per_row(vec4 ? n / 4 : n, 1), kThreads, 0,
                            (cudaStream_t)stream>>>(
      (float*)out, n, (unsigned long long)start, (const int*)keys, leaf,
      vec4);
  return (int)cudaGetLastError();
}
