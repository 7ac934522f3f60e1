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
//
// rt_threefry_trunc_normal draws a stacked leaf of Model.init in one
// launch: element i of layer l is jax.random.truncated_normal(keys[l], -2,
// 2) at counter start + i (repro/models/model.py _dense, vmapped over the
// layer keys), times std, in jax 0.9.0's float32 formula: u = max(a, f (b
// - a) + a) on the uniform f, a and b jax's float32 erf(-+sqrt2);
// sqrt2 * erf_inv(u) through XLA's float32 ErfInv polynomial (Giles: w =
// -log1p(-u^2), nine coefficients in two sets split at w < 5); clamped to
// nextafter(-+2, 0). It replaces no Pallas kernel: the reference draws its
// weights with XLA's threefry and erf_inv behind truncated_normal. Bound:
// 4 B a element written and ~127 operations a element (the uniform's 77,
// log1pf's ~20, the polynomial's 17, the rest), so the int32 and float
// dispatch rate bounds it, not memory. Design: as rt_threefry_uniform,
// four consecutive elements a thread and one float4 store where the layer's
// output is 16-byte aligned, a grid row per layer. Every float operation
// is an explicit IEEE operation (__fmul_rn, __fadd_rn, __fsqrt_rn): nvcc
// would contract a*b + c into an fma that the plain version's separate
// operations do not make.
//
// rt_threefry_categorical and rt_threefry_categorical_fold do one sampling
// step of the serving session for B slots (repro/serve/session.py: keys =
// vmap(split)(rng); categorical(keys[:, 1], logits / max(temp, 1e-6));
// argmax(logits); rng = where(temp > 0, keys[:, 0], rng)). It replaces no
// Pallas kernel (the reference samples with XLA inside its jitted step).
// The first launch, a grid of (chunks of V, B), scores each element of its
// chunk, logits / max(temp, 1e-6) + gumbel(k_draw, V)[v], jax's mode="low"
// Gumbel -log(-log(max(tiny, f + tiny))), and writes the chunk's (max,
// first index) of the scores and of the logits (the greedy token) into a
// partials buffer; the second, one block a slot, folds the chunks' partials
// in a fixed order, writes the greedy and the sampled token, and writes
// keys[:, 0] over the slot's key where temp > 0. Keys live in device memory
// and nothing is reset between launches, so a CUDA graph of the step
// replays with each step's own draws. Argmax order: a larger score wins, an
// equal one the lower index; NaN counts as the largest (jnp.argmax's). Bound:
// it reads the logits once (4 B a element), and ~120 operations a element
// (the uniform, two logf, the division) bound it at the vocabularies of
// the served models.
#include <cuda_runtime.h>
#include <math.h>
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

__device__ __forceinline__ float bits_to_unit(unsigned x0, unsigned x1) {
  const unsigned bits = ((x0 ^ x1) >> 9) | 0x3F800000u;
  return __fadd_rn(__uint_as_float(bits), -1.0f);
}

// jax's float32 sqrt2 and nextafter(+-2, 0), by their bit patterns; a and
// span (b - a) come from the wrapper (core/threefry.py TRUNC_ERF_BITS)
__device__ __forceinline__ float trunc_normal_at(unsigned k0, unsigned k1,
                                                 unsigned long long i,
                                                 float a, float span,
                                                 float std) {
  // XLA's float32 ErfInv coefficients (core/threefry.py ERFINV_LT5/GE5)
  constexpr float lt5[9] = {2.81022636e-08f,  3.43273939e-07f,
                            -3.5233877e-06f,  -4.39150654e-06f,
                            0.00021858087f,   -0.00125372503f,
                            -0.00417768164f,  0.246640727f, 1.50140941f};
  constexpr float ge5[9] = {-0.000200214257f, 0.000100950558f,
                            0.00134934322f,   -0.00367342844f,
                            0.00573950773f,   -0.0076224613f,
                            0.00943887047f,   1.00167406f, 2.83297682f};
  unsigned x0 = (unsigned)(i >> 32), x1 = (unsigned)i;
  threefry2x32(k0, k1, x0, x1);
  const float f = bits_to_unit(x0, x1);
  const float u = fmaxf(__fadd_rn(__fmul_rn(f, span), a), a);
  float w = -log1pf(-__fmul_rn(u, u));
  const bool lt = w < 5.0f;
  w = lt ? __fadd_rn(w, -2.5f) : __fadd_rn(__fsqrt_rn(w), -3.0f);
  float p = lt ? lt5[0] : ge5[0];
#pragma unroll
  for (int j = 1; j < 9; ++j)
    p = __fadd_rn(lt ? lt5[j] : ge5[j], __fmul_rn(p, w));
  float out = __fmul_rn(__int_as_float(0x3FB504F3), __fmul_rn(p, u));
  out = fminf(fmaxf(out, __int_as_float(0xBFFFFFFF)),
              __int_as_float(0x3FFFFFFF));
  return __fmul_rn(out, std);
}

__global__ void threefry_trunc_normal_kernel(float* __restrict__ out,
                                             long long n,
                                             unsigned long long start,
                                             const int* __restrict__ keys,
                                             float a, float span, float std,
                                             int aligned) {
  const int l = blockIdx.y;
  const unsigned k0 = (unsigned)keys[2 * l];
  const unsigned k1 = (unsigned)keys[2 * l + 1];
  float* row = out + (long long)l * n;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long done = 0;
  if (aligned) {
    const long long n4 = n / 4;
    float4* row4 = reinterpret_cast<float4*>(row);
    for (long long q = first; q < n4; q += stride) {
      const unsigned long long i = start + 4ull * (unsigned long long)q;
      float4 v;
      v.x = trunc_normal_at(k0, k1, i, a, span, std);
      v.y = trunc_normal_at(k0, k1, i + 1, a, span, std);
      v.z = trunc_normal_at(k0, k1, i + 2, a, span, std);
      v.w = trunc_normal_at(k0, k1, i + 3, a, span, std);
      row4[q] = v;
    }
    done = n4 * 4;
  }
  for (long long i = done + first; i < n; i += stride)
    row[i] = trunc_normal_at(k0, k1, start + (unsigned long long)i, a, span,
                             std);
}

// (max, first index) pairs: b replaces a when larger, or equal at a lower
// index; NaN is the largest, the first NaN wins
__device__ __forceinline__ bool beats(float bv, int bi, float av, int ai) {
  if (bv != bv) return !(av != av) || bi < ai;
  if (av != av) return false;
  return bv > av || (bv == av && bi < ai);
}

constexpr int kCatChunk = 4096;   // elements of V a block scores
                                  // (kernels/prng.py CAT_CHUNK)

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, o);
    const int oi = __shfl_down_sync(0xffffffffu, i, o);
    if (beats(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

// The block's best of two (value, index) pairs a thread, over its warps
// in order; true in the thread that holds them (thread 0). Every thread of
// the block calls it.
__device__ __forceinline__ bool block_best(float& sv, int& si, float& gv,
                                           int& gi, int V) {
  __shared__ float s_v[2][32];
  __shared__ int s_i[2][32];
  warp_best(sv, si);
  warp_best(gv, gi);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_v[0][warp] = sv; s_i[0][warp] = si;
    s_v[1][warp] = gv; s_i[1][warp] = gi;
  }
  __syncthreads();
  if (warp != 0) return false;
  const int nw = blockDim.x >> 5;
  sv = lane < nw ? s_v[0][lane] : -INFINITY;
  si = lane < nw ? s_i[0][lane] : V;
  gv = lane < nw ? s_v[1][lane] : -INFINITY;
  gi = lane < nw ? s_i[1][lane] : V;
  warp_best(sv, si);
  warp_best(gv, gi);
  return lane == 0;
}

// partials: (B, chunks, 4) words: sampled max, its index, greedy max, its
// index
__global__ void threefry_categorical_kernel(const float* __restrict__ logits,
                                            const float* __restrict__ temp,
                                            const int* __restrict__ rng,
                                            int V, int chunks,
                                            int* __restrict__ partials) {
  const int b = blockIdx.y;
  unsigned d0 = 0u, d1 = 1u;                // split(rng[b])[1], the draw key
  threefry2x32((unsigned)rng[2 * b], (unsigned)rng[2 * b + 1], d0, d1);
  const float t = fmaxf(temp[b], 1e-6f);
  const float* row = logits + (long long)b * V;
  const int lo = blockIdx.x * kCatChunk;
  const int hi = min(V, lo + kCatChunk);
  float sv = -INFINITY, gv = -INFINITY;
  int si = V, gi = V;
  for (int v = lo + threadIdx.x; v < hi; v += blockDim.x) {
    const float x = row[v];
    unsigned x0 = 0u, x1 = (unsigned)v;
    threefry2x32(d0, d1, x0, x1);
    const float f = bits_to_unit(x0, x1);
    const float tiny = __int_as_float(0x00800000);
    const float u = fmaxf(__fadd_rn(f, tiny), tiny);
    const float g = -logf(-logf(u));
    const float s = __fadd_rn(g, __fdiv_rn(x, t));
    if (beats(s, v, sv, si)) { sv = s; si = v; }
    if (beats(x, v, gv, gi)) { gv = x; gi = v; }
  }
  if (block_best(sv, si, gv, gi, V)) {
    int* p = partials + ((long long)b * chunks + blockIdx.x) * 4;
    p[0] = __float_as_int(sv); p[1] = si;
    p[2] = __float_as_int(gv); p[3] = gi;
  }
}

// one block a slot: fold the chunks' partials, write the tokens and the key
__global__ void threefry_categorical_fold_kernel(
    const int* __restrict__ partials, int chunks, int V,
    const float* __restrict__ temp, int* rng, int* __restrict__ greedy,
    int* __restrict__ sampled) {
  const int b = blockIdx.x;
  float sv = -INFINITY, gv = -INFINITY;
  int si = V, gi = V;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const int* p = partials + ((long long)b * chunks + c) * 4;
    const float pv = __int_as_float(p[0]), qv = __int_as_float(p[2]);
    if (beats(pv, p[1], sv, si)) { sv = pv; si = p[1]; }
    if (beats(qv, p[3], gv, gi)) { gv = qv; gi = p[3]; }
  }
  if (block_best(sv, si, gv, gi, V)) {
    sampled[b] = si;
    greedy[b] = gi;
    if (temp[b] > 0.0f) {                   // keys[:, 0] where hot
      unsigned y0 = 0u, y1 = 0u;
      threefry2x32((unsigned)rng[2 * b], (unsigned)rng[2 * b + 1], y0, y1);
      rng[2 * b] = (int)y0;
      rng[2 * b + 1] = (int)y1;
    }
  }
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

extern "C" int rt_threefry_trunc_normal(void* out, long long n,
                                        long long start, const void* keys,
                                        int n_rows, float a, float span,
                                        float std, void* stream) {
  if (n < 1 || start < 0 || n_rows < 1 || n_rows > 65535)
    return (int)cudaErrorInvalidValue;
  // float4 stores where every row starts 16-byte aligned (or one row)
  const int aligned =
      ((uintptr_t)out % 16 == 0) && (n % 4 == 0 || n_rows == 1);
  dim3 grid(blocks_per_row(aligned ? n / 4 : n, n_rows), n_rows);
  threefry_trunc_normal_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (float*)out, n, (unsigned long long)start, (const int*)keys, a, span,
      std, aligned);
  return (int)cudaGetLastError();
}

extern "C" int rt_threefry_categorical(const void* logits, const void* temp,
                                       void* rng, int B, int V, void* partials,
                                       void* greedy, void* sampled,
                                       void* stream) {
  if (B < 1 || B > 65535 || V < 1) return (int)cudaErrorInvalidValue;
  const int chunks = (V + kCatChunk - 1) / kCatChunk;
  threefry_categorical_kernel<<<dim3(chunks, B), kThreads, 0,
                                (cudaStream_t)stream>>>(
      (const float*)logits, (const float*)temp, (const int*)rng, V, chunks,
      (int*)partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  threefry_categorical_fold_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)partials, chunks, V, (const float*)temp, (int*)rng,
      (int*)greedy, (int*)sampled);
  return (int)cudaGetLastError();
}
