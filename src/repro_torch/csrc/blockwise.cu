// #14 blockwise quantize and #8 blockwise encode: the sign codes and
// per-block mean |x| scales of the ef_sgd baseline (Zheng et al. '19),
// over flat blocks of 256 elements, the tail block zero-padded.
//
// #14 replaces repro/comm/kernels.py blockwise_quantize_pallas
// (_blockwise_quantize_kernel): flat x -> (nb, 256) int8 sign codes and
// (nb,) float32 scales (engine.quantize_blockwise; the update exchange of
// ef_sgd). #8 replaces encode_blockwise_pallas (_blockwise_encode_body):
// the same reduction, and the codes packed to 2-bit lanes by K7's packer
// (rt::pack_group) into the flat payload of pack_flat, cut to
// payload_nbytes(n) bytes (BlockwiseCodec.encode).
//
// The TPU kernels laid 8 blocks on the sublanes of a (8, 256) VMEM tile
// and let jnp.mean reduce each row. Here one warp owns one block: lane l
// holds elements 4l..4l+3 and 128+4l..128+4l+3 (two 16-byte loads,
// elements at or past n read 0), and the mean's sum takes one fixed order,
// the halving tree of grids.tree_sum_last (s[i] + s[i + h], h = 128, 64,
// ..., 1): h = 128 inside the lane, h = 64 .. 4 by xor shuffles over
// lanes 16 .. 1 (they pair element i with i + 4m), h = 2 and 1 inside the
// lane. Every lane ends with the same sum (IEEE addition commutes); times
// 1/256, exact. The kernels are bitwise their plain versions, and within a
// few ulps of XLA's own sum order.
//
// Both are bound by bytes: #14 reads 4 B and writes 1 B per element plus
// 4 B a block (5.02 B); #8 reads 4 B and writes 0.25 B plus 4 B a block
// (4.27 B). Grid-stride over the blocks, 8 blocks (warps) per CTA.
#include "grids.cuh"

namespace {

using rt::kThreads;
constexpr int kBlock = 256;
constexpr unsigned int kFull = 0xffffffffu;

__device__ __forceinline__ void load4(const float* x, long long i,
                                      long long n, int vec, float v[4]) {
  if (vec && i + 3 < n) {
    const float4 f = *reinterpret_cast<const float4*>(x + i);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) v[t] = i + t < n ? x[i + t] : 0.0f;
  }
}

__device__ __forceinline__ int sign_code(float v) {
  return (v > 0.0f) - (v < 0.0f);
}

// The block's sum of |x| in the halving tree's order (see above).
__device__ __forceinline__ float block_abs_sum(const float lo[4],
                                               const float hi[4]) {
  float a[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) a[t] = __fadd_rn(fabsf(lo[t]), fabsf(hi[t]));
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) {
#pragma unroll
    for (int t = 0; t < 4; ++t)
      a[t] = __fadd_rn(a[t], __shfl_xor_sync(kFull, a[t], m));
  }
  return __fadd_rn(__fadd_rn(a[0], a[2]), __fadd_rn(a[1], a[3]));
}

// PACK = false: #14, codes (nb, 256) int8; PACK = true: #8, the 2-bit
// payload (payload_bytes of it).
template <bool PACK>
__global__ void blockwise_kernel(const float* __restrict__ x,
                                 void* __restrict__ out,
                                 float* __restrict__ scales, long long n,
                                 long long nb, long long payload_bytes,
                                 int vec) {
  const int lane = threadIdx.x & 31;
  const long long warp0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long b = warp0; b < nb; b += warps) {
    const long long base = b * kBlock;
    float lo[4], hi[4];
    load4(x, base + 4 * lane, n, vec, lo);
    load4(x, base + 128 + 4 * lane, n, vec, hi);
    const float sum = block_abs_sum(lo, hi);
    if (lane == 0) scales[b] = __fmul_rn(sum, 1.0f / kBlock);
    int clo[4], chi[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      clo[t] = sign_code(lo[t]);
      chi[t] = sign_code(hi[t]);
    }
    if constexpr (PACK) {
      uint8_t* p = (uint8_t*)out + b * (kBlock / 4);
      const long long at = b * (kBlock / 4);
      if (at + lane < payload_bytes) rt::pack_group<2>(clo, p + lane);
      if (at + 32 + lane < payload_bytes)
        rt::pack_group<2>(chi, p + 32 + lane);
    } else {
      char4* c = reinterpret_cast<char4*>((int8_t*)out + base);
      c[lane] = make_char4(clo[0], clo[1], clo[2], clo[3]);
      c[32 + lane] = make_char4(chi[0], chi[1], chi[2], chi[3]);
    }
  }
}

template <bool PACK>
int launch(const void* x, void* out, void* scales, long long n, long long nb,
           long long payload_bytes, void* stream) {
  if (n < 1 || nb != (n + kBlock - 1) / kBlock)
    return (int)cudaErrorInvalidValue;
  if (!PACK && (uintptr_t)out % 4) return (int)cudaErrorInvalidValue;
  if (PACK && payload_bytes != (n + 3) / 4) return (int)cudaErrorInvalidValue;
  const int vec = (uintptr_t)x % 16 == 0;
  blockwise_kernel<PACK>
      <<<rt::blocks_per_row(nb * 32, 1), kThreads, 0, (cudaStream_t)stream>>>(
          (const float*)x, out, (float*)scales, n, nb, payload_bytes, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rt_blockwise_quantize(const void* x, void* codes,
                                     void* scales, long long n, long long nb,
                                     void* stream) {
  return launch<false>(x, codes, scales, n, nb, 0, stream);
}

extern "C" int rt_blockwise_encode(const void* x, void* payload, void* scales,
                                   long long n, long long nb,
                                   long long payload_bytes, void* stream) {
  return launch<true>(x, payload, scales, n, nb, payload_bytes, stream);
}
