// #14 blockwise quantize and #8 blockwise encode: the sign codes and
// per-block mean |x| scales of the ef_sgd baseline (Zheng et al. '19),
// over flat blocks of any power-of-two size b (1 .. 2^30), the tail block
// zero-padded.
//
// #14 replaces repro/comm/kernels.py blockwise_quantize_pallas
// (_blockwise_quantize_kernel): flat x -> (nb, b) int8 sign codes and
// (nb,) float32 scales (engine.quantize_blockwise; the update exchange of
// ef_sgd). #8 replaces encode_blockwise_pallas (_blockwise_encode_body):
// the same reduction, and the codes packed to 2-bit lanes by K7's packer
// (rt::pack_group) into the flat payload of pack_flat, cut to
// payload_nbytes(n) bytes (BlockwiseCodec.encode).
//
// The TPU kernels laid blocks on the sublanes of a VMEM tile, the whole
// block on the lane axis, and let jnp.mean reduce each row. Here a warp
// owns a tile of max(b, 128) elements: lane l holds elements
// (j * 32 + l) * 4 + t of it, t = 0..3 (one 16-byte load a chunk j;
// elements at or past n read 0). The mean's sum takes one fixed order, the
// halving tree of grids.tree_sum_last (s[i] + s[i + h], h = b/2, ..., 1),
// whose levels pair the index bits from the top down:
//   - b >= 128: the J = b / 128 chunk bits first, inside the lane. The
//     chunks are loaded in bit-reversed order and merged as a binary
//     counter (a stack of log2 J partial sums), which is the halving tree
//     over j with log2 J float4s of registers for any b; then the lane
//     bits by xor shuffles over lanes 16 .. 1 (they pair element i with
//     i + 4m); then t: (a0 + a2) + (a1 + a3);
//   - 4 <= b < 128: a block spans G = b / 4 lanes (32 / G blocks a warp);
//     xor shuffles over lanes G/2 .. 1 stay inside it, then t as above;
//   - b = 2, 1: a lane holds 4 / b whole blocks; (a0 + a1), (a2 + a3), or
//     each |a_t| alone.
// Every lane of a block ends with the same sum (IEEE addition commutes);
// times 1/b, exact. The kernels are bitwise their plain versions, and
// within a few ulps of XLA's own sum order.
//
// Both are bound by bytes: #14 reads 4 B and writes 1 B per element plus
// 4 B a block (5.02 B at b = 256); #8 reads 4 B and writes 0.25 B plus
// 4 B a block. Grid-stride over the warp tiles, 8 warps per CTA.
#include "grids.cuh"

namespace {

using rt::kThreads;
constexpr unsigned int kFull = 0xffffffffu;
constexpr int kMaxLogBlock = 30;

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

// The four elements' sign codes into the outputs: #14's int8 codes (the
// first `limit` = nb * b of them exist), or #8's payload byte e / 4.
template <bool PACK>
__device__ __forceinline__ void put_codes(const float v[4], void* out,
                                          long long e, long long limit,
                                          long long payload_bytes) {
  int c[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) c[t] = sign_code(v[t]);
  if constexpr (PACK) {
    if (e / 4 < payload_bytes) rt::pack_group<2>(c, (uint8_t*)out + e / 4);
  } else if (e + 3 < limit) {
    *reinterpret_cast<char4*>((int8_t*)out + e) =
        make_char4(c[0], c[1], c[2], c[3]);
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (e + t < limit) ((int8_t*)out)[e + t] = (int8_t)c[t];
  }
}

// PACK = false: #14, codes (nb, b) int8; PACK = true: #8, the 2-bit
// payload (payload_bytes of it). b = 2^LOGB.
template <int LOGB, bool PACK>
__global__ void blockwise_kernel(const float* __restrict__ x,
                                 void* __restrict__ out,
                                 float* __restrict__ scales, long long n,
                                 long long nb, long long payload_bytes,
                                 int vec) {
  constexpr long long kB = 1LL << LOGB;
  constexpr int LOGJ = LOGB > 7 ? LOGB - 7 : 0;   // chunk bits in a lane
  constexpr long long kTile = 128LL << LOGJ;       // elements a warp tile
  constexpr int G = LOGB >= 7 ? 32 : LOGB >= 2 ? (int)(kB / 4) : 1;
  const int lane = threadIdx.x & 31;
  const long long warp0 =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  const long long limit = nb * kB;                 // padded elements
  const long long tiles = (limit + kTile - 1) / kTile;
  const float inv = 1.0f / (float)kB;              // exact
  for (long long w = warp0; w < tiles; w += warps) {
    const long long base = w * kTile;
    float cur[4], st[LOGJ + 1][4];
    for (long long s = 0; s < (1LL << LOGJ); ++s) {
      long long j = 0;
      if constexpr (LOGJ > 0)
        j = (long long)(__brevll((unsigned long long)s) >> (64 - LOGJ));
      const long long e = base + (j * 32 + lane) * 4;
      float v[4];
      load4(x, e, n, vec, v);
      put_codes<PACK>(v, out, e, limit, payload_bytes);
#pragma unroll
      for (int t = 0; t < 4; ++t) cur[t] = fabsf(v[t]);
      // merge as a binary counter: s's trailing ones are the subtrees
      // this leaf completes
      bool carry = true;
#pragma unroll
      for (int lv = 0; lv < LOGJ; ++lv) {
        if (carry) {
          if ((s >> lv) & 1) {
#pragma unroll
            for (int t = 0; t < 4; ++t) cur[t] = __fadd_rn(st[lv][t], cur[t]);
          } else {
#pragma unroll
            for (int t = 0; t < 4; ++t) st[lv][t] = cur[t];
            carry = false;
          }
        }
      }
    }
    if constexpr (LOGB >= 2) {
#pragma unroll
      for (int m = G / 2; m >= 1; m >>= 1) {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          cur[t] = __fadd_rn(cur[t], __shfl_xor_sync(kFull, cur[t], m));
      }
      const float sum = __fadd_rn(__fadd_rn(cur[0], cur[2]),
                                  __fadd_rn(cur[1], cur[3]));
      const long long blk = (base + lane * 4) >> LOGB;
      if (lane % G == 0 && blk < nb) scales[blk] = __fmul_rn(sum, inv);
    } else {
      constexpr int PER = 4 >> LOGB;     // blocks a lane holds
      const long long blk0 = (base + lane * 4) >> LOGB;
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const float sum = LOGB == 1 ? __fadd_rn(cur[2 * q], cur[2 * q + 1])
                                    : cur[q];
        if (blk0 + q < nb) scales[blk0 + q] = __fmul_rn(sum, inv);
      }
    }
  }
}

template <int LOGB, bool PACK>
int launch(const void* x, void* out, void* scales, long long n, long long nb,
           long long payload_bytes, void* stream) {
  constexpr long long kTile = LOGB > 7 ? (1LL << LOGB) : 128;
  const long long tiles = (nb * (1LL << LOGB) + kTile - 1) / kTile;
  const int vec = (uintptr_t)x % 16 == 0;
  blockwise_kernel<LOGB, PACK>
      <<<rt::blocks_per_row(tiles * 32, 1), kThreads, 0,
         (cudaStream_t)stream>>>((const float*)x, out, (float*)scales, n, nb,
                                 payload_bytes, vec);
  return (int)cudaGetLastError();
}

template <bool PACK, int LOGB = 0>
int dispatch(int log_block, const void* x, void* out, void* scales,
             long long n, long long nb, long long payload_bytes,
             void* stream) {
  if constexpr (LOGB > kMaxLogBlock) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (log_block == LOGB)
      return launch<LOGB, PACK>(x, out, scales, n, nb, payload_bytes, stream);
    return dispatch<PACK, LOGB + 1>(log_block, x, out, scales, n, nb,
                                    payload_bytes, stream);
  }
}

int checked(bool pack, const void* x, void* out, void* scales, long long n,
            long long nb, long long payload_bytes, int log_block,
            void* stream) {
  if (n < 1 || log_block < 0 || log_block > kMaxLogBlock ||
      nb != ((n - 1) >> log_block) + 1)
    return (int)cudaErrorInvalidValue;
  if (!pack && (uintptr_t)out % 4) return (int)cudaErrorInvalidValue;
  if (pack && payload_bytes != (n + 3) / 4) return (int)cudaErrorInvalidValue;
  return pack ? dispatch<true>(log_block, x, out, scales, n, nb,
                               payload_bytes, stream)
              : dispatch<false>(log_block, x, out, scales, n, nb, 0, stream);
}

}  // namespace

extern "C" int rt_blockwise_quantize(const void* x, void* codes,
                                     void* scales, long long n, long long nb,
                                     int log_block, void* stream) {
  return checked(false, x, codes, scales, n, nb, 0, log_block, stream);
}

extern "C" int rt_blockwise_encode(const void* x, void* payload, void* scales,
                                   long long n, long long nb,
                                   long long payload_bytes, int log_block,
                                   void* stream) {
  return checked(true, x, payload, scales, n, nb, payload_bytes, log_block,
                 stream);
}
