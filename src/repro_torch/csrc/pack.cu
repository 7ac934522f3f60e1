// #9 lane pack and unpack: signed codes in (rows, c) to the wire's packed
// uint8 rows of comm/bits.py pack_rows, and back (unpack_rows).
//
// Replaces repro/comm/kernels.py pack_pallas (_pack_body) and
// unpack_pallas (_unpack_body), which packed (rows, lanes_in) tiles of
// the TPU's VMEM layout: rows a multiple of the encode tile, lanes_in a
// width chosen so the packed tile fills whole 128-lane vector registers.
// Here the rows are any (R, c): row r packs its own c codes into
// payload_nbytes(c, bits) bytes, the tail group padded with zero codes,
// so row boundaries stay byte-aligned (the worker-ownership rows of
// Algorithm 2, or one flat row). Lane widths 2, 3, 4, 6, 8 and 16 bits;
// odd widths pack in 24-bit groups (8 codes of 3 bits, 4 of 6 bits).
// The layout is grids.cuh's rt::pack_group / rt::unpack_group, which K7's
// and #8's packers already write: lanes below 8 bits hold code +
// 2^(bits-1), little-endian within the group; 8-bit lanes the
// two's-complement byte; 16-bit lanes the little-endian int16. Unpacking
// gives int8 codes, or int16 for 16-bit lanes.
//
// Both directions are bound by bytes: packing reads the codes (1 B each
// for int8, 2 B for int16) and writes bits/8 B per code; unpacking the
// reverse (2-bit lanes: 1.25 B a code; 16-bit lanes: 4 B). Design: one
// thread packs or unpacks one whole-byte group (lcm(bits, 8) bits), the
// codes of a group read or written as one word where the row length is a
// multiple of the group and the pointer is aligned to it, else code by
// code (columns past c are zero codes on the way in and dropped on the
// way out). One grid row of blocks per row, grid-stride over the row's
// groups. Integer work only: the kernels are bitwise their plain
// versions.
#include <string.h>

#include <type_traits>

#include "grids.cuh"

#define RT_BITS_CASES(CASE) \
  CASE(2) CASE(3) CASE(4) CASE(6) CASE(8) CASE(16)

namespace {

using rt::blocks_per_row;
using rt::kThreads;

template <int BYTES> struct Word { using T = void; };
template <> struct Word<2> { using T = unsigned short; };
template <> struct Word<4> { using T = unsigned int; };
template <> struct Word<8> { using T = uint2; };
template <> struct Word<16> { using T = uint4; };

// G codes of type CT at p (aligned to G * sizeof(CT) when VEC) -> ints.
template <int G, typename CT>
__device__ __forceinline__ void load_codes(const CT* p, int* v, bool vec) {
  constexpr int BYTES = G * (int)sizeof(CT);
  using W = typename Word<BYTES>::T;
  if constexpr (!std::is_void<W>::value) {
    if (vec) {
      const W w = *reinterpret_cast<const W*>(p);
      CT t[G];
      memcpy(t, &w, BYTES);
#pragma unroll
      for (int i = 0; i < G; ++i) v[i] = (int)t[i];
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < G; ++i) v[i] = (int)p[i];
}

template <int G, typename OT>
__device__ __forceinline__ void store_codes(OT* p, const int* v, bool vec) {
  constexpr int BYTES = G * (int)sizeof(OT);
  using W = typename Word<BYTES>::T;
  OT t[G];
#pragma unroll
  for (int i = 0; i < G; ++i) t[i] = (OT)v[i];
  if constexpr (!std::is_void<W>::value) {
    if (vec) {
      W w;
      memcpy(&w, t, BYTES);
      *reinterpret_cast<W*>(p) = w;
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < G; ++i) p[i] = t[i];
}

template <int BITS, typename CT>
__global__ void pack_rows_kernel(const CT* __restrict__ codes,
                                 uint8_t* __restrict__ payload, long long c,
                                 long long row_bytes, int vec) {
  constexpr int G = rt::group_codes(BITS), NB = rt::group_nbytes(BITS);
  const CT* crow = codes + (long long)blockIdx.y * c;
  uint8_t* prow = payload + (long long)blockIdx.y * row_bytes;
  const long long groups = (c + G - 1) / G;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < groups; j += stride) {
    const long long col = j * G;
    int v[G];
    if (col + G <= c) {
      load_codes<G>(crow + col, v, vec);
    } else {
#pragma unroll
      for (int t = 0; t < G; ++t) v[t] = col + t < c ? (int)crow[col + t] : 0;
    }
    rt::pack_group<BITS>(v, prow + j * NB);
  }
}

template <int BITS, typename OT>
__global__ void unpack_rows_kernel(const uint8_t* __restrict__ payload,
                                   OT* __restrict__ codes, long long c,
                                   long long row_bytes, int vec) {
  constexpr int G = rt::group_codes(BITS), NB = rt::group_nbytes(BITS);
  const uint8_t* prow = payload + (long long)blockIdx.y * row_bytes;
  OT* crow = codes + (long long)blockIdx.y * c;
  const long long groups = (c + G - 1) / G;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < groups; j += stride) {
    const long long col = j * G;
    int v[G];
    rt::unpack_group<BITS>(prow + j * NB, v);
    if (col + G <= c) {
      store_codes<G>(crow + col, v, vec);
    } else {
#pragma unroll
      for (int t = 0; t < G; ++t)
        if (col + t < c) crow[col + t] = (OT)v[t];
    }
  }
}

template <int BITS, typename CT>
int launch_pack(const void* codes, void* payload, int rows, long long c,
                long long row_bytes, void* stream) {
  constexpr int G = rt::group_codes(BITS);
  const long long groups = (c + G - 1) / G;
  const int vec = c % G == 0 && (uintptr_t)codes % (G * sizeof(CT)) == 0;
  dim3 grid(blocks_per_row(groups, rows), rows);
  pack_rows_kernel<BITS, CT><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const CT*)codes, (uint8_t*)payload, c, row_bytes, vec);
  return (int)cudaGetLastError();
}

template <int BITS>
int launch_unpack(const void* payload, void* codes, int rows, long long c,
                  long long row_bytes, void* stream) {
  using OT = typename std::conditional<BITS == 16, int16_t, int8_t>::type;
  constexpr int G = rt::group_codes(BITS);
  const long long groups = (c + G - 1) / G;
  const int vec = c % G == 0 && (uintptr_t)codes % (G * sizeof(OT)) == 0;
  dim3 grid(blocks_per_row(groups, rows), rows);
  unpack_rows_kernel<BITS, OT><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)payload, (OT*)codes, c, row_bytes, vec);
  return (int)cudaGetLastError();
}

bool valid(int rows, long long c, long long row_bytes, int bits) {
  if (rows < 1 || rows > 65535 || c < 1) return false;
  const int g = rt::group_codes(bits), nb = rt::group_nbytes(bits);
  return row_bytes == (c + g - 1) / g * nb;
}

}  // namespace

// codes: (rows, c) signed codes of code_bytes 1 or 2 each; payload:
// (rows, row_bytes) uint8, row_bytes = payload_nbytes(c, bits).
extern "C" int rt_pack_rows(const void* codes, void* payload, int rows,
                            long long c, long long row_bytes, int bits,
                            int code_bytes, void* stream) {
  if (!valid(rows, c, row_bytes, bits)) return (int)cudaErrorInvalidValue;
#define CASE(B)                                                              \
  if (bits == B) {                                                           \
    if (code_bytes == 1)                                                     \
      return launch_pack<B, int8_t>(codes, payload, rows, c, row_bytes,     \
                                    stream);                                 \
    if (code_bytes == 2)                                                     \
      return launch_pack<B, int16_t>(codes, payload, rows, c, row_bytes,    \
                                     stream);                                \
  }
  RT_BITS_CASES(CASE)
#undef CASE
  return (int)cudaErrorInvalidValue;
}

// payload: (rows, row_bytes) uint8; codes: (rows, c) int8 (int16 for
// 16-bit lanes).
extern "C" int rt_unpack_rows(const void* payload, void* codes, int rows,
                              long long c, long long row_bytes, int bits,
                              void* stream) {
  if (!valid(rows, c, row_bytes, bits)) return (int)cudaErrorInvalidValue;
#define CASE(B)                                                         \
  if (bits == B)                                                        \
    return launch_unpack<B>(payload, codes, rows, c, row_bytes, stream);
  RT_BITS_CASES(CASE)
#undef CASE
  return (int)cudaErrorInvalidValue;
}
