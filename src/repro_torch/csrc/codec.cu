// The wire kernels of the distributed step: K7 fused EF encode, #5 fused
// encode (its quantize + pack launch) and K6 fused decode.
//
// K7 replaces repro/comm/kernels.py ef_encode_pallas (_ef_encode_body,
// _ef_encode_lut_body): x (Delta+e on the update exchange, a master chunk
// on the weight broadcast) and one scale become the packed payload rows
// of comm/bits.py pack_rows(pad_rows(codes, n_rows)) and the residual
// e' = x - deq(codes). The log kind quantizes as K16 does (rt::log_code,
// the reference's decision points compared exactly) and its residual is
// x - level * s with the lane table's level (K16's ef1), for every k up
// to 126 (8-bit lanes); the uniform kind quantizes as K4 does
// (rt::uniform_code), clips the codes to the lane (+/-clip_abs: k_x = 7
// rides 8-bit lanes at +/-127) and its residual is x - (c / 2^k) * s.
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
// All are bound by bytes. K7 reads 4 B of x and writes 4 B of e' plus
// bits/8 of payload per element: 8.25 B on 2-bit lanes, 8.375 on 3-bit
// (log:2), 8.5 on 4-bit (log:6), 8.75 on 6-bit (log:30), 9 on 8-bit
// (uniform:7, log:126), 10 on 16-bit. #5's encode launch reads 4 B (8 B
// with the ternary kind's uniforms) and writes bits/8 (4.5 B for log:6),
// after K3's 4 B read for an amax scale. K6 reads bits/8 and writes 4 B
// (4.25 B for ternary on 2-bit lanes). At the w_gate stack's 360,710,144
// elements K7 on 6-bit lanes moves 3.16 GB: 0.942 ms at the H100 SXM's
// 3.35 TB/s. The TPU kernels worked on (rows, lanes_in) VMEM tiles padded
// to a multiple of the tiling; here every kernel reads and writes the
// unpadded flat tensors: codes past the row or past n are zero codes, so
// no padded copy of x exists.
//
// K7 and #5 first had one thread pack one whole-byte group (lcm(bits, 8)
// bits), as K6 had, and reached 39 % of the bound on 6-bit lanes and
// 62-65 % on the others: a warp's x loads were strided by the group (16 B
// apart on 6-bit lanes, 32 B on 3-bit ones), the payload went out byte by
// byte (three single-byte stores a 6-bit group), every element paid a
// 64-bit index and two bound checks, and log levels came from global
// memory. Now a warp encodes a chunk of one payload row at a time, the
// inverse of K6 below, chunks walked with a grid stride by a grid of 8
// blocks an SM:
// - a row's chunks start where a 16-byte payload vector and a code start
//   together (every 64 codes of 2- and 6-bit lanes, 128 of 3-bit ones, 32,
//   16 and 8 of 4-, 8- and 16-bit ones; chunk 0 is the row's up to 127
//   codes before the first such point), and hold 512 codes (128 to 1024
//   payload bytes): no 16-byte vector holds bits of two chunks, so a warp
//   needs no codes of another;
// - phase 1: lane l reads the float4s l, l + 32, ... of x (and of the
//   ternary kind's u) that cover the chunk, computes their codes and, for
//   K7, writes e' as float4s from the same lane (each element is read,
//   then written, by one lane, so e' may be x itself: x is not read
//   through ld.global.nc when e' is written); elements of the chunk's
//   first and last float4 that belong to a neighbour are read and dropped,
//   never written. Each float4's 4 codes become one field of 4 bits bits
//   in a warp-private bit stream in shared memory (3-bit lanes pair two
//   lanes' 12-bit fields into 3 bytes with a shuffle); __syncwarp, no
//   block barrier;
// - phase 2: each lane builds the chunk's 16-byte payload vectors, lane l
//   vector l (and l + 32 on 16-bit lanes), each four funnel shifts over
//   five staged words at any bit offset (the lanes' layout is one
//   little-endian bit stream, so 3- and 6-bit lanes take the same path),
//   and stores each with one 16-byte store;
// - a row's payload head and tail (the bytes before its first and after
//   its last 16-byte aligned vector: a payload row starts at r row_bytes,
//   which need not be aligned) go out byte by byte, and x's first and
//   last float4 of a chunk element by element: the bound checks and the
//   64-bit indices live there; e' (or u) aligned unlike x is written (or
//   read) element by element too;
// - once bytes moved in whole sectors, the codes' instructions held the
//   kernel (it took the same time on every lane width): the log kind
//   finds a code with one read of a per-binade
//   table (rt::log_code_binade: y's exponent field picks a base and a
//   threshold, built in shared memory once a block from the decision
//   points; no branch, no midpoint search) and its level in the lane
//   table, also in shared memory; the uniform kind's level is
//   (c * 2^-k) * s, exact like the division it replaces.
// Stores are streaming (st.global.cs): e' is read by the next step's K15,
// the payload by NCCL after the whole leaf is encoded, both long after
// the L2 has turned over. Plain stores, a cp.async prefetch of the next
// chunk's x into shared memory, 256-code chunks and a register cap for 6
// blocks an SM were no faster (uncommitted probes). Measured
// (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6) at the
// w_gate stack, K7: log:30 1.1707 ms (80.5 % of its byte bound; the
// one-group kernel 2.4291), log:2 1.1567 (78.0 %), log:6 1.1184 (81.8 %),
// uniform:7 1.1660 (83.1 %), log:126 1.2150 (79.8 %), uniform_amax:14:w16
// 1.2897 (83.5 %); #5 with K3's launch: log:6 1.1646 (was 1.3674),
// uniform:7 1.1037 (was 1.3217), ternary 1.5180 (was 1.5031).
//
// K6 was built the same way, one group a thread, and reached 38-48 % of
// its bound: a 2-bit group's 4 floats went out as 4 stores 16 bytes
// apart across the warp (a quarter of each touched sector a store), each
// element paid two 64-bit bound checks, a grid-stride step and, for the
// uniform kind, an IEEE division, and a thread read one byte a load. It
// was held by instructions and narrow accesses, not by bytes. Now a warp
// decodes a chunk of one row at a time (512 codes of 8-bit lanes, 2048
// of 2-bit ones, 256 of 16-bit; 1024 and 512 codes, 384 bytes, of 3- and
// 6-bit lanes), chunks walked with a grid stride by a grid of 8 blocks an
// SM:
// - each lane loads one 16-byte vector of the chunk's payload with
//   ld.global.nc (lane 0 one more: the chunk's bits start anywhere in a
//   vector), the next chunk's vectors in flight while this one is made,
//   and stores them to a warp-private staging buffer (no block barrier);
// - a row's output is split into a head up to its first 16-byte aligned
//   float, a body of float4s and a tail: the head and the tail (at most 3
//   elements each, read byte by byte) carry the bound checks and the
//   64-bit indices; in the body lane l writes float4s l, l + 32, ... of
//   the chunk, so one warp store covers 512 contiguous bytes;
// - a float4's 4 codes are one funnel shift over two staged words (three
//   for 16-bit lanes) at any bit offset: the lanes' layout is one
//   little-endian bit stream, so 3- and 6-bit lanes need no group
//   alignment and take the same path (no 48-byte units, no fallback);
// - the uniform kind multiplies by 2^-k, exact like the division it
//   replaces (c / 2^k is zero or a normal float for k <= 30).
// Stores are streaming (st.global.cs): the output is read by another
// kernel long after the L2 has turned over. Measured (chip_smoke.py, NVIDIA
// H100 80GB HBM3, 700 W; PERF.md section 6) at the w_gate stack: uniform:7
// 0.6606 ms (81.5 % of its byte bound; the one-group kernel 1.1151),
// ternary 0.5723 (80.0 %; was 1.2139), log:6 0.6093 (79.5 %; was
// 0.6394), about 2.7 TB/s where fill_ writes the same bytes at 3.25.
// Shorter chunks, a grid of the resident blocks only and plain stores
// were no faster (uncommitted probes).
// Every operation is one IEEE rounding (no fma, no fast math): the kernels
// are bitwise their plain versions.
#include <algorithm>

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
// e' over x (each element is read, then written, by one lane).
struct Encode {
  const float* x;
  const float* u;        // ternary: uniforms over the flat x
  const float* scale;    // one float on the device
  float* scale_out;      // the scale used, or nullptr
  uint8_t* payload;
  float* e_out;          // K7's residual (EF only)
  const float* grid;     // log: the decision points (grids.log_grid_table)
  const float* table;    // log: the lane's levels (log_dequant_table)
  long long n, c, row_bytes;
  int n_rows, k, clip_abs, guard, half;
};

// ---------------------------------------------------------------------------
// K7 and #5: a warp encodes a chunk of one payload row at a time
// ---------------------------------------------------------------------------

constexpr int kWarps = kThreads / 32;
constexpr int kEncCodes = 512;                 // codes a chunk, at most
constexpr int kEncF4 = kEncCodes / 4 + 1;      // float4s they span, at most
constexpr int kEncSlots = (kEncF4 + 31) / 32;  // float4s a lane, at most

// A chunk's staged bit stream: kEncF4 fields of 4 BITS bits, then the
// words the funnel shifts read past its end.
template <int BITS>
struct EncStream {
  static constexpr int WORDS = ((kEncF4 * 4 * BITS + 31) / 32 + 2 + 3) & ~3;
};

// The first code of a row at which a 16-byte payload vector starts, the
// row's payload starting ap bytes past a 16-byte boundary: the j in
// [0, 128) with j * BITS = -8 ap mod 128 (3 * 43 = 1 mod 128; 16-bit rows
// start at even bytes).
template <int BITS>
__device__ __forceinline__ int first_aligned_code(int ap) {
  if constexpr (BITS == 3) return (((128 - 8 * ap) & 127) * 43) & 127;
  else if constexpr (BITS == 6) return (((64 - 4 * ap) & 63) * 43) & 63;
  else return ((128 - 8 * ap) & 127) / BITS;
}

// 4 signed codes as one field of 4 BITS bits of the lanes' bit stream
// (comm/bits.py): code + 2^(BITS-1) below 8 bits, the two's-complement
// byte or int16 at 8 and 16.
template <int BITS>
__device__ __forceinline__ unsigned long long field4(const int (&c)[4]) {
  if constexpr (BITS == 16) {
    const uint32_t lo = ((uint32_t)c[0] & 0xffffu) | ((uint32_t)c[1] << 16);
    const uint32_t hi = ((uint32_t)c[2] & 0xffffu) | ((uint32_t)c[3] << 16);
    return ((unsigned long long)hi << 32) | lo;
  } else {
    constexpr uint32_t mask = (1u << BITS) - 1u;
    constexpr int bias = BITS == 8 ? 0 : 1 << (BITS - 1);
    uint32_t v = 0u;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v |= ((uint32_t)(c[e] + bias) & mask) << (e * BITS);
    return v;
  }
}

// field i of the stream (bits [4 BITS i, 4 BITS (i + 1))); every lane
// calls it (the 3-bit lanes' shuffle), `live` lanes write
template <int BITS>
__device__ __forceinline__ void stage_field(uint32_t* buf, int i,
                                            unsigned long long f, bool live) {
  uint8_t* b = reinterpret_cast<uint8_t*>(buf);
  if constexpr (BITS == 3) {
    // 12-bit fields: the even one of a pair writes both as 3 bytes
    const uint32_t odd = __shfl_xor_sync(0xffffffffu, (uint32_t)f, 1);
    if (live && !(i & 1)) {
      const uint32_t v = (uint32_t)f | (odd << 12);
      uint8_t* p = b + 3 * (i >> 1);
      p[0] = (uint8_t)v;
      p[1] = (uint8_t)(v >> 8);
      p[2] = (uint8_t)(v >> 16);
    }
  } else if (live) {
    if constexpr (BITS == 2) {
      b[i] = (uint8_t)f;
    } else if constexpr (BITS == 4) {
      reinterpret_cast<uint16_t*>(b)[i] = (uint16_t)f;
    } else if constexpr (BITS == 8) {
      buf[i] = (uint32_t)f;
    } else if constexpr (BITS == 16) {
      reinterpret_cast<unsigned long long*>(b)[i] = f;
    } else {   // 6 bits: 24-bit fields, 3 bytes each
      uint8_t* p = b + 3 * i;
      p[0] = (uint8_t)f;
      p[1] = (uint8_t)(f >> 8);
      p[2] = (uint8_t)(f >> 16);
    }
  }
}

// the 4 zero codes' field (codes past the row or past n)
template <int BITS>
__device__ __forceinline__ unsigned long long zero_field() {
  const int z[4] = {0, 0, 0, 0};
  return field4<BITS>(z);
}

// One element's code and, for the residual, its level.
struct Quant {
  const uint2* bin;    // log: the per-binade table (rt::log_binade)
  const float* tbl;    // log: the lane's levels
  float s, s_div, pow2, inv2k, top;
  int half, clip, nan_mag;
};

template <int KIND>
__device__ __forceinline__ int quantize1(const Quant& p, float x, float u,
                                         float& level) {
  if constexpr (KIND == kLog) {
    const int code = rt::log_code_binade(x, p.s_div, p.nan_mag, p.bin);
    level = rt::lut_level(p.tbl, p.half, code, p.s);
    return code;
  } else if constexpr (KIND == kUniform) {
    float cf = rt::uniform_code(x, p.s_div, p.pow2);
    if (p.clip) cf = fminf(fmaxf(cf, -p.top), p.top);
    // (c / 2^k) * s: c * 2^-k is exact, so it is the quotient bit for bit
    level = __fmul_rn(__fmul_rn(cf, p.inv2k), p.s);
    return (int)cf;
  } else {
    const float q = __fdiv_rn(fabsf(x), p.s_div);
    level = 0.0f;
    return u < q ? (x > 0.0f) - (x < 0.0f) : 0;
  }
}

template <int BITS, int KIND, bool EF>
__global__ void __launch_bounds__(kThreads) encode_kernel(const Encode a) {
  using S = EncStream<BITS>;
  __shared__ float tbl[kMaxTable];
  __shared__ uint2 bin[256];
  __shared__ __align__(16) uint32_t stage[kWarps][S::WORDS];
  float s = a.scale[0];
  if (a.guard) s = s > 0.0f ? s : 1.0f;  // where(amax > 0, amax, 1)
  if (a.scale_out != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    a.scale_out[0] = s;
  Quant p;
  p.s = s;
  p.tbl = tbl;
  p.half = a.half;
  p.clip = a.clip_abs > 0;
  p.top = (float)a.clip_abs;
  if constexpr (KIND == kLog) {
    for (int i = threadIdx.x; i < 2 * a.half; i += blockDim.x)
      tbl[i] = a.table[i];
    for (int e = threadIdx.x; e < 256; e += blockDim.x)
      bin[e] = rt::log_binade(e, a.k, a.grid);
    __syncthreads();
    p.bin = bin;
    p.nan_mag = a.k > 0 ? a.k : 1;
  }
  if constexpr (KIND == kUniform) {
    p.s_div = fmaxf(s, 1e-30f);  // as K4
    p.pow2 = (float)(1 << a.k);
    p.inv2k = rt::pow2i(-a.k);
  } else {
    p.s_div = s < 1e-30f ? 1e-30f : s;  // NaN passes through, as max()
  }
  const int lane = threadIdx.x & 31;
  uint32_t* buf = stage[threadIdx.x >> 5];
  const long long c_pad = a.row_bytes * 8 / BITS;   // codes a row, padded
  const long long cpr = 1 + (c_pad + kEncCodes - 1) / kEncCodes;
  const long long nq = (long long)a.n_rows * cpr;
  const long long qstride = (long long)gridDim.x * kWarps;
  // e' (u) as float4s in step with x's only when aligned alike
  const bool e_vec = EF && ((((uintptr_t)a.e_out ^ (uintptr_t)a.x) & 15) == 0);
  const bool u_vec = KIND == kTernary &&
                     ((((uintptr_t)a.u ^ (uintptr_t)a.x) & 15) == 0);

  for (long long q = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
       q < nq; q += qstride) {
    // chunk t of row r: codes [lo, hi) of the row
    const long long r = a.n_rows == 1 ? 0 : q / cpr;
    const long long t = q - r * cpr;
    const uintptr_t p0 = (uintptr_t)a.payload + r * a.row_bytes;
    const long long js = first_aligned_code<BITS>((int)(p0 & 15));
    const long long lo = t == 0 ? 0 : min(c_pad, js + kEncCodes * (t - 1));
    const long long hi = min(c_pad, t == 0 ? js : js + kEncCodes * t);
    if (lo >= hi) continue;
    const long long xb = r * a.c + lo;   // x's flat index of code lo
    const int dh = (int)(hi - lo);
    // chunk codes [0, dx) have an x; the rest up to dh are zero codes
    const int dx = (int)max(0LL, min(min(a.c, a.n - r * a.c) - lo,
                                     (long long)dh));
    const int off = (int)(((uintptr_t)(a.x + xb) >> 2) & 3);
    const int nf4 = ((off + dh - 1) >> 2) + 1;   // float4s of x, from
    const float4* xv = reinterpret_cast<const float4*>(  // the one of code lo
        (uintptr_t)(a.x + xb) & ~(uintptr_t)15);

    // phase 1: float4 i of the chunk holds chunk codes 4i - off .. + 3
    float4 xr[kEncSlots], ur[kEncSlots];
#pragma unroll
    for (int k = 0; k < kEncSlots; ++k) {
      const int i = lane + 32 * k;
      const int d0 = 4 * i - off;
      xr[k] = ur[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (i < nf4 && d0 < dx) {   // an element of it has an x
        if constexpr (EF) xr[k] = xv[i];   // x may be e': no ld.global.nc
        else xr[k] = __ldg(xv + i);
        if constexpr (KIND == kTernary) {
          if (u_vec) {
            ur[k] = __ldg(reinterpret_cast<const float4*>(
                (uintptr_t)(a.u + xb) & ~(uintptr_t)15) + i);
          } else {
            float* ue = reinterpret_cast<float*>(&ur[k]);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (d0 + e >= 0 && d0 + e < dx) ue[e] = __ldg(a.u + xb + d0 + e);
          }
        }
      }
    }
    __syncwarp();   // the last chunk's stream is read
#pragma unroll
    for (int k = 0; k < kEncSlots; ++k) {
      const int i = lane + 32 * k;
      const int d0 = 4 * i - off;
      const bool live = i < nf4;
      unsigned long long f = zero_field<BITS>();
      if (live && d0 < dx) {
        const float* xe = reinterpret_cast<const float*>(&xr[k]);
        const float* ue = reinterpret_cast<const float*>(&ur[k]);
        int cd[4];
        float res[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float level = 0.0f;
          cd[e] = 0;
          if (d0 + e >= 0 && d0 + e < dx)
            cd[e] = quantize1<KIND>(p, xe[e], ue[e], level);
          res[e] = __fsub_rn(xe[e], level);
        }
        f = field4<BITS>(cd);
        if constexpr (EF) {
          if (e_vec && d0 >= 0 && d0 + 3 < dx) {
            float4* ev = reinterpret_cast<float4*>(
                (uintptr_t)(a.e_out + xb) & ~(uintptr_t)15);
            __stcs(ev + i, make_float4(res[0], res[1], res[2], res[3]));
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (d0 + e >= 0 && d0 + e < dx) a.e_out[xb + d0 + e] = res[e];
          }
        }
      }
      stage_field<BITS>(buf, i, f, live);
    }
    __syncwarp();

    // phase 2: the chunk's payload bytes [bl, bh); row bit b sits at
    // stream bit b - 8 (bl - p0) + off BITS
    const uintptr_t bl = p0 + (uintptr_t)(lo * BITS / 8);
    const uintptr_t bh = p0 + (uintptr_t)(hi * BITS / 8);
    const uintptr_t vlo = (bl + 15) & ~(uintptr_t)15, vhi = bh & ~(uintptr_t)15;
    const int nvec = vhi > vlo ? (int)((vhi - vlo) >> 4) : 0;
    const int lb0 = 8 * (int)(vlo - bl) + off * BITS;
#pragma unroll
    for (int m = 0; m < (BITS == 16 ? 2 : 1); ++m) {
      const int v = lane + 32 * m;
      if (v < nvec) {
        const int lb = lb0 + 128 * v;
        const int w = lb >> 5, sh = lb & 31;
        uint4 o;
        o.x = __funnelshift_r(buf[w], buf[w + 1], sh);
        o.y = __funnelshift_r(buf[w + 1], buf[w + 2], sh);
        o.z = __funnelshift_r(buf[w + 2], buf[w + 3], sh);
        o.w = __funnelshift_r(buf[w + 3], buf[w + 4], sh);
        __stcs(reinterpret_cast<uint4*>(vlo) + v, o);
      }
    }
    // the row's payload head (chunk 0) and tail (its last chunk): the
    // bytes before vlo and from vhi, up to 15 each, one lane a byte
    const uintptr_t hend = bh < vlo ? bh : vlo;
    const uintptr_t tbeg = hend > vhi ? hend : vhi;
    const uintptr_t at = lane < 16 ? bl + lane : tbeg + (lane - 16);
    if (lane < 16 ? at < hend : at < bh) {
      const int lb = 8 * (int)(at - bl) + off * BITS;
      *reinterpret_cast<uint8_t*>(at) =
          (uint8_t)__funnelshift_r(buf[lb >> 5], buf[(lb >> 5) + 1], lb & 31);
    }
  }
}

// ---------------------------------------------------------------------------
// K6: a warp decodes a chunk of one payload row at a time
// ---------------------------------------------------------------------------

// A warp's chunk of a row's body: each lane writes V float4s (4V codes),
// lane-interleaved so that one warp store covers 512 contiguous bytes.
// BYTES of payload hold the chunk's OUT codes; VECS 16-byte vectors cover
// them from any bit offset (one more than BYTES / 16).
template <int BITS>
struct DecChunk {
  static constexpr int V = BITS == 3 ? 8 : BITS == 6 ? 4 : 32 / BITS;
  static constexpr int F4 = 32 * V;              // float4s a chunk
  static constexpr int OUT = 4 * F4;             // codes a chunk
  static constexpr int BYTES = OUT * BITS / 8;   // 512, or 384 (3, 6 bits)
  static constexpr int VECS = BYTES / 16 + 1;
  static constexpr int WORDS = VECS * 4 + 4;     // staged words, with a pad
  static_assert(BYTES % 16 == 0, "whole vectors of payload a chunk");
};

// the 4 codes of bits [0, 4 BITS) of lo:hi (hi only for 16-bit lanes),
// the lane layout of comm/bits.py as one little-endian bit stream
template <int BITS>
__device__ __forceinline__ void codes4(uint32_t lo, uint32_t hi, int (&c)[4]) {
  if constexpr (BITS == 16) {
    c[0] = (int)(int16_t)(lo & 0xffffu);
    c[1] = (int)(int16_t)(lo >> 16);
    c[2] = (int)(int16_t)(hi & 0xffffu);
    c[3] = (int)(int16_t)(hi >> 16);
  } else if constexpr (BITS == 8) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] = (int)(int8_t)(lo >> (8 * e));
  } else {
    constexpr uint32_t mask = (1u << BITS) - 1u;
    constexpr int bias = 1 << (BITS - 1);
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] = (int)((lo >> (e * BITS)) & mask) - bias;
  }
}

// code j of a payload row, read byte by byte (the rows' heads and tails)
template <int BITS>
__device__ __forceinline__ int code_at(const uint8_t* __restrict__ prow,
                                       long long j, long long row_bytes) {
  const long long bit = j * BITS, b = bit >> 3;
  uint32_t v = __ldg(prow + b);
  if (b + 1 < row_bytes) v |= (uint32_t)__ldg(prow + b + 1) << 8;
  int c[4];
  codes4<BITS>(v >> (bit & 7), 0u, c);
  return c[0];
}

struct DecodeArgs {
  const uint8_t* payload;
  const float* scales;
  const float* table;
  float* out;
  long long out_n, c, row_bytes;
  long long rows;    // rows that reach out_n
  long long cpr;     // chunks a row
  int half, k;
};

template <int KIND>
__device__ __forceinline__ float level(int code, float s, float inv2k,
                                       const float* tbl, int half) {
  if constexpr (KIND == kLog) return rt::lut_level(tbl, half, code, s);
  // (c / 2^k) * s: c * 2^-k is exact (a zero or a normal float for
  // k <= 30), so it is the quotient bit for bit, rounded once by s
  else if constexpr (KIND == kUniform)
    return __fmul_rn(__fmul_rn((float)code, inv2k), s);
  else return __fmul_rn((float)code, s);
}

template <int BITS, int KIND>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const DecodeArgs a) {
  using D = DecChunk<BITS>;
  __shared__ float tbl[kMaxTable];
  __shared__ __align__(16) uint32_t stage[kWarps][D::WORDS];
  if constexpr (KIND == kLog) {
    for (int i = threadIdx.x; i < 2 * a.half; i += blockDim.x)
      tbl[i] = a.table[i];
    __syncthreads();
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* buf = stage[warp];
  const float inv2k = rt::pow2i(-a.k);
  const uintptr_t pbase = (uintptr_t)a.payload;
  // the last 16-byte vector holding a payload byte: loads stop there
  const uintptr_t vlast = (pbase + a.rows * a.row_bytes - 1) >> 4;
  const long long nq = a.rows * a.cpr;
  const long long qstride = (long long)gridDim.x * kWarps;

  // chunk q: row r, chunk t of it. A row's output starts at out + r c,
  // 16-byte aligned after h head elements; its body is nb float4s; chunk
  // t owns body float4s [f0, f1); its codes start at bit `bit` of the
  // payload's address space.
  struct Chunk {
    long long r, len, h, nb, f0, f1;
    uintptr_t bit;
  };
  auto plan = [&](long long q) {
    Chunk ch;
    ch.r = a.rows == 1 ? 0 : q / a.cpr;   // one row: no 64-bit division
    const long long t = q - ch.r * a.cpr;
    ch.len = min(a.c, a.out_n - ch.r * a.c);
    const uintptr_t o = (uintptr_t)(a.out + ch.r * a.c);
    ch.h = min((long long)(((16 - (o & 15)) & 15) >> 2), ch.len);
    ch.nb = (ch.len - ch.h) >> 2;
    ch.f0 = t * D::F4;
    ch.f1 = min(ch.nb, ch.f0 + D::F4);
    ch.bit = 8 * (pbase + ch.r * a.row_bytes) + (ch.h + 4 * ch.f0) * BITS;
    return ch;
  };
  // this lane's vectors of the chunk's payload: 16-byte ld.global.nc
  // loads from the vector holding its first bit on
  auto load = [&](const Chunk& ch, uint4 (&v)[2]) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = lane + 32 * u;
      const uintptr_t at = (ch.bit >> 7) + i;
      v[u] = (i < D::VECS && ch.f0 < ch.f1 && at <= vlast)
          ? __ldg(reinterpret_cast<const uint4*>(at << 4))
          : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  long long q = (long long)blockIdx.x * kWarps + warp;
  Chunk cur = plan(q < nq ? q : 0);
  uint4 raw[2];
  load(cur, raw);
  for (; q < nq; q += qstride) {
    const long long qn = q + qstride;
    const Chunk nxt = plan(qn < nq ? qn : q);
    __syncwarp();   // the last chunk's words are read
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = lane + 32 * u;
      if (i < D::VECS) reinterpret_cast<uint4*>(buf)[i] = raw[u];
    }
    __syncwarp();
    if (qn < nq) load(nxt, raw);   // in flight while this chunk is made

    const float s = __ldg(a.scales + cur.r);
    float* orow = a.out + cur.r * a.c;
    // the body: float4 f0 + lane + 32 i of the row's aligned part
    const int sh = (int)(cur.bit & 127);
    const int nf = (int)(cur.f1 - cur.f0);
    float4* obody = reinterpret_cast<float4*>(orow + cur.h) + cur.f0;
#pragma unroll
    for (int i = 0; i < D::V; ++i) {
      const int fl = lane + 32 * i;
      if (fl < nf) {
        const int bo = sh + fl * 4 * BITS;
        const int wi = bo >> 5, bs = bo & 31;
        const uint32_t lo = __funnelshift_r(buf[wi], buf[wi + 1], bs);
        const uint32_t hi = BITS == 16
            ? __funnelshift_r(buf[wi + 1], buf[wi + 2], bs) : 0u;
        int c[4];
        codes4<BITS>(lo, hi, c);
        // streaming stores: the output is read by another kernel, long
        // after the L2 has turned over
        __stcs(obody + fl,
               make_float4(level<KIND>(c[0], s, inv2k, tbl, a.half),
                           level<KIND>(c[1], s, inv2k, tbl, a.half),
                           level<KIND>(c[2], s, inv2k, tbl, a.half),
                           level<KIND>(c[3], s, inv2k, tbl, a.half)));
      }
    }
    // the head (up to 3 elements before the first aligned float4) and the
    // tail (up to 3 after the body), once a row: bound checks and 64-bit
    // indices live here only
    if (cur.f0 == 0 && lane < 6) {
      const long long j =
          lane < 3 ? lane : cur.h + 4 * cur.nb + (lane - 3);
      if (lane < 3 ? j < cur.h : j < cur.len) {
        const uint8_t* prow = a.payload + cur.r * a.row_bytes;
        orow[j] = level<KIND>(code_at<BITS>(prow, j, a.row_bytes), s, inv2k,
                              tbl, a.half);
      }
    }
    cur = nxt;
  }
}

int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 0;
  }
  return sms;
}

// K7, #5 and K6 alike: a grid of whole SMs (8 blocks of 256 threads
// each), fewer where the chunks are fewer; warps walk the chunks with a
// grid stride
unsigned int chunk_blocks(long long chunks) {
  return (unsigned int)std::min<long long>((chunks + kWarps - 1) / kWarps,
                                           (long long)sm_count() * 8);
}

template <int BITS, int KIND, bool EF>
int launch_encode(const Encode& a, cudaStream_t stream) {
  if (sm_count() < 1) return (int)cudaErrorInvalidDevice;
  const long long c_pad = a.row_bytes * 8 / BITS;
  const long long chunks =
      a.n_rows * (1 + (c_pad + kEncCodes - 1) / kEncCodes);
  encode_kernel<BITS, KIND, EF>
      <<<chunk_blocks(chunks), kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int BITS>
int launch_encode_kind(const Encode& a, int kind, bool ef, cudaStream_t st) {
  if (ef)
    return kind == kLog ? launch_encode<BITS, kLog, true>(a, st)
                        : launch_encode<BITS, kUniform, true>(a, st);
  if (kind == kLog) return launch_encode<BITS, kLog, false>(a, st);
  if (kind == kUniform) return launch_encode<BITS, kUniform, false>(a, st);
  return launch_encode<BITS, kTernary, false>(a, st);
}

template <int BITS, int KIND>
int launch_decode(const DecodeArgs& a, cudaStream_t stream) {
  if (sm_count() < 1) return (int)cudaErrorInvalidDevice;
  decode_kernel<BITS, KIND>
      <<<chunk_blocks(a.rows * a.cpr), kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int BITS>
int launch_decode_kind(DecodeArgs a, int kind, cudaStream_t st) {
  constexpr long long F4 = DecChunk<BITS>::F4;
  a.cpr = std::max<long long>(1, (a.c / 4 + F4 - 1) / F4);
  if (kind == kLog) return launch_decode<BITS, kLog>(a, st);
  if (kind == kUniform) return launch_decode<BITS, kUniform>(a, st);
  return launch_decode<BITS, kTernary>(a, st);
}

bool valid_geometry(int kind, int bits, int n_rows, long long c,
                    long long row_bytes, int k) {
  if (kind != kLog && kind != kUniform && kind != kTernary) return false;
  if (n_rows < 1 || n_rows > 65535 || c < 1 || k < 0) return false;
  if (k > (kind == kLog ? rt::kMaxLogK : 30)) return false;
  const int g = rt::group_codes(bits), nb = rt::group_nbytes(bits);
  return row_bytes == (c + g - 1) / g * nb;
}

int encode_rows(const Encode& a, int kind, int bits, bool ef,
                cudaStream_t st) {
  if (!valid_geometry(kind, bits, a.n_rows, a.c, a.row_bytes, a.k))
    return (int)cudaErrorInvalidValue;
  // the chunks' 16-byte payload vectors are found from the rows' offsets
  if ((uintptr_t)a.payload & 15) return (int)cudaErrorInvalidValue;
  if (kind == kLog && (a.grid == nullptr || a.table == nullptr ||
                       a.half < 1 || 2 * a.half > kMaxTable))
    return (int)cudaErrorInvalidValue;
  if (ef && kind == kTernary) return (int)cudaErrorInvalidValue;
#define CASE(B) \
  if (bits == B) return launch_encode_kind<B>(a, kind, ef, st);
  RT_BITS_CASES(CASE)
#undef CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int rt_ef_encode_rows(const void* x, const void* scale,
                                 void* payload, void* e_out, long long n,
                                 int n_rows, long long c, long long row_bytes,
                                 int kind, int bits, int k, int clip_abs,
                                 const void* grid, const void* table, int half,
                                 void* stream) {
  const Encode a{(const float*)x, nullptr, (const float*)scale, nullptr,
                 (uint8_t*)payload, (float*)e_out, (const float*)grid,
                 (const float*)table, n, c, row_bytes, n_rows, k, clip_abs,
                 0, half};
  return encode_rows(a, kind, bits, true, (cudaStream_t)stream);
}

extern "C" int rt_encode_rows(const void* x, const void* u, const void* scale,
                              int guard, void* scale_out, void* payload,
                              long long n, int n_rows, long long c,
                              long long row_bytes, int kind, int bits, int k,
                              int clip_abs, const void* grid,
                              const void* table, int half, void* stream) {
  if (kind == kTernary && u == nullptr) return (int)cudaErrorInvalidValue;
  const Encode a{(const float*)x, (const float*)u, (const float*)scale,
                 (float*)scale_out, (uint8_t*)payload, nullptr,
                 (const float*)grid, (const float*)table, n, c, row_bytes,
                 n_rows, k, clip_abs, guard, half};
  return encode_rows(a, kind, bits, false, (cudaStream_t)stream);
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
  if (out_n < 1) return (int)cudaSuccess;   // nothing to write
  DecodeArgs a;
  a.payload = (const uint8_t*)payload;
  a.scales = (const float*)scales;
  a.table = (const float*)table;
  a.out = (float*)out;
  a.out_n = out_n;
  a.c = c;
  a.row_bytes = row_bytes;
  a.rows = std::min<long long>(n_rows, (out_n + c - 1) / c);
  a.cpr = 1;
  a.half = half;
  a.k = k;
  cudaStream_t st = (cudaStream_t)stream;
#define CASE(B) \
  if (bits == B) return launch_decode_kind<B>(a, kind, st);
  RT_BITS_CASES(CASE)
#undef CASE
  return (int)cudaErrorInvalidValue;
}
