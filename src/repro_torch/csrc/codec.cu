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
// All are bound by bytes: K7 reads 4 B and writes 4 B (e') plus bits/8
// per element (8.5 B for log:6 on 4-bit lanes, 9 B for uniform:7 on 8-bit
// lanes); #5 reads 4 B (8 B with the uniforms) and writes bits/8, plus
// K3's 4 B read for an amax scale (12.25 B for ternary on 2-bit lanes);
// K6 reads bits/8 and writes 4 B (4.25 B for ternary on 2-bit lanes: the
// w_gate stack's 360,710,144 elements are 1.53 GB, 0.458 ms at the H100
// SXM's 3.35 TB/s). The TPU kernels worked on (rows, lanes_in) VMEM
// tiles padded to a multiple of the tiling. Here K7 and #5 have one
// thread pack one whole-byte group (lcm(bits, 8) bits: 2, 4, 8 codes or
// 1 for 8- and 16-bit lanes), reading the unpadded flat x: elements past
// the row or past n are zero codes, so no padded copy of x exists. One
// grid row of blocks per payload row, grid-stride over the row's groups.
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
// e' over x (each element is read, then written, by one thread).
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
  int k, clip_abs, guard, half;
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
    lg = rt::make_log_grid(s, a.k, a.grid);
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
          level = rt::lut_level(a.table, a.half, code, s);
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

// ---------------------------------------------------------------------------
// K6: a warp decodes a chunk of one payload row at a time
// ---------------------------------------------------------------------------

constexpr int kDecWarps = kThreads / 32;

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
  __shared__ __align__(16) uint32_t stage[kDecWarps][D::WORDS];
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
  const long long qstride = (long long)gridDim.x * kDecWarps;

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

  long long q = (long long)blockIdx.x * kDecWarps + warp;
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

// a grid of whole SMs (8 blocks of 256 threads each), fewer where the
// chunks are fewer; warps walk the chunks with a grid stride
template <int BITS, int KIND>
int launch_decode(const DecodeArgs& a, cudaStream_t stream) {
  const int sms = sm_count();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  const long long warps = a.rows * a.cpr;
  const long long blocks = std::min<long long>(
      (warps + kDecWarps - 1) / kDecWarps, (long long)sms * 8);
  decode_kernel<BITS, KIND><<<(unsigned)blocks, kThreads, 0, stream>>>(a);
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

int encode_rows(const Encode& a, int n_rows, int kind, int bits, bool ef,
                cudaStream_t st) {
  if (!valid_geometry(kind, bits, n_rows, a.c, a.row_bytes, a.k))
    return (int)cudaErrorInvalidValue;
  if (kind == kLog && (a.grid == nullptr || a.table == nullptr ||
                       a.half < 1 || 2 * a.half > kMaxTable))
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
                                 const void* grid, const void* table, int half,
                                 void* stream) {
  const Encode a{(const float*)x, nullptr, (const float*)scale, nullptr,
                 (uint8_t*)payload, (float*)e_out, (const float*)grid,
                 (const float*)table, n, c, row_bytes, k, clip_abs, 0, half};
  return encode_rows(a, n_rows, kind, bits, true, (cudaStream_t)stream);
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
                 (const float*)grid, (const float*)table, n, c, row_bytes, k,
                 clip_abs, guard, half};
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
