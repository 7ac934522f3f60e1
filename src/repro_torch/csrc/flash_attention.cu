// #17 flash attention, forward: out = softmax(mask(softcap(q k^T / sqrt(hd))))
// v per query head, GQA (query head h reads KV head h / (H / K)), causal,
// sliding window, logit softcap, a query position offset.
//
// Replaces repro/kernels/flash_attention.py flash_attention
// (_flash_fwd_kernel, the pallas_call at :99). On the TPU a grid step held
// a (128, hd) query block and the whole (Skv, hd) K/V of its head in VMEM
// and looped over 128-key tiles up to the causal diagonal, streaming the
// tiles below the window too. Here, in both routes, only the 32-key tiles
// that some query of a block can see are visited (past the causal diagonal
// and below the window are skipped). Skipping is exact: the TPU kernel's
// fully masked leading tile adds p = exp(0) = 1 rows that the first
// visible tile's alpha = exp(-1e30 - m) = 0 wipes to zero, and here a
// masked score's p is set to 0 outright (so a query that sees no key at
// all gets zeros; the TPU kernel gives the mean of the tiles it streamed,
// which depends on its tiling). The running maximum starts at the finite
// sentinel -1e30, as the TPU kernel's: with -inf, a tile no query sees
// would give inf - inf = NaN. Ragged Sq and Skv are masked. Row maxima
// and sums fold in fixed orders: the result is deterministic. The output
// is acc / max(l, 1e-30), rounded once to q's dtype.
//
// Bound: the FLOPs of the visible (query, key) pairs, 4 hd a pair, over
// the H100 SXM's 989 TFLOP/s bf16 peak (data sheet, 700 W): at gemma2's
// prefill (S 8192, H 8, hd 256) ~275 GFLOP for a global causal layer
// (0.28 ms) and ~206 GFLOP for a local layer of window 4096 (0.21 ms).
//
// bf16 route, rt_flash_attention_tc (namespace tc): wgmma on the tensor
// cores. A block is two warpgroups (8 warps, 16 query rows a warp) over
// one stream of K/V tiles: the two query heads of one KV head where the
// GQA ratio is even (gemma2's), else 128 rows of one head, so each tile
// crosses from L2 once for 128 query rows. The tiles are copied with
// 16-byte cp.async into double-buffered shared memory in the swizzled
// layout that wgmma reads (128-byte rows; 64-byte at hd 32). S = Q K^T is
// an SS wgmma (m64n32k16, Q and K from shared memory); O += P V an RS
// wgmma (m64nHDk16, P from registers, V transposed from shared memory).
// S of tile i+1 runs on the tensor cores while the softmax of tile i runs
// on the CUDA cores; the wgmmas are issued unconditionally (ptxas
// serializes wgmmas issued under a branch when an accumulator is rescaled
// between them, C7515). The scale 1/sqrt(hd) multiplies the fp32 scores (at
// hd 64 and 256 a power of two: exactly q * scale; at 32 and 128 one fp32
// rounding of the score away); the softcap is cap tanhf(qk scale / cap),
// scale / cap one multiplier, with the accurate tanhf (tanh.approx's
// 2^-11 would break the bf16 tier); the
// softmax runs in the log2 domain (ex2.approx, 2 ulp). P goes to the MMA
// as P_hi + P_lo, both bf16: a single bf16 P errs by 2^-9 relative, which
// breaks the tier (one bf16 ulp + 1e-5) at outputs near zero; the pair
// errs by ~2^-16 for two MMAs of P V. l sums the unrounded p.
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W; PERF.md section
// 6): the global layer 1.455 ms (5.2x its bound) against 2.217 for
// scaled_dot_product_attention with a boolean mask and no softcap;
// without the softcap 1.305 ms against is_causal SDPA's 0.523. Letting
// P V of tile i run on into the softmax of tile i+1 needs two register
// sets of P, and ptxas then serializes the wgmmas (C7513): the lead for
// the next step.
//
// float32 route, rt_flash_attention (CUDA cores, the first #17 kernel):
// bf16 tensor cores cannot hold rtol 1e-4 on fp32 inputs. A block of 256
// threads owns a (64, hd) query tile of one (batch, head), held scaled in
// shared memory as fp32, and walks 32-key tiles of K and V staged in
// shared memory; each thread holds a 2 x 4 block of the 64 x 32 score
// tile and a 2 x (hd / 8) block of the output accumulator; row maxima and
// sums fold over 8 lanes by a fixed xor butterfly. At hd 256 the tiles
// take 141 KB of dynamic shared memory (one block an SM).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using rt::cp_async16;
using rt::cp_async_commit;
using rt::cp_async_wait;
using rt::pack_bf16;

constexpr int kFThreads = 256;
constexpr int kBQ = 64;   // queries per block
constexpr int kBK = 32;   // keys per tile
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct FArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int B, Sq, Skv, H, K;
  int causal, window, q_offset;
  float softcap;   // 0: none
  float sm_scale;  // 1/sqrt(hd) rounded to fp32
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

template <int HD>
constexpr int smem_floats() {
  return kBQ * (HD + 4) + kBK * (HD + 4) + kBK * HD + kBQ * (kBK + 1);
}

template <int HD, typename T>
__global__ void __launch_bounds__(kFThreads, 1)
flash_attention_kernel(const FArgs a) {
  constexpr int QS = HD + 4;     // padded row stride of the q and k tiles
  constexpr int PS = kBK + 1;    // row stride of the p tile
  constexpr int NC = HD / 32;    // float4 column groups a thread owns
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);   // [kBQ][QS]
  float* Ks = Qs + kBQ * QS;                     // [kBK][QS]
  float* Vs = Ks + kBK * QS;                     // [kBK][HD]
  float* Ps = Vs + kBK * HD;                     // [kBQ][PS]

  const T* __restrict__ q = static_cast<const T*>(a.q);
  const T* __restrict__ k = static_cast<const T*>(a.k);
  const T* __restrict__ v = static_cast<const T*>(a.v);
  const int t = threadIdx.x, tx = t & 7, ty = t >> 3;   // ty in [0, 32)
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int kh = h / (a.H / a.K);
  const int q0 = blockIdx.x * kBQ;
  const long long q_row = (long long)a.H * HD;      // q/out stride of s
  const long long kv_row = (long long)a.K * HD;     // k/v stride of j
  const T* qb = q + ((long long)b * a.Sq * a.H + h) * HD;
  const T* kb = k + ((long long)b * a.Skv * a.K + kh) * HD;
  const T* vb = v + ((long long)b * a.Skv * a.K + kh) * HD;

  for (int i = t; i < kBQ * HD; i += kFThreads) {
    const int r = i / HD, d = i % HD;
    Qs[r * QS + d] = q0 + r < a.Sq
        ? to_f32(qb[(q0 + r) * q_row + d]) * a.sm_scale : 0.0f;
  }

  // the keys some query of this tile can see: [kv_lo, kv_hi)
  const int qp_lo = a.q_offset + q0;
  const int qp_hi = a.q_offset + min(q0 + kBQ, a.Sq) - 1;
  int kv_lo = 0, kv_hi = a.Skv;
  if (a.window > 0) kv_lo = max(0, qp_lo - a.window + 1);
  if (a.causal) kv_hi = min(a.Skv, qp_hi + 1);

  const int qpos[2] = {qp_lo + ty, qp_lo + ty + 32};
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};
  float acc[2][NC * 4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int c = 0; c < NC * 4; ++c) acc[i][c] = 0.0f;

  for (int j0 = (kv_lo / kBK) * kBK; j0 < kv_hi; j0 += kBK) {
    __syncthreads();   // q staged; the last tile's Ps and Vs read
    for (int i = t; i < kBK * HD; i += kFThreads) {
      const int j = i / HD, d = i % HD;
      const bool in = j0 + j < a.Skv;
      Ks[j * QS + d] = in ? to_f32(kb[(j0 + j) * kv_row + d]) : 0.0f;
      Vs[j * HD + d] = in ? to_f32(vb[(j0 + j) * kv_row + d]) : 0.0f;
    }
    __syncthreads();

    float sc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[i][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qs[ty * QS + d]);
      const float4 qc =
          *reinterpret_cast<const float4*>(&Qs[(ty + 32) * QS + d]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 kk =
            *reinterpret_cast<const float4*>(&Ks[(tx + 8 * c) * QS + d]);
        sc[0][c] = fmaf(qa.x, kk.x, sc[0][c]);
        sc[0][c] = fmaf(qa.y, kk.y, sc[0][c]);
        sc[0][c] = fmaf(qa.z, kk.z, sc[0][c]);
        sc[0][c] = fmaf(qa.w, kk.w, sc[0][c]);
        sc[1][c] = fmaf(qc.x, kk.x, sc[1][c]);
        sc[1][c] = fmaf(qc.y, kk.y, sc[1][c]);
        sc[1][c] = fmaf(qc.z, kk.z, sc[1][c]);
        sc[1][c] = fmaf(qc.w, kk.w, sc[1][c]);
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bool vis[4];
      float mx = kNeg;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + tx + 8 * c;
        vis[c] = j < a.Skv && (!a.causal || j <= qpos[i]) &&
                 (a.window <= 0 || j > qpos[i] - a.window);
        float s = sc[i][c];
        if (a.softcap > 0.0f) s = a.softcap * tanhf(s / a.softcap);
        sc[i][c] = vis[c] ? s : kNeg;
        mx = fmaxf(mx, sc[i][c]);
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = vis[c] ? expf(sc[i][c] - m_new) : 0.0f;
        Ps[(ty + 32 * i) * PS + tx + 8 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC * 4; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float pa = Ps[ty * PS + j], pc = Ps[(ty + 32) * PS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&Vs[j * HD + 32 * c + 4 * tx]);
        acc[0][4 * c + 0] = fmaf(pa, vv.x, acc[0][4 * c + 0]);
        acc[0][4 * c + 1] = fmaf(pa, vv.y, acc[0][4 * c + 1]);
        acc[0][4 * c + 2] = fmaf(pa, vv.z, acc[0][4 * c + 2]);
        acc[0][4 * c + 3] = fmaf(pa, vv.w, acc[0][4 * c + 3]);
        acc[1][4 * c + 0] = fmaf(pc, vv.x, acc[1][4 * c + 0]);
        acc[1][4 * c + 1] = fmaf(pc, vv.y, acc[1][4 * c + 1]);
        acc[1][4 * c + 2] = fmaf(pc, vv.z, acc[1][4 * c + 2]);
        acc[1][4 * c + 3] = fmaf(pc, vv.w, acc[1][4 * c + 3]);
      }
    }
  }

  T* __restrict__ ob = static_cast<T*>(a.out) +
                       ((long long)b * a.Sq * a.H + h) * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + ty + 32 * i;
    if (r < a.Sq) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          store(ob + r * q_row + 32 * c + 4 * tx + e, acc[i][4 * c + e] / den);
    }
  }
}

template <int HD, typename T>
int launch(const FArgs& a, cudaStream_t stream) {
  const int bytes = smem_floats<HD>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HD, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.Sq + kBQ - 1) / kBQ, a.B * a.H);
  flash_attention_kernel<HD, T><<<grid, kFThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const FArgs& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<32, T>(a, stream);
    case 64: return launch<64, T>(a, stream);
    case 128: return launch<128, T>(a, stream);
    case 256: return launch<256, T>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// #17 on tensor cores (wgmma): bf16 q, k, v
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kThreads = 256;  // two warpgroups of 4 warps, 16 rows a warp
constexpr int kBQ = 64;        // query rows a warpgroup
constexpr int kBK = 32;        // keys per tile

// Shared memory holds each tile in swizzled atoms of 8 rows x ROWB bytes
// (ROWB = 128, or 64 at hd 32): row r of an atom at r ROWB, its 16-byte
// chunk c at (c ^ s(r)) 16, s(r) the address bits that the hardware's
// swizzle XORs in (r % 8 for 128-byte rows, (r / 2) % 4 for 64-byte);
// atoms start on 1024-byte boundaries. Q [2][kBQ x HD] (a tile per
// warpgroup) and K [kBK x HD] are K-major operands (d contiguous): atoms
// [d atom][8-row group]; a wgmma's 16-wide k step starts 32 bytes into its
// atom row, SBO = one atom (the next 8 rows). V [kBK x HD] is an MN-major
// operand (B = V, d along N): atoms [8-key group][d atom]; LBO = one atom
// (the next 64 or 32 d), SBO = a row of atoms (the next 8 keys). K and V
// are double-buffered and shared by both warpgroups.
template <int HD>
struct WL {
  static constexpr int ROWB = HD * 2 < 128 ? HD * 2 : 128;
  static constexpr int CPR = ROWB / 16;       // 16-byte chunks an atom row
  static constexpr int ATOM = 8 * ROWB;
  static constexpr int NA = HD * 2 / ROWB;    // atoms along d
  static constexpr uint32_t MODE = ROWB == 128 ? 1 : 2;
  static constexpr int QB = kBQ * HD * 2;
  static constexpr int KVB = kBK * HD * 2;
  static constexpr int SMEM = 2 * QB + 4 * KVB + 1024;   // + alignment slack
  // byte offset of chunk c (along d) of row r, in a K-major tile of R rows
  __device__ static int kmajor(int r, int c, int R) {
    return (c / CPR) * (R / 8) * ATOM + (r >> 3) * ATOM + swz(r, c % CPR);
  }
  // ... in the MN-major V tile
  __device__ static int mnmajor(int r, int c) {
    return (r >> 3) * NA * ATOM + (c / CPR) * ATOM + swz(r, c % CPR);
  }
  __device__ static int swz(int r, int cc) {
    return (r & 7) * ROWB + ((cc ^ (((r & 7) * ROWB >> 7) & (CPR - 1))) << 4);
  }
};

template <int HD>
__device__ __forceinline__ void pv(float (&o)[HD / 2], const uint32_t (&a)[4],
                                   uint64_t db) {
  if constexpr (HD == 32) rt::wgmma_m64n32_rs_t(o, a, db, 1);
  else if constexpr (HD == 64) rt::wgmma_m64n64_rs_t(o, a, db, 1);
  else if constexpr (HD == 128) rt::wgmma_m64n128_rs_t(o, a, db, 1);
  else rt::wgmma_m64n256_rs_t(o, a, db, 1);
}

// 2^x, 2 ulp (MUFU.EX2), results below 2^-126 flushed to 0: p and alpha
// lie in [0, 1], and a p that small adds nothing to a sum that holds 1
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Block: two warpgroups over one K/V stream. Where the GQA ratio is even,
// they are the two query heads of one KV head, 64 rows each (`pair`);
// otherwise 128 consecutive rows of one head. Warpgroup w's rows start at
// q0 + rw, its head is h0 + hw.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const FArgs a, int pair) {
  using L = WL<HD>;
  extern __shared__ __align__(1024) uint8_t wsmem[];
  uint8_t* Qs = wsmem + ((1024 - (rt::smem_addr(wsmem) & 1023)) & 1023);
  uint8_t* Ks = Qs + 2 * L::QB;            // [2] x KVB
  uint8_t* Vs = Ks + 2 * L::KVB;           // [2] x KVB

  const __nv_bfloat16* __restrict__ q =
      static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* __restrict__ k =
      static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* __restrict__ v =
      static_cast<const __nv_bfloat16*>(a.v);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wgi = warp >> 2, wq = warp & 3;   // warpgroup, warp in it
  const int rows = pair ? kBQ : 2 * kBQ;      // query rows of the block
  // the query tiles with the most keys (causal: the last) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * rows;
  const int heads = pair ? a.H / 2 : a.H;
  const int b = blockIdx.y / heads;
  const int h0 = (blockIdx.y % heads) * (pair ? 2 : 1);
  const int kh = h0 / (a.H / a.K);
  const int hw = pair ? wgi : 0, rw = pair ? 0 : kBQ * wgi;
  const long long q_row = (long long)a.H * HD;
  const long long kv_row = (long long)a.K * HD;
  const __nv_bfloat16* qb = q + ((long long)b * a.Sq * a.H + h0) * HD;
  const __nv_bfloat16* kb = k + ((long long)b * a.Skv * a.K + kh) * HD;
  const __nv_bfloat16* vb = v + ((long long)b * a.Skv * a.K + kh) * HD;
  constexpr int CH = HD / 8;          // 16-byte chunks of a row
  constexpr int RP = kThreads / CH;   // rows a pass
  const int c = tid % CH, r0 = tid / CH;

  // Q: tile w (64 rows) of warpgroup w
#pragma unroll
  for (int r = r0; r < 2 * kBQ; r += RP) {
    const int w = r / kBQ, qr = q0 + (pair ? 0 : kBQ * w) + r % kBQ;
    const bool in = qr < a.Sq;
    cp_async16(Qs + w * L::QB + L::kmajor(r % kBQ, c, kBQ),
               in ? qb + qr * q_row + (pair ? w : 0) * HD + c * 8 : qb,
               in ? 16 : 0);
  }
  auto load_k = [&](int j0, int buf) {
    const bool whole = j0 + kBK <= a.Skv;
    const __nv_bfloat16* src = kb + (long long)j0 * kv_row + c * 8;
    uint8_t* dst = Ks + buf * L::KVB;
#pragma unroll
    for (int r = r0; r < kBK; r += RP) {
      const bool in = whole || j0 + r < a.Skv;
      cp_async16(dst + L::kmajor(r, c, kBK), in ? src + r * kv_row : kb,
                 in ? 16 : 0);
    }
  };
  auto load_v = [&](int j0, int buf) {
    const bool whole = j0 + kBK <= a.Skv;
    const __nv_bfloat16* src = vb + (long long)j0 * kv_row + c * 8;
    uint8_t* dst = Vs + buf * L::KVB;
#pragma unroll
    for (int r = r0; r < kBK; r += RP) {
      const bool in = whole || j0 + r < a.Skv;
      cp_async16(dst + L::mnmajor(r, c), in ? src + r * kv_row : vb,
                 in ? 16 : 0);
    }
  };

  // the keys some query of the block can see: [kv_lo, kv_hi)
  const int qp_lo = a.q_offset + q0;
  const int qp_hi = a.q_offset + min(q0 + rows, a.Sq) - 1;
  int kv_lo = 0, kv_hi = a.Skv;
  if (a.window > 0) kv_lo = max(0, qp_lo - a.window + 1);
  if (a.causal) kv_hi = min(a.Skv, qp_hi + 1);
  const int j_first = (kv_lo / kBK) * kBK;
  const int ntiles = kv_hi > j_first ? (kv_hi - j_first + kBK - 1) / kBK : 0;

  // this warpgroup's first row, this warp's and this thread's positions.
  // Both warpgroups run every tile of the block's range: a tile that a
  // warpgroup's rows cannot see is masked whole (p = 0, alpha = 1), and
  // the wgmmas stay unconditional (ptxas serializes wgmmas issued under a
  // branch when an accumulator is rescaled between them)
  const int wg_row = q0 + rw;
  const int wpos = a.q_offset + wg_row + wq * 16;
  const int pos[2] = {wpos + g, wpos + g + 8};
  const uint8_t* Qw = Qs + wgi * L::QB;
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
  const bool cap = a.softcap > 0.0f;
  const float pre = cap ? a.sm_scale / a.softcap : a.sm_scale * kLog2e;
  const float post = a.softcap * kLog2e;

  // S = Q K^T of tile `tile` (64 x 32, fp32) into d, asynchronously
  auto issue_qk = [&](float (&d)[16], int tile) {
#pragma unroll
    for (int i = 0; i < 16; ++i) d[i] = 0.0f;
    rt::wg_hold(d);            // defined before the fence, not sunk past it
    rt::wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      // k step kk: d atom kk * 32 / ROWB, 32-byte column kk * 32 % ROWB
      const int at = kk * 32 / L::ROWB, col = kk * 32 % L::ROWB;
      const uint64_t da = rt::wg_desc(
          Qw + at * (kBQ / 8) * L::ATOM + col, 16, L::ATOM, L::MODE);
      const uint64_t db = rt::wg_desc(
          Ks + (tile & 1) * L::KVB + at * (kBK / 8) * L::ATOM + col, 16,
          L::ATOM, L::MODE);
      rt::wgmma_m64n32_ss(d, da, db, kk > 0);
    }
    rt::wg_commit();
  };

  // The pipeline. Copy groups, in commit order: {Q, K0}, {K1}, {V0}, then
  // each step i commits {K(i+2)} and {V(i+1)}. Step i: S(i+1) = Q K(i+1)^T
  // is issued to the tensor cores and the softmax of S(i) runs on the CUDA
  // cores beside it; then O is rescaled and O += P(i) V(i) issued, and the
  // step waits for it. No register of a wgmma in flight is touched (ptxas
  // would serialize the wgmmas), and a buffer is refilled only after every
  // warp has waited for the wgmma that read it (the barriers order that).
  float sc[16], sn[16];
  if (ntiles > 0) load_k(j_first, 0);
  cp_async_commit();
  if (ntiles > 1) load_k(j_first + kBK, 1);
  cp_async_commit();
  if (ntiles > 0) load_v(j_first, 0);
  cp_async_commit();
  if (ntiles > 0) {
    cp_async_wait<2>();        // Q, K0
    rt::fence_proxy_async();
    __syncthreads();
    issue_qk(sc, 0);
    rt::wg_wait<0>();
    rt::wg_hold(sc);
  }

  for (int it = 0; it < ntiles; ++it) {
    const int j0 = j_first + it * kBK;
    const bool more = it + 1 < ntiles;
    cp_async_wait<1>();        // K(it+1); V(it) may still be in flight
    rt::fence_proxy_async();
    __syncthreads();           // ... and every warp is past step it-1
    issue_qk(sn, more ? it + 1 : it);   // the last step's S(it) is unused
    if (it + 2 < ntiles) load_k(j0 + 2 * kBK, it & 1);   // K(it) consumed
    cp_async_commit();
    if (more) load_v(j0 + kBK, (it + 1) & 1);            // V(it-1) consumed
    cp_async_commit();

    uint32_t ph[2][4], pl[2][4];
    float alpha[2];
    {
      // scale, softcap, mask; both rows' online softmax interleaved, the
      // maxima and sums by trees (a row's 32 scores sit in a quad's four
      // lanes, 8 each)
      const bool full = j0 + kBK <= a.Skv &&
                        (!a.causal || j0 + kBK - 1 <= wpos) &&
                        (a.window <= 0 || j0 > wpos + 15 - a.window);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        float s = sc[i] * pre;
        if (cap) s = post * tanhf(s);
        if (!full) {
          const int j = j0 + (i >> 2) * 8 + 2 * t + (i & 1);
          const int p = pos[(i >> 1) & 1];
          if (j >= a.Skv || (a.causal && j > p) ||
              (a.window > 0 && j <= p - a.window))
            s = kNeg;
        }
        sc[i] = s;
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        // row hr holds sc[4n + 2hr + e], n < 4, e < 2
        float mx = fmaxf(fmaxf(fmaxf(sc[2 * hr], sc[2 * hr + 1]),
                               fmaxf(sc[4 + 2 * hr], sc[5 + 2 * hr])),
                         fmaxf(fmaxf(sc[8 + 2 * hr], sc[9 + 2 * hr]),
                               fmaxf(sc[12 + 2 * hr], sc[13 + 2 * hr])));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hr], mx);
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float sv = sc[4 * n + 2 * hr + e];
            sc[4 * n + 2 * hr + e] = sv > kNeg ? ex2(sv - m_new) : 0.0f;
          }
        float sum = ((sc[2 * hr] + sc[2 * hr + 1]) +
                     (sc[4 + 2 * hr] + sc[5 + 2 * hr])) +
                    ((sc[8 + 2 * hr] + sc[9 + 2 * hr]) +
                     (sc[12 + 2 * hr] + sc[13 + 2 * hr]));
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        alpha[hr] = ex2(m[hr] - m_new);
        l[hr] = l[hr] * alpha[hr] + sum;
        m[hr] = m_new;
      }
      // P = P_hi + P_lo, both bf16 (P_lo = P - P_hi exact in fp32, then
      // rounded): ~2^-16 relative error in P, where one bf16 P has 2^-9
#pragma unroll
      for (int js = 0; js < 2; ++js)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          // A fragment r: rows g (r even) / g+8 (r odd), n8 tile 2js + r/2
          const float c0 = sc[4 * (2 * js + (r >> 1)) + 2 * (r & 1)];
          const float c1 = sc[4 * (2 * js + (r >> 1)) + 2 * (r & 1) + 1];
          ph[js][r] = pack_bf16(c0, c1);
          // a bf16 widened to fp32 is its bits in the high half
          pl[js][r] = pack_bf16(c0 - __uint_as_float(ph[js][r] << 16),
                                c1 - __uint_as_float(ph[js][r] & 0xffff0000u));
        }
    }

    // S(it+1) has landed; only then is O rescaled (no accumulator of a
    // wgmma is written while one is in flight)
    rt::wg_wait<0>();
    rt::wg_hold(sn);
    if (alpha[0] != 1.0f || alpha[1] != 1.0f) {
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[4 * n] *= alpha[0];
        o[4 * n + 1] *= alpha[0];
        o[4 * n + 2] *= alpha[1];
        o[4 * n + 3] *= alpha[1];
      }
    }
    // V(it): every copy group but the two just committed has landed
    cp_async_wait<2>();
    rt::fence_proxy_async();
    __syncthreads();
    // O += P_hi V + P_lo V
    rt::wg_hold(o);
    rt::wg_fence();
#pragma unroll
    for (int js = 0; js < 2; ++js) {
      const uint64_t db = rt::wg_desc(
          Vs + (it & 1) * L::KVB + 2 * js * L::NA * L::ATOM, L::ATOM,
          L::NA * L::ATOM, L::MODE);
      pv<HD>(o, ph[js], db);
      pv<HD>(o, pl[js], db);
    }
    rt::wg_commit();
    rt::wg_wait<0>();          // O
    rt::wg_hold(o);
#pragma unroll
    for (int i = 0; i < 16; ++i) sc[i] = sn[i];
  }
  cp_async_wait<0>();

  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.out) +
                      ((long long)b * a.Sq * a.H + h0 + hw) * HD;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = wg_row + wq * 16 + g + 8 * hr;
    if (r >= a.Sq) continue;
    const float den = fmaxf(l[hr], 1e-30f);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(ob + r * q_row + n * 8 + 2 * t) =
          pack_bf16(o[4 * n + 2 * hr] / den, o[4 * n + 2 * hr + 1] / den);
  }
}

template <int HD>
int launch_tc(const FArgs& a, cudaStream_t stream) {
  static bool sized = false;   // once per instance: the shared-memory cap
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        WL<HD>::SMEM);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const int pair = (a.H / a.K) % 2 == 0;
  const int rows = pair ? kBQ : 2 * kBQ;
  dim3 grid((a.Sq + rows - 1) / rows, a.B * a.H / (pair ? 2 : 1));
  flash_tc_kernel<HD><<<grid, kThreads, WL<HD>::SMEM, stream>>>(a, pair);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q, out (B, Sq, H, hd); k, v (B, Skv, K, hd); all float32 (CUDA cores)
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  void* out, int B, int Sq, int Skv, int H,
                                  int K, int hd, int causal, int window,
                                  int q_offset, float softcap, float sm_scale,
                                  void* stream) {
  FArgs a;
  a.q = q; a.k = k; a.v = v; a.out = out;
  a.B = B; a.Sq = Sq; a.Skv = Skv; a.H = H; a.K = K;
  a.causal = causal; a.window = window; a.q_offset = q_offset;
  a.softcap = softcap; a.sm_scale = sm_scale;
  if (Sq <= 0 || Skv <= 0 || K <= 0 || H % K || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  return launch_hd<float>(a, hd, (cudaStream_t)stream);
}

// q, out (B, Sq, H, hd); k, v (B, Skv, K, hd); all bf16 (tensor cores)
extern "C" int rt_flash_attention_tc(const void* q, const void* k,
                                     const void* v, void* out, int B, int Sq,
                                     int Skv, int H, int K, int hd, int causal,
                                     int window, int q_offset, float softcap,
                                     float sm_scale, void* stream) {
  FArgs a;
  a.q = q; a.k = k; a.v = v; a.out = out;
  a.B = B; a.Sq = Sq; a.Skv = Skv; a.H = H; a.K = K;
  a.causal = causal; a.window = window; a.q_offset = q_offset;
  a.softcap = softcap; a.sm_scale = sm_scale;
  if (Sq <= 0 || Skv <= 0 || K <= 0 || H % K || B * H > 65535 ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 32: return tc::launch_tc<32>(a, s);
    case 64: return tc::launch_tc<64>(a, s);
    case 128: return tc::launch_tc<128>(a, s);
    case 256: return tc::launch_tc<256>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
