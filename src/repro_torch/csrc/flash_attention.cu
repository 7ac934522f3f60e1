// #17 flash attention, forward: out = softmax(mask(softcap(q k^T / sqrt(hd))))
// v per query head, GQA (query head h reads KV head h / (H / K)), causal,
// sliding window, logit softcap, a query position offset.
//
// Replaces repro/kernels/flash_attention.py flash_attention
// (_flash_fwd_kernel, the pallas_call at :99). On the TPU a grid step held
// a (128, hd) query block and the whole (Skv, hd) K/V of its head in VMEM
// and looped over 128-key tiles up to the causal diagonal, streaming the
// tiles below the window too. Here a block of 256 threads owns a
// (kBQ = 64, hd) query tile of one (batch, head), held scaled in shared
// memory as fp32 (q * (1/sqrt(hd)) in fp32, the kernel's definition), and
// walks kBK = 32-key tiles of K and V staged in shared memory as fp32.
// Only the tiles that some query of the tile can see are visited: the
// ones past the causal diagonal and the ones below the window are skipped.
// Skipping is exact: the TPU kernel's fully masked leading tile adds p =
// exp(0) = 1 rows that the first visible tile's alpha = exp(-1e30 - m) = 0
// wipes to zero, and here a masked score's p is set to 0 outright (so a
// query that sees no key at all gets zeros; the TPU kernel gives the mean
// of the tiles it streamed, which depends on its tiling). The running
// maximum starts at the finite sentinel -1e30, as the TPU kernel's: with
// -inf, a tile no query sees would give inf - inf = NaN.
//
// Scores and the online softmax are fp32 on CUDA cores: each thread holds
// a 2 x 4 block of the 64 x 32 score tile (rows ty, ty + 32; columns
// tx + 8c), reading q and k as float4 from rows padded by 4 floats
// (conflict-free), and a 2 x (hd / 8) block of the output accumulator
// (columns 32c + 4tx + e). Row maxima and sums fold over the 8 lanes of a
// row by a fixed xor butterfly, so every lane of a row holds the same m
// and l, and the result is deterministic. The output is acc / max(l,
// 1e-30), rounded once to q's dtype.
//
// Bound: the FLOPs of the visible (query, key) pairs, 4 hd a pair, over
// the H100 SXM's 989 TFLOP/s bf16 peak (data sheet, 700 W): at gemma2's
// prefill (S 8192, H 8, hd 256) ~275 GFLOP for a global causal layer
// (0.28 ms) and ~206 GFLOP for a local layer of window 4096 (0.21 ms).
// fp32 on CUDA cores (67 TFLOP/s peak) cannot reach it; tensor-core
// fragments (mma.sync or wgmma on bf16 tiles) are the later step. At
// hd 256 the tiles take 141 KB of dynamic shared memory (one block an
// SM), allowed by cudaFuncAttributeMaxDynamicSharedMemorySize before each
// launch.
// Ragged Sq and Skv are masked: rows past Sq are not written, keys past
// Skv are not visible.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFThreads = 256;
constexpr int kBQ = 64;   // queries per block
constexpr int kBK = 32;   // keys per tile
constexpr float kNeg = -1e30f;

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
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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

}  // namespace

// q, out (B, Sq, H, hd); k, v (B, Skv, K, hd); all of one dtype
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v,
                                  void* out, int B, int Sq, int Skv, int H,
                                  int K, int hd, int causal, int window,
                                  int q_offset, float softcap, float sm_scale,
                                  int bf16, void* stream) {
  FArgs a;
  a.q = q; a.k = k; a.v = v; a.out = out;
  a.B = B; a.Sq = Sq; a.Skv = Skv; a.H = H; a.K = K;
  a.causal = causal; a.window = window; a.q_offset = q_offset;
  a.softcap = softcap; a.sm_scale = sm_scale;
  if (Sq <= 0 || Skv <= 0 || K <= 0 || H % K || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch_hd<__nv_bfloat16>(a, hd, s)
              : launch_hd<float>(a, hd, s);
}
