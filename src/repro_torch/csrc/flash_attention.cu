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
// float32 route, rt_flash_attention_tc32 (namespace tc32): the tensor
// cores in 3xTF32. bf16 operands cannot hold rtol 1e-4 on fp32 inputs and
// one TF32 pass errs by 2^-10 a product, but a = hi + lo with hi =
// tf32(a), lo = tf32(a - hi) (both truncated, mma.cuh split_tf32) and the
// three products lo hi + hi lo + hi hi (lo lo dropped) err by ~2^-19,
// which holds the tier (the numpy emulation in
// tests/test_torch_flash_attention.py shows it, for this split and for
// round-to-nearest, and that one pass fails). Both S = Q K^T and O += P V take the three MMAs. The
// fp32-accurate floors at gemma2's global layer (275 GFLOP): 3 x 275
// GFLOP at 494.7 TFLOP/s TF32 = 1.67 ms; CUDA cores, 275 GFLOP at 66.9
// TFLOP/s fp32 = 4.11 ms (data sheet, 700 W).
// mma.sync.m16n8k8.tf32, not wgmma: wgmma takes TF32 only K-major, and
// for P V that is V key-contiguous, a transpose that cp.async's 16-byte
// row copies cannot do; mma.sync loads each B element itself, so V stays
// as it lands (row 2t, column g of a k step: conflict-free at a row
// stride of 4 mod 32 words). The contracted index is permuted inside each
// k step (MMA k t <-> element 2t, k t+4 <-> 2t+1): for S both Q's and K's
// fragment pairs are one 8-byte shared load each; for P V it makes the
// S accumulator's layout (keys 2t, 2t+1 of each 8) P's A fragment with no
// shuffle. The operands are split on the fly in registers after the
// fragment load (two masks and a subtraction an element), so
// shared memory holds fp32 only: at hd 256, Q for 128 rows 128 x 264 x 4
// = 135,168 B (a split Q would be twice that), a 32-key K tile 33,792 B
// and V 33,280 B, 202,240 B in all of the 232,448 an SM has; K and V are
// single-buffered, K(i+1) copied during softmax and P V of tile i, V(i+1)
// during S of tile i+1. A block is 8 warps over one K/V stream, as the
// bf16 route's. Each tile's P V is summed by the tensor cores from zero
// over its 32 keys and added into O with one fp32 fma (O = alpha O + PV):
// the MMA's truncating accumulation never sees the long sum over Skv. A
// warp skips the MMAs of a tile none of its rows sees. Registers at hd
// 256: O 128, P hi/lo 32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

using rt::cp_async16;
using rt::cp_async_commit;
using rt::cp_async_wait;
using rt::pack_bf16;

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

// ---------------------------------------------------------------------------
// #17 on tensor cores in float32: 3xTF32 mma.sync
// ---------------------------------------------------------------------------

namespace tc32 {

using rt::mma_3xtf32;
using rt::split_tf32;

constexpr int kThreads = 256;  // 8 warps of 16 query rows
constexpr int kBQ = 64;        // query rows of 4 warps (a head's, paired)
constexpr int kBK = 32;        // keys per tile
constexpr int kCG = 4;         // n8 column tiles of P V summed together

// Shared memory, fp32 as cp.async lands it: Q [2 kBQ][QS], K [kBK][QS],
// V [kBK][VS]. A warp reads Q and K as 8-byte pairs (row g, columns 2t,
// 2t+1: a half-warp's 16 pairs fall in distinct banks at a row stride of
// 8 mod 32 words) and V as words (row 2t or 2t+1, column g: distinct at
// 4 mod 32).
template <int HD>
struct L32 {
  static constexpr int QS = HD + 8;
  static constexpr int VS = HD + 4;
  static constexpr int QF = 2 * kBQ * QS;
  static constexpr int KF = kBK * QS;
  static constexpr int VF = kBK * VS;
  static constexpr int SMEM = (QF + KF + VF) * 4;
  static_assert(SMEM <= 232448, "a block's shared memory on sm_90");
  static_assert(HD / 8 % kCG == 0, "whole column groups");
};

// Block: 8 warps over one K/V stream, as the bf16 route's: the two query
// heads of one KV head (64 rows each, `pair`) or 128 rows of one head.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc32_kernel(const FArgs a, int pair) {
  using L = L32<HD>;
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;
  float* Ks = Qs + L::QF;
  float* Vs = Ks + L::KF;

  const float* __restrict__ q = static_cast<const float*>(a.q);
  const float* __restrict__ k = static_cast<const float*>(a.k);
  const float* __restrict__ v = static_cast<const float*>(a.v);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wgi = warp >> 2, wq = warp & 3;
  const int rows = pair ? kBQ : 2 * kBQ;
  // the query tiles with the most keys (causal: the last) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * rows;
  const int heads = pair ? a.H / 2 : a.H;
  const int b = blockIdx.y / heads;
  const int h0 = (blockIdx.y % heads) * (pair ? 2 : 1);
  const int kh = h0 / (a.H / a.K);
  const int hw = pair ? wgi : 0, rw = pair ? 0 : kBQ * wgi;
  const long long q_row = (long long)a.H * HD;
  const long long kv_row = (long long)a.K * HD;
  const float* qb = q + ((long long)b * a.Sq * a.H + h0) * HD;
  const float* kb = k + ((long long)b * a.Skv * a.K + kh) * HD;
  const float* vb = v + ((long long)b * a.Skv * a.K + kh) * HD;
  constexpr int CH = HD / 4;   // 16-byte chunks of a row

  // Q: row r of shared memory is row r % 64 of warp group r / 64
  for (int i = tid; i < 2 * kBQ * CH; i += kThreads) {
    const int r = i / CH, c = i % CH, w = r / kBQ;
    const int qr = q0 + (pair ? 0 : kBQ * w) + r % kBQ;
    const bool in = qr < a.Sq;
    cp_async16(Qs + r * L::QS + 4 * c,
               in ? qb + qr * q_row + (pair ? w : 0) * HD + 4 * c : qb,
               in ? 16 : 0);
  }
  auto load_kv = [&](float* dst, int stride, const float* src, int j0) {
    for (int i = tid; i < kBK * CH; i += kThreads) {
      const int r = i / CH, c = i % CH;
      const bool in = j0 + r < a.Skv;
      cp_async16(dst + r * stride + 4 * c,
                 in ? src + (long long)(j0 + r) * kv_row + 4 * c : src,
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

  // this warp's first row and position; a tile that none of its 16 rows
  // sees is skipped by the warp (mma.sync has no wgmma's serialization)
  const int wrow = q0 + rw + wq * 16;
  const int wpos = a.q_offset + wrow;
  const int pos[2] = {wpos + g, wpos + g + 8};
  float m[2] = {kNeg, kNeg}, l[2] = {0.0f, 0.0f};
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
  const bool cap = a.softcap > 0.0f;
  const float pre = cap ? a.sm_scale / a.softcap : a.sm_scale * kLog2e;
  const float post = a.softcap * kLog2e;
  const float* qw = Qs + (16 * warp + g) * L::QS + 2 * t;
  const float* kw = Ks + g * L::QS + 2 * t;
  const float* vw = Vs + 2 * t * L::VS + g;

  // Copy groups, in commit order: {Q, K0}, {V0}, then each tile i commits
  // {K(i+1)} once every warp has read K(i), and {V(i+1)} once every warp
  // has read V(i): K(i+1) lands during softmax and P V of tile i, V(i+1)
  // during S of tile i+1.
  if (ntiles > 0) load_kv(Ks, L::QS, kb, j_first);
  cp_async_commit();
  if (ntiles > 0) load_kv(Vs, L::VS, vb, j_first);
  cp_async_commit();

  for (int it = 0; it < ntiles; ++it) {
    const int j0 = j_first + it * kBK;
    const int jmax = min(j0 + kBK, a.Skv) - 1;
    const bool sees = wrow < a.Sq && (!a.causal || j0 <= wpos + 15) &&
                      (a.window <= 0 || jmax > wpos - a.window);
    cp_async_wait<1>();        // Q, K(it)
    __syncthreads();
    // S = Q K^T (16 x 32) in 3xTF32. The contracted d is permuted within
    // each k step (MMA k t <-> d 2t, k t+4 <-> d 2t+1) in both operands,
    // so each fragment pair is one 8-byte shared load
    float sc[4][4];
    if (sees) {
      float ss[4][4];   // the cross terms, a chain beside sc's
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = ss[n][e] = 0.0f;
#pragma unroll 4
      for (int ks = 0; ks < HD / 8; ++ks) {
        const float2 x0 = *reinterpret_cast<const float2*>(qw + 8 * ks);
        const float2 x1 =
            *reinterpret_cast<const float2*>(qw + 8 * L::QS + 8 * ks);
        uint32_t ah[4], al[4];
        split_tf32(x0.x, ah[0], al[0]);
        split_tf32(x1.x, ah[1], al[1]);
        split_tf32(x0.y, ah[2], al[2]);
        split_tf32(x1.y, ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const float2 kk =
              *reinterpret_cast<const float2*>(kw + 8 * n * L::QS + 8 * ks);
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(kk.x, bh0, bl0);
          split_tf32(kk.y, bh1, bl1);
          mma_3xtf32(sc[n], ss[n], ah, al, bh0, bh1, bl0, bl1);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] += ss[n][e];
    }
    __syncthreads();           // every warp has read K(it)
    if (it + 1 < ntiles) load_kv(Ks, L::QS, kb, j0 + kBK);
    cp_async_commit();

    // scale, softcap, mask, online softmax (log2 domain, as the bf16
    // route); P = P_hi + P_lo as the A fragments of P V: key group n,
    // rows g / g+8, MMA k t <-> key 8n+2t, k t+4 <-> key 8n+2t+1
    uint32_t ph[4][4], pl[4][4];
    float alpha[2] = {1.0f, 1.0f};
    if (sees) {
      const bool full = j0 + kBK <= a.Skv &&
                        (!a.causal || j0 + kBK - 1 <= wpos) &&
                        (a.window <= 0 || j0 > wpos + 15 - a.window);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float s = sc[n][e] * pre;
          if (cap) s = post * tanhf(s);
          if (!full) {
            const int j = j0 + 8 * n + 2 * t + (e & 1);
            const int p = pos[e >> 1];
            if (j >= a.Skv || (a.causal && j > p) ||
                (a.window > 0 && j <= p - a.window))
              s = kNeg;
          }
          sc[n][e] = s;
        }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = fmaxf(fmaxf(fmaxf(sc[0][2 * hr], sc[0][2 * hr + 1]),
                               fmaxf(sc[1][2 * hr], sc[1][2 * hr + 1])),
                         fmaxf(fmaxf(sc[2][2 * hr], sc[2][2 * hr + 1]),
                               fmaxf(sc[3][2 * hr], sc[3][2 * hr + 1])));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hr], mx);
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float sv = sc[n][2 * hr + e];
            sc[n][2 * hr + e] = sv > kNeg ? tc::ex2(sv - m_new) : 0.0f;
          }
        float sum = ((sc[0][2 * hr] + sc[0][2 * hr + 1]) +
                     (sc[1][2 * hr] + sc[1][2 * hr + 1])) +
                    ((sc[2][2 * hr] + sc[2][2 * hr + 1]) +
                     (sc[3][2 * hr] + sc[3][2 * hr + 1]));
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        alpha[hr] = tc::ex2(m[hr] - m_new);
        l[hr] = l[hr] * alpha[hr] + sum;
        m[hr] = m_new;
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        split_tf32(sc[n][0], ph[n][0], pl[n][0]);
        split_tf32(sc[n][2], ph[n][1], pl[n][1]);
        split_tf32(sc[n][1], ph[n][2], pl[n][2]);
        split_tf32(sc[n][3], ph[n][3], pl[n][3]);
      }
    }

    cp_async_wait<1>();        // V(it); K(it+1) may still be in flight
    __syncthreads();
    if (sees) {
      // O = alpha O + P V(it), kCG n8 column tiles at a time: the tile's
      // 32 products of an output summed by the tensor cores from zero (hi
      // hi and the cross terms apart: 2 kCG independent chains), then one
      // fp32 fma into the running O (the MMA's truncating accumulation
      // never sees the long sum)
#pragma unroll
      for (int c0 = 0; c0 < HD / 8; c0 += kCG) {
        float db[kCG][4], ds[kCG][4];
#pragma unroll
        for (int c = 0; c < kCG; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e) db[c][e] = ds[c][e] = 0.0f;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
#pragma unroll
          for (int c = 0; c < kCG; ++c) {
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(vw[8 * n * L::VS + 8 * (c0 + c)], bh0, bl0);
            split_tf32(vw[(8 * n + 1) * L::VS + 8 * (c0 + c)], bh1, bl1);
            mma_3xtf32(db[c], ds[c], ph[n], pl[n], bh0, bh1, bl0, bl1);
          }
        }
#pragma unroll
        for (int c = 0; c < kCG; ++c)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[4 * (c0 + c) + e] = fmaf(o[4 * (c0 + c) + e], alpha[e >> 1],
                                       db[c][e] + ds[c][e]);
      }
    }
    __syncthreads();           // every warp has read V(it)
    if (it + 1 < ntiles) load_kv(Vs, L::VS, vb, j0 + kBK);
    cp_async_commit();
  }
  cp_async_wait<0>();

  float* ob = static_cast<float*>(a.out) +
              ((long long)b * a.Sq * a.H + h0 + hw) * HD;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = wrow + g + 8 * hr;
    if (r >= a.Sq) continue;
    const float den = fmaxf(l[hr], 1e-30f);
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
      *reinterpret_cast<float2*>(ob + r * q_row + 8 * c + 2 * t) =
          make_float2(o[4 * c + 2 * hr] / den, o[4 * c + 2 * hr + 1] / den);
  }
}

template <int HD>
int launch(const FArgs& a, cudaStream_t stream) {
  static bool sized = false;   // once per instance: the shared-memory cap
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tc32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        L32<HD>::SMEM);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const int pair = (a.H / a.K) % 2 == 0;
  const int rows = pair ? kBQ : 2 * kBQ;
  dim3 grid((a.Sq + rows - 1) / rows, a.B * a.H / (pair ? 2 : 1));
  flash_tc32_kernel<HD><<<grid, kThreads, L32<HD>::SMEM, stream>>>(a, pair);
  return (int)cudaGetLastError();
}

}  // namespace tc32


}  // namespace

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

// q, out (B, Sq, H, hd); k, v (B, Skv, K, hd); all float32 (tensor cores,
// 3xTF32)
extern "C" int rt_flash_attention_tc32(const void* q, const void* k,
                                       const void* v, void* out, int B,
                                       int Sq, int Skv, int H, int K, int hd,
                                       int causal, int window, int q_offset,
                                       float softcap, float sm_scale,
                                       void* stream) {
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
    case 32: return tc32::launch<32>(a, s);
    case 64: return tc32::launch<64>(a, s);
    case 128: return tc32::launch<128>(a, s);
    case 256: return tc32::launch<256>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
