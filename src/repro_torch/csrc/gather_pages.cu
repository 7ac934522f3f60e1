// K2 page-table gather: (P, ps, K, hd) page pool(s) + (B, npag) page ids ->
// (B, npag * ps, K, hd) contiguous per-slot view(s). A pure copy, bitwise.
//
// Replaces repro/serve/paged.py _gather_pallas, where scalar prefetch
// fed the page table to the block index map and each grid step copied
// one page through VMEM. Here a block copies one 4 KB chunk of one
// (slot, page) and reads its own page id, clamped into the pool in the
// kernel (min(max(id, 0), P - 1)): the RELEASED sentinel reads some page,
// which the caller masks, and the wrapper launches nothing before it. One
// launch gathers the K and the V pool of a layer (grid y = the pools:
// two source and two destination pointers), so a decode step's cache
// view is one launch a layer, not four (two clamps, two gathers).
//
// Bound by bytes: every view byte is read once and written once. Design:
// 16-byte vector loads and stores, consecutive threads on consecutive
// addresses, each thread's kUnroll loads in flight before its first
// store. Chunks of 256 words fill the card where one block a page did
// not: a bf16 page of 16 tokens x 4 heads x 128 dims is 16 KB, so the
// serving cell's 4 slots x 8 pages are 128 blocks a pool (32 before), and
// gemma2's 4 x 264 pages of 32 KB are 8448 a pool.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 2;
constexpr int kChunk = kThreads * kUnroll;   // words a block copies

struct Pools {
  const uint8_t* src[2];
  uint8_t* dst[2];
};

// T: the word (uint4 when every page and pointer is 16-byte aligned, else
// a byte); page_units: words of a page; chunks: blocks a page
template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_pages_kernel(const Pools pools, const int32_t* __restrict__ ptab,
                    int num_pages, long long page_units, int chunks) {
  const long long page = blockIdx.x / chunks;    // slot * npag + j
  const int c = blockIdx.x % chunks;
  int id = __ldg(ptab + page);
  id = min(max(id, 0), num_pages - 1);
  // the pool by a select, not an index into the parameter array (which
  // would copy the array to local memory)
  const bool second = blockIdx.y != 0;
  const T* __restrict__ src =
      reinterpret_cast<const T*>(second ? pools.src[1] : pools.src[0]) +
      id * page_units;
  T* __restrict__ dst =
      reinterpret_cast<T*>(second ? pools.dst[1] : pools.dst[0]) +
      page * page_units;
  const long long i0 = (long long)c * kChunk + threadIdx.x;
  T v[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = i0 + u * kThreads;
    if (i < page_units) v[u] = src[i];
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = i0 + u * kThreads;
    if (i < page_units) dst[i] = v[u];
  }
}

}  // namespace

// pools: one (pool_v, out_v null) or two (K and V of a layer) pools of
// num_pages pages of page_bytes each, gathered through one table
extern "C" int rt_gather_pages(const void* pool_k, const void* pool_v,
                               const void* ptab, void* out_k, void* out_v,
                               int B, int npag, int num_pages,
                               long long page_bytes, void* stream) {
  const int npools = pool_v != nullptr ? 2 : 1;
  if (B < 1 || npag < 1 || num_pages < 1 || page_bytes < 1 ||
      (npools == 2 && out_v == nullptr))
    return (int)cudaErrorInvalidValue;
  Pools p;
  p.src[0] = (const uint8_t*)pool_k;
  p.dst[0] = (uint8_t*)out_k;
  p.src[1] = npools == 2 ? (const uint8_t*)pool_v : p.src[0];
  p.dst[1] = npools == 2 ? (uint8_t*)out_v : p.dst[0];
  bool vec16 = page_bytes % 16 == 0;
  for (int i = 0; i < npools; ++i)
    vec16 = vec16 && (uintptr_t)p.src[i] % 16 == 0 &&
            (uintptr_t)p.dst[i] % 16 == 0;
  const long long units = vec16 ? page_bytes / 16 : page_bytes;
  const long long chunks = (units + kChunk - 1) / kChunk;
  const long long blocks = (long long)B * npag * chunks;
  if (chunks > 0x7fffffffLL || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)blocks, npools);
  if (vec16)
    gather_pages_kernel<uint4><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        p, (const int32_t*)ptab, num_pages, units, (int)chunks);
  else
    gather_pages_kernel<uint8_t><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        p, (const int32_t*)ptab, num_pages, units, (int)chunks);
  return (int)cudaGetLastError();
}
