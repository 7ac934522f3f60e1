// K2 page-table gather: (P, ps, K, hd) page pool + (B, npag) page ids ->
// (B, npag * ps, K, hd) contiguous per-slot view. A pure copy, bitwise.
//
// Replaces repro/serve/paged.py _gather_pallas, where scalar prefetch
// fed the page table to the block index map and each grid step copied
// one page through VMEM. Here one block copies one (slot, page) and
// reads its own page id; the wrapper has already clipped the table into
// the pool (the RELEASED sentinel reads some page, which the caller masks).
//
// Bound by bytes: every view byte is read once and written once. Design:
// 16-byte vector loads and stores, consecutive threads on consecutive
// addresses; a bf16 page of 16 tokens x 4 heads x 128 dims is 16 KB, so
// each of the 256 threads moves four 16-byte words.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void gather_pages_kernel(const uint8_t* __restrict__ pool,
                                    const int32_t* __restrict__ ptab,
                                    uint8_t* __restrict__ out, int npag,
                                    long long page_bytes, int vec16) {
  const int j = blockIdx.x, b = blockIdx.y;
  const long long page = ptab[(long long)b * npag + j];
  const uint8_t* src = pool + page * page_bytes;
  uint8_t* dst = out + ((long long)b * npag + j) * page_bytes;
  if (vec16) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    const long long n = page_bytes / 16;
    for (long long i = threadIdx.x; i < n; i += blockDim.x) d[i] = s[i];
  } else {
    for (long long i = threadIdx.x; i < page_bytes; i += blockDim.x)
      dst[i] = src[i];
  }
}

}  // namespace

extern "C" int rt_gather_pages(const void* pool, const void* ptab, void* out,
                               int B, int npag, long long page_bytes,
                               void* stream) {
  const int vec16 = (page_bytes % 16 == 0) && ((uintptr_t)pool % 16 == 0) &&
                    ((uintptr_t)out % 16 == 0);
  dim3 grid(npag, B);
  gather_pages_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)pool, (const int32_t*)ptab, (uint8_t*)out, npag,
      page_bytes, vec16);
  return (int)cudaGetLastError();
}
