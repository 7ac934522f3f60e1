"""Paged KV cache: one physical page pool + per-slot page tables (port of
``repro/serve/paged.py``).

Layout per layer: pool ``pk``/``pv`` (num_pages, page_size, K, hd);
table ``ptab`` (slots, max_seq // page_size) int32 global page ids, with
``num_pages`` as the RELEASED sentinel (writes drop, view columns are
masked invalid).

``gather_pages`` is K2: it replaces ``_gather_pallas`` with the copy
kernel in ``csrc/gather_pages.cu`` (a block per 4 KB chunk of a page,
16-byte vector copies, the page ids clamped into the pool inside the
kernel; bound by bytes). ``gather_pages_kv`` gathers a layer's K and V
pools through one table in one launch of the same kernel (the decode
step's and the chunk's cache view). Their plain version ``_gather_torch``
is one index over the page axis. All are bitwise: a gather moves bytes.

``PagePool`` is the host-side allocator, ported one to one.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch import build
from repro_torch.comm.codec import resolve_backend
from repro_torch.kernels.meta import charged

launches = 0        # K2 kernel launches (either entry point)
launches_kv = 0     # ... of them by gather_pages_kv (K and V in one)
plain_on_cuda = 0   # plain versions run on CUDA tensors


def _gather_torch(pool, ptab):
    """(B, npag) ids into a (P, ps, K, hd) pool -> (B, npag*ps, K, hd),
    the ids clipped into the pool."""
    Bn, npag = ptab.shape
    _, ps, K, hd = pool.shape
    ids = torch.clamp(ptab.to(torch.int32), 0, pool.shape[0] - 1)
    return pool[ids.long()].reshape(Bn, npag * ps, K, hd)


def _gather_cuda(pools, ptab):
    """One K2 launch over one or two pools of the same shape."""
    global launches
    Bn, npag = ptab.shape
    P, ps, K, hd = pools[0].shape
    if not (1 <= Bn <= 65535):
        raise ValueError(f"{Bn} table rows outside [1, 65535]")
    lib = build.library()
    pools = [p.contiguous() for p in pools]
    ptab = ptab.to(torch.int32).contiguous()
    outs = [torch.empty((Bn, npag * ps, K, hd), dtype=p.dtype,
                        device=p.device) for p in pools]
    page_bytes = ps * K * hd * pools[0].element_size()
    two = len(pools) == 2
    err = lib.rt_gather_pages(
        build.ptr(pools[0]), build.ptr(pools[1]) if two else None,
        build.ptr(ptab), build.ptr(outs[0]), build.ptr(outs[1]) if two
        else None, Bn, npag, P, page_bytes, build.stream_ptr(pools[0].device))
    build.check(err, "gather_pages")
    launches += 1
    return outs


def _trivial(pool, ptab) -> bool:
    return pool.shape[0] == 0 or ptab.shape[1] == 0


@charged("K2 gather_pages")
def gather_pages(pool: torch.Tensor, ptab: torch.Tensor, *,
                 backend: Optional[str] = None) -> torch.Tensor:
    """Contiguous cache view of each slot's pages.

    pool: (num_pages, page_size, K, hd) physical pages (one layer).
    ptab: (B, npag) int32 page ids, clipped into the pool (inside the
        kernel on the card), so RELEASED-sentinel rows read some page;
        callers mask those view columns invalid.

    Returns (B, npag * page_size, K, hd).
    """
    global plain_on_cuda
    if _trivial(pool, ptab):
        return _gather_torch(pool, ptab)
    if resolve_backend(backend, pool, ptab) == "cuda":
        return _gather_cuda([pool], ptab)[0]
    plain_on_cuda += pool.is_cuda
    return _gather_torch(pool, ptab)


@charged("K2 gather_pages_kv")
def gather_pages_kv(pk: torch.Tensor, pv: torch.Tensor, ptab: torch.Tensor,
                    *, backend: Optional[str] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(gather_pages(pk, ptab), gather_pages(pv, ptab))`` in one K2
    launch on the card: a layer's K and V pools (the same shape and dtype)
    through one page table."""
    global plain_on_cuda, launches_kv
    if pk.shape != pv.shape or pk.dtype != pv.dtype:
        raise ValueError(f"K and V pools differ: {tuple(pk.shape)} "
                         f"{pk.dtype} vs {tuple(pv.shape)} {pv.dtype}")
    if _trivial(pk, ptab):
        return _gather_torch(pk, ptab), _gather_torch(pv, ptab)
    if resolve_backend(backend, pk, pv, ptab) == "cuda":
        kc, vc = _gather_cuda([pk, pv], ptab)
        launches_kv += 1
        return kc, vc
    plain_on_cuda += pk.is_cuda
    return _gather_torch(pk, ptab), _gather_torch(pv, ptab)


# ---------------------------------------------------------------------------
# host-side page allocator
# ---------------------------------------------------------------------------

def pages_for(ntokens: int, page_size: int) -> int:
    """Pages needed to hold ``ntokens`` cache rows."""
    return max(0, -(-int(ntokens) // int(page_size)))


class PagePool:
    """Free-list allocator over the physical page pool (host state only).

    LIFO free list: allocation order is deterministic for a given request
    schedule; reuse cycles fragment the id space, which the table
    indirection absorbs.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 1 or page_size < 1:
            raise ValueError("PagePool needs num_pages >= 1, page_size >= 1")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self._free: List[int] = list(range(num_pages - 1, -1, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    def pages_for(self, ntokens: int) -> int:
        return pages_for(ntokens, self.page_size)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` pages, or None (and no change) when the pool can't
        cover the request."""
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, pages: List[int]) -> None:
        for p in pages:
            if not 0 <= p < self.num_pages:
                raise ValueError(f"freeing foreign page {p}")
        self._free.extend(pages)
        if len(self._free) > self.num_pages:
            raise RuntimeError("double free: free list exceeds the pool")

    def nbytes(self, n_layers: int, page_bytes: int) -> int:
        """Physical pool bytes (all layers) for sizing comparisons."""
        return n_layers * self.num_pages * page_bytes
