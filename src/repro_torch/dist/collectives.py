"""The quantized wire of Algorithm 3 on ``torch.distributed`` (port of
``repro/dist/collectives.py``, the worker channels): every cross-worker
collective ships packed uint8 payload rows plus float32 scales, or
float32 rows where a channel is unquantized.

The reference names its workers by mesh axes inside ``shard_map``; here
a process group is the worker axis and a rank its worker index. Two
channels, both error-compensated in ``repro_torch.dist.step`` (the
baselines' variants in ``repro_torch.dist.modes``):

  * **update exchange** (worker -> server): each worker K7-encodes its
    update ``Delta_t + e_t`` into per-chunk payload rows and all-to-alls
    them, so worker ``w`` (the server of chunk ``w``) receives every
    worker's codes for its chunk and K6-decodes each row with that
    worker's scale. Per leaf ``n_workers * codec.payload_nbytes(c)``
    bytes a worker.
  * **weight broadcast** (server -> worker): each server K7-encodes its
    master chunk with the weight codec and all-gathers the payload;
    every worker K6-decodes Q_x(x_t) for the whole leaf.

The collectives are the synchronous forms of ``torch.distributed``: on
NCCL they are ordered on the device after the current stream's work and
the host does not wait for them; on gloo (CPU tests) they block.
Hierarchical tiers are not ported (``repro_torch.dist.topology``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.comm import codec as CD
from repro_torch.dist.topology import Tiers


def _check_flat(tiers: Optional[Tiers]) -> None:
    if tiers is not None and tiers.intra_axes:
        raise NotImplementedError(
            "hierarchical tiers are not ported yet (ROADMAP.md queue 1)")


def worker_index(group) -> int:
    """This worker's index: its rank in the group."""
    return dist.get_rank(group)


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    # all_gather_single is the newer name of all_gather_into_tensor
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, x.reshape(-1).contiguous(), group=group)
    return out.reshape((n,) + tuple(x.shape))


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """All-gather one per-worker payload or float32 row -> (n_workers,
    *x.shape), rows in rank order (one flat all-gather: gloo takes flat
    buffers only)."""
    return _all_gather(x, group)


def gather_side(x: torch.Tensor, group) -> torch.Tensor:
    """All-gather a scale side channel (a per-tensor scale, or the
    blockwise codec's per-block scales) -> (n_workers, *x.shape). Kept
    apart from :func:`gather_rows`: the byte accounting counts payloads
    only."""
    return _all_gather(x, group)


def reduce_rows(rows: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) of float32 worker-ownership rows, in place: the
    ``dp_adam`` baseline's gradient reduce (the reference's psum)."""
    dist.all_reduce(rows, group=group)
    return rows


def exchange_rows(rows: torch.Tensor, group) -> torch.Tensor:
    """All-to-all of worker-ownership rows: row j goes to worker j; the
    result's row i is worker i's row for this worker."""
    out = torch.empty_like(rows)
    dist.all_to_all_single(out, rows.contiguous(), group=group)
    return out


def exchange_decode(payload_rows: torch.Tensor, scale: torch.Tensor, codec,
                    c: int, group, *, backend: Optional[str] = None
                    ) -> torch.Tensor:
    """Update-exchange channel for one leaf: my per-chunk payload rows
    (K7) -> all_to_all -> K6 decode of every worker's codes for MY chunk
    with its source scale. Returns ``(n_workers, c)`` float32 rows."""
    if payload_rows.dtype != torch.uint8:
        raise ValueError("the exchange moves uint8 payload rows")
    recv = exchange_rows(payload_rows, group)
    scales = gather_side(scale.reshape(()), group)
    return CD.decode_rows(recv, scales, codec, c, backend=backend)


def exchange_decode_tiered(payload_rows, scale, codec, c: int, tiers, group,
                           *, backend: Optional[str] = None):
    """Tier-aware ``exchange_decode``: flat tiers only."""
    _check_flat(tiers)
    return exchange_decode(payload_rows, scale, codec, c, group,
                           backend=backend)


def gather_rows_tiered(x: torch.Tensor, tiers, group) -> torch.Tensor:
    """Tier-aware ``gather_rows``: flat tiers only."""
    _check_flat(tiers)
    return gather_rows(x, group)


def broadcast_decode(payload: torch.Tensor, scale: torch.Tensor, codec,
                     c: int, group, *, backend: Optional[str] = None,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weight-broadcast channel for one leaf: my chunk's packed payload
    -> all_gather -> K6 decode of every chunk with its source scale.
    Returns ``(n_workers, c)`` float32 rows, or writes the leaf's first
    ``out.numel()`` values into ``out`` (the rows' padding dropped)."""
    if payload.dtype != torch.uint8:
        raise ValueError("the broadcast moves uint8 payloads")
    rows = gather_rows(payload, group)
    scales = gather_side(scale.reshape(()), group)
    return CD.decode_rows(rows, scales, codec, c, backend=backend, out=out)


def broadcast_decode_tiered(payload, scale, codec, c: int, tiers, group, *,
                            backend: Optional[str] = None, out=None):
    """Tier-aware ``broadcast_decode``: flat tiers only."""
    _check_flat(tiers)
    return broadcast_decode(payload, scale, codec, c, group, backend=backend,
                            out=out)
