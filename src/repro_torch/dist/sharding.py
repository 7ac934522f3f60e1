"""Parameter layout of the distributed step (port of
``repro/dist/sharding.py``, the worker chunking and the layout at one
model shard).

Worker chunking (the parameter-server partition of Algorithms 2+3):
each leaf is flattened, zero-padded and split into ``n_workers`` equal
chunks; worker ``w`` is the "server" that owns chunk ``w``, applies the
averaged quantized updates to it and broadcasts its quantized weights.

The port runs one model shard (the reference's ``--model 1``): every
leaf is whole on every worker. Sharding over a model axis (the
reference's shard dims, FSDP gathers and expert leaves) is queued in
ROADMAP.md.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

from repro_torch.tree import tree_map

def chunk_size(numel: int, n_workers: int) -> int:
    """Per-worker chunk length: ceil(numel / n_workers)."""
    return -(-int(numel) // int(n_workers))


def flatten_pad(x: torch.Tensor, n_workers: int) -> torch.Tensor:
    """Flatten a leaf and split it into the worker-ownership rows of
    Algorithm 2: (n_workers, chunk_size), zero padded. A view of x where
    no padding is needed."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    c = chunk_size(n, n_workers)
    if n_workers * c != n:
        flat = torch.nn.functional.pad(flat, (0, n_workers * c - n))
    return flat.reshape(n_workers, c)


def unflatten_chunked(rows: torch.Tensor, shape: Tuple[int, ...]
                      ) -> torch.Tensor:
    """Inverse of flatten_pad: (n_workers, c) -> original shape."""
    numel = math.prod(shape)
    return rows.reshape(-1)[:numel].reshape(shape)


@dataclasses.dataclass(frozen=True)
class Layout:
    """The plan of one parameter tree at one model shard: ``shapes``
    mirrors the tree (a shape tuple per leaf); every leaf is whole on
    every worker (the reference's ``REPLICATED``)."""

    shapes: Any
    n_shards: int = 1


def build_layout(params: Any, n_shards: int = 1) -> Layout:
    """Plan a parameter tree (tensors, e.g. on the meta device) at one
    model shard."""
    if n_shards != 1:
        raise NotImplementedError(
            "sharding over a model axis (--model > 1) is not ported yet "
            "(ROADMAP.md queue 1)")
    return Layout(shapes=tree_map(lambda p: tuple(p.shape), params))
