"""Parameter layout of the distributed step (port of
``repro/dist/sharding.py``).

Two orthogonal partitions are planned here:

  1. **Model-axis sharding** (context parallelism): each parameter leaf
     gets a shard dim along which it is split over the grid's ``model``
     axis. The forward holds only the local shard and gathers whole
     weights layer by layer (``collectives.gather_shard``, or the int8
     ``quantized_gather_shard``). MoE expert tensors are expert-sharded
     (``EXPERT_MARKER``) and stay local in the forward gather.
  2. **Worker chunking** (the parameter-server partition of Algorithms
     2+3): each model shard is flattened, zero padded and split into
     ``n_workers`` equal chunks; worker ``w`` is the "server" that owns
     chunk ``w``, applies the averaged quantized updates to it and
     broadcasts its quantized weights.

Shard-dim encoding (the ``dims`` tree of a :class:`Layout`):

  * ``REPLICATED`` (-1): the leaf is whole on every model shard.
  * ``ROW`` (-2): split along axis 0 of the *unstacked* shape (axis 1 of
    a scan-stacked ``blocks`` leaf).
  * ``EXPERT_MARKER`` (0): a MoE expert tensor, split along its expert
    axis (axis 0 unstacked) and kept local in the forward gather.
  * ``d >= 1``: split along unstacked axis ``d``.

The reference's ``leaf_pspec`` and ``Layout.param_specs`` place a leaf on
a JAX mesh and have no PyTorch meaning; :meth:`Layout.shard_axes` says
the same thing as numbers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.tree import tree_map

REPLICATED = -1
ROW = -2
EXPERT_MARKER = 0

# top-level keys whose leaves carry a leading scan-over-layers dim
_STACKED_KEYS = ("blocks", "enc_blocks")
_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


# ---------------------------------------------------------------------------
# worker chunking
# ---------------------------------------------------------------------------

def chunk_size(numel: int, n_workers: int) -> int:
    """Per-worker chunk length: ceil(numel / n_workers)."""
    return -(-int(numel) // int(n_workers))


def flatten_pad(x: torch.Tensor, n_workers: int) -> torch.Tensor:
    """Flatten a leaf (or shard) and split it into the worker-ownership
    rows of Algorithm 2: (n_workers, chunk_size), zero padded. A view of
    x where no padding is needed."""
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


# ---------------------------------------------------------------------------
# model-axis shard dims
# ---------------------------------------------------------------------------

def _is_expert_path(path: Tuple[str, ...]) -> bool:
    return ("moe" in path and "shared" not in path
            and bool(path) and path[-1] in _EXPERT_LEAVES)


def shard_dim_for(path: Tuple[str, ...], shape: Tuple[int, ...],
                  n_shards: int, stacked: bool) -> int:
    """The model-axis shard dim of one leaf (the module docstring's
    encoding): expert tensors on their expert axis, else the first
    unstacked axis that divides by ``n_shards``; REPLICATED where none
    does, and at one shard."""
    un = tuple(shape[1:]) if stacked else tuple(shape)
    if not un:
        return REPLICATED
    if _is_expert_path(path) and un[0] % n_shards == 0:
        return EXPERT_MARKER
    if n_shards <= 1:
        return REPLICATED
    if un[0] % n_shards == 0:
        return ROW
    for d in range(1, len(un)):
        if un[d] % n_shards == 0:
            return d
    return REPLICATED


def axis_of(dim: int, stacked: bool) -> Optional[int]:
    """The tensor axis (of the possibly stacked shape) a shard dim
    splits, or None for REPLICATED."""
    if dim == REPLICATED:
        return None
    off = 1 if stacked else 0
    return off if dim in (ROW, EXPERT_MARKER) else dim + off


def local_shard_shape(shape: Tuple[int, ...], dim: int, stacked: bool,
                      n_shards: int) -> Tuple[int, ...]:
    """The shape of one model shard of a leaf."""
    ax = axis_of(dim, stacked)
    if ax is None:
        return tuple(shape)
    out = list(shape)
    out[ax] = out[ax] // n_shards
    return tuple(out)


def shard_of(leaf: torch.Tensor, dim: int, stacked: bool, n_shards: int,
             index: int) -> torch.Tensor:
    """Model shard ``index`` of a whole leaf (a view)."""
    ax = axis_of(dim, stacked)
    if ax is None:
        return leaf
    size = leaf.shape[ax] // n_shards
    return leaf.narrow(ax, index * size, size)


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

def _map_keys(fn, tree, prefix: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over a nested dict, ``path`` the tuple of keys."""
    if isinstance(tree, dict):
        return {k: _map_keys(fn, v, prefix + (str(k),))
                for k, v in tree.items()}
    return fn(prefix, tree)


def _stacked(path: Tuple[str, ...]) -> bool:
    return bool(path) and path[0] in _STACKED_KEYS


@dataclasses.dataclass(frozen=True)
class Layout:
    """The plan of one parameter tree over ``n_shards`` model shards:
    ``shapes`` (the whole leaves' shapes), ``dims`` (shard dims) and
    ``stacked`` (a leading layer dim) mirror the tree."""

    shapes: Any
    dims: Any
    stacked: Any
    n_shards: int = 1

    def shard_axes(self):
        """Per leaf, ``(axis, n_shards)``: the tensor axis the model axis
        splits (of the whole, possibly stacked, shape) and into how many
        shards; ``(None, 1)`` for a leaf that is whole on every shard.
        The counterpart of the reference's ``param_specs``."""
        def one(dim, stacked):
            ax = axis_of(dim, stacked)
            return (ax, self.n_shards) if ax is not None else (None, 1)
        return tree_map(one, self.dims, self.stacked)


def build_layout(params: Any, n_shards: int = 1) -> Layout:
    """Plan model-axis sharding for a parameter tree (tensors, e.g. on the
    meta device); ``n_shards`` is the grid's model-axis size."""
    shapes = tree_map(lambda p: tuple(p.shape), params)
    stacked = _map_keys(lambda path, _: _stacked(path), params)
    dims = _map_keys(lambda path, p: shard_dim_for(
        path, tuple(p.shape), n_shards, _stacked(path)), params)
    return Layout(shapes=shapes, dims=dims, stacked=stacked,
                  n_shards=int(n_shards))


def dims_by_path(layout: Layout) -> Dict[Tuple[str, ...], Tuple[int, bool]]:
    """``{path: (dim, stacked)}`` of every leaf."""
    out = {}
    _map_keys(lambda path, d: out.__setitem__(path, d),
              tree_map(lambda d, s: (d, s), layout.dims, layout.stacked))
    return out


def worker_info(grid, worker_axes=("pod", "data")
                ) -> Tuple[Tuple[str, ...], Tuple[int, ...], int]:
    """The requested worker axes present in ``grid``
    (``launch.mesh.Grid``), their sizes and the worker count."""
    ms = dict(zip(grid.axes, grid.sizes))
    axes = tuple(a for a in worker_axes if a in ms)
    sizes = tuple(ms[a] for a in axes)
    return axes, sizes, math.prod(sizes)


def split_worker_axes(worker_axes, wsizes, n_outer: int, n_inner: int):
    """The per-tier layout of a hierarchical topology: the prefix of the
    worker axes whose sizes multiply to ``n_outer`` (the node tier) and
    the suffix multiplying to ``n_inner``. Worker ``w = outer * n_inner
    + inner`` in the row-major order of the workers, so chunk ownership
    and the state layout are unchanged by the split.

    Raises where the product is not the worker count, or where the split
    falls inside one axis (2 nodes out of one 8-wide ``data`` axis): give
    the node tier its own grid axis instead."""
    axes = tuple(worker_axes)
    sizes = tuple(int(s) for s in wsizes)
    total = math.prod(sizes)
    if int(n_outer) * int(n_inner) != total:
        raise ValueError(
            f"topology ({n_outer} nodes x {n_inner} devices) needs "
            f"{n_outer * n_inner} workers but the mesh's worker axes "
            f"{dict(zip(axes, sizes))} give {total}")
    prod, k = 1, 0
    while k < len(axes) and prod < n_outer:
        prod *= sizes[k]
        k += 1
    if prod != n_outer:
        raise ValueError(
            f"cannot split worker axes {dict(zip(axes, sizes))} into "
            f"({n_outer} x {n_inner}) tiers on an axis boundary; give "
            f"the node tier its own mesh axis (e.g. pod={n_outer}, "
            f"data={n_inner})")
    return axes[:k], sizes[:k], axes[k:], sizes[k:]
