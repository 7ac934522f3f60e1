"""Carry parameter trees and optimizer state across from the reference
package.

The reference's tree, after ``jax.tree.map(np.asarray, params)``, is a
nested dict of numpy arrays whose quantized leaves are objects with
``codes``, ``scale``, ``k_x``, ``shape``, ``dtype`` and ``pack_bits``.
These functions turn it into the port's tree on ``device``, so both
packages compute with the same weights and state. Nothing here imports
the reference: quantized leaves and states are read by their attributes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import threefry
from repro_torch.core.qadam import QAdamState
from repro_torch.serve.quantized import QuantizedLeaf


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def quantized_from_numpy(leaf, device="cuda") -> QuantizedLeaf:
    """One reference ``QuantizedLeaf`` (numpy codes and scale) -> the
    port's, on ``device``."""
    return QuantizedLeaf(codes=_tensor(leaf.codes, device),
                         scale=_tensor(leaf.scale, device).to(torch.float32),
                         k_x=int(leaf.k_x), shape=tuple(leaf.shape),
                         dtype=str(leaf.dtype),
                         pack_bits=int(getattr(leaf, "pack_bits", 0)),
                         cast=getattr(leaf, "cast", None))


def params_from_numpy(tree, device="cuda", *, layout=None, index: int = 0):
    """A reference parameter tree (numpy leaves, nested dicts, quantized
    leaves by attribute) -> the port's tree on ``device``. With a
    ``layout`` (``dist.sharding.Layout``), model shard ``index`` of each
    float leaf: what a rank of a model-sharded grid holds."""
    if layout is not None:
        from repro_torch.dist import sharding as SH
        dims = SH.dims_by_path(layout)

        def shard(path, t):
            if isinstance(t, dict):
                return {k: shard(path + (k,), v) for k, v in t.items()}
            leaf = params_from_numpy(t, device)
            dim, stacked = dims[path]
            return SH.shard_of(leaf, dim, stacked, layout.n_shards,
                               index).contiguous()
        return shard((), tree)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if hasattr(tree, "codes") and hasattr(tree, "k_x"):
        return quantized_from_numpy(tree, device)
    return _tensor(tree, device)


def qadam_state_from_numpy(state, device="cuda") -> QAdamState:
    """A reference ``QAdamState`` with numpy leaves (count, m, v, e, and
    the PRNG key the stochastic quantizers draw under, uint32 (2,)) ->
    the port's, with the step count on the host and the key as the port
    holds it (``core.threefry``: int32 bit patterns on ``device``)."""
    return QAdamState(count=int(np.asarray(state.count)),
                      m=params_from_numpy(state.m, device),
                      v=params_from_numpy(state.v, device),
                      e=params_from_numpy(state.e, device),
                      key=threefry.key_from_uint32(state.key, device))


def dist_state_from_numpy(state, rank: int, n_workers: int, device="cuda",
                          index: int = 0, n_shards: int = 1):
    """The reference's chunked distributed state (``master``, ``m``,
    ``v``, ``e`` and a mode's extra leaves such as ``efadam``'s ``es``:
    trees of arrays shaped ``worker_sizes + (n_shards, X)``, X the chunk
    or the whole shard as the mode lays out its moments; and ``count``),
    as numpy -> the state of worker ``rank`` at model shard ``index`` in
    ``repro_torch.dist.step`` (flat float32 leaves, the count on the
    host)."""
    def leaf(a):
        a = np.asarray(a)
        if a.size % (n_workers * n_shards):
            raise ValueError(f"a state leaf of shape {a.shape} does not "
                             f"split over {n_workers} workers x "
                             f"{n_shards} shards")
        rows = a.reshape(n_workers, n_shards, -1)
        return _tensor(rows[rank, index], device).to(torch.float32)

    def tree(t):
        if isinstance(t, dict):
            return {k: tree(v) for k, v in t.items()}
        return leaf(t)

    out = {k: tree(v) for k, v in state.items() if k != "count"}
    out["count"] = int(np.asarray(state["count"]))
    return out
