"""Shared pieces of the per-mode distributed updaters (port of
``repro/dist/modes/base.py``).

A mode owns the per-leaf optimizer math (through ``repro_torch.opt``'s
engine) and declares its update-exchange wire as a codec; the step
template in ``repro_torch.dist.step`` owns the rest (weight broadcast ->
forward/backward -> update -> exchange).

Updater contract: ``updater(g, m, v, e, chunk, meta, hp, mark=None,
draw=None, idx=None)`` with the flat float32 gradient of the whole leaf, its
moments and residual (over the whole leaf, or this worker's chunk where
the mode's ``chunk_sharded_moments``), this worker's master chunk, its
``LeafMeta`` and the (4,) hyperparameter tensor [alpha_t, beta, theta_t,
eps] on the device; returns ``(new_chunk, m', v', e')``. ``mark(name)``,
when given, is called after the update and exchange ("update_exchange")
and after the master update ("master_update"), for per-phase device
timing. ``draw(n)`` returns n uniforms in [0, 1) for this (step, leaf,
worker), the stochastic codecs' randomness (the reference's per-leaf
key). ``idx`` is the leaf's index in the reference's leaf order (its
``metas_flat``: dict keys sorted), what per-leaf wire plans key on. The
port's updaters write their results in place: the returned tensors are
the given chunk, m, v and e (the reference donates these buffers to its
step), followed by one ``adapt.stats`` row (a (3,) float32 tensor) where
the mode sets ``emits_stats``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.comm import bits as B
from repro_torch.comm import codec as CD
from repro_torch.comm import kernels as K
from repro_torch.dist import collectives as C
from repro_torch.dist.topology import Tiers, flat_tiers
from repro_torch.opt import engine, grids


@dataclasses.dataclass(frozen=True)
class WorkerCtx:
    """Worker geometry of one train step: the worker group (the
    reference's worker axes; this worker's rank in it is its index), the
    worker count, the kernels' backend (None: by device), the resolved
    tiers and their process groups (None: flat, over ``group``)."""

    group: Any
    n_workers: int
    backend: Optional[str] = None
    tiers: Optional[Tiers] = None
    groups: Optional[C.TierGroups] = None


def ctx_tiers(ctx: WorkerCtx) -> Tiers:
    """The context's resolved tiers, defaulting to flat."""
    if ctx.tiers is not None:
        return ctx.tiers
    return flat_tiers(("data",), (ctx.n_workers,))


def ctx_groups(ctx: WorkerCtx) -> C.TierGroups:
    """The context's tier groups: flat tiers span the worker group."""
    if ctx.groups is not None:
        return ctx.groups
    if ctx.tiers is not None and ctx.tiers.hierarchical:
        raise ValueError("hierarchical tiers need their process groups "
                         "(WorkerCtx.groups)")
    return C.TierGroups(inter=ctx.group)


@dataclasses.dataclass(frozen=True)
class ModeSpec:
    """One optimizer mode: updater factory + wire declaration + state
    layout.

    ``wire_codec(grad_k)`` names the update-exchange codec; the byte
    accounting behind ``train.loop.comm_bytes_per_step`` derives from it
    (packed codes only, scale side-channels excluded), so the figure is
    byte for byte the payload the collectives move.
    ``chunk_sharded_moments``: m, v and e hold this worker's chunk (c
    elements, ``dp_adam``) instead of the whole leaf. ``extra_state``
    adds chunk-sized state leaves; ``broadcast_ef`` turns on server-side
    error feedback on the weight-broadcast channel (``efadam``).
    ``tiered``: the updater understands hierarchical topologies (an
    intra float32 pre-reduce, the exchange over the inter tier);
    ``dp_adam`` opts out, its all-reduce being one reduction over every
    worker on any topology, and keeps its wire on the inter tier.

    ``per_leaf`` (the adaptive mode) maps ``(tc, leaf_idx) -> codec`` so
    different leaves ride different lanes; ``leaf_codec`` and
    ``leaf_wire_nbytes`` are the indexed entry points every accounting
    path goes through, and fall back to ``wire_codec`` without a
    per-leaf plan. ``leaf_idx`` is the reference's leaf order.
    ``emits_stats`` marks updaters that return a trailing stats row."""

    name: str
    chunk_sharded_moments: bool
    make_updater: Callable          # (tc, ctx: WorkerCtx) -> updater
    wire_codec: Callable            # (grad_k) -> codec
    extra_state: Tuple[str, ...] = ()
    broadcast_ef: bool = False
    per_leaf: Optional[Callable] = None   # (tc, leaf_idx) -> codec
    emits_stats: bool = False
    tiered: bool = True

    def wire_nbytes(self, c: int, n_workers: int, grad_k=None) -> int:
        """Per-worker, per-leaf update-exchange payload bytes."""
        return n_workers * self.wire_codec(grad_k).payload_nbytes(c)

    def leaf_codec(self, tc, idx: int):
        """Wire codec for leaf ``idx`` (the reference's leaf order)."""
        if self.per_leaf is not None:
            return self.per_leaf(tc, idx)
        return self.wire_codec(tc.grad_k)

    def leaf_wire_nbytes(self, tc, idx: int, c: int, n_workers: int) -> int:
        return n_workers * self.leaf_codec(tc, idx).payload_nbytes(c)

    def leaf_tier_nbytes(self, tc, idx: int, c: int, numel: int,
                         n_workers: int, tiers: Optional[Tiers]) -> dict:
        """Per-worker update-path bytes by link tier: ``inter`` the
        all-to-all'd payload (packed codes), ``intra`` the float32 rows
        the hierarchical pre-reduce gathers (``tier_grad_mean``:
        ``n_intra`` rows of the shard). A flat topology (or a mode that
        is not ``tiered``) has everything on the inter tier, exactly
        ``leaf_wire_nbytes``."""
        if not self.tiered or tiers is None or not tiers.intra_axes:
            return {"inter": self.leaf_wire_nbytes(tc, idx, c, n_workers),
                    "intra": 0}
        codec = self.leaf_codec(tc, idx)
        return {"inter": tiers.n_inter * codec.payload_nbytes(c),
                "intra": tiers.n_intra * numel * 4}


def worker_mean(rows: torch.Tensor) -> torch.Tensor:
    """Mean over worker rows by pairwise (tree) summation, as the
    reference: with n a power of two and identical rows (the paper's
    identical-worker equivalence) the result is bit-exact, which a
    sequential reduce is not. One row is returned as it is (x / 1 == x
    exactly), which spares a pass at one worker."""
    def psum_rows(x):
        k = x.shape[0]
        if k == 1:
            return x[0]
        h = k // 2
        return psum_rows(x[:h]) + psum_rows(x[h:])
    if rows.shape[0] == 1:
        return rows[0]
    return psum_rows(rows) / rows.shape[0]


def identity_codec(grad_k=None):
    """Wire declaration of the uncompressed (float32 rows) modes."""
    return CD.IdentityCodec()


def tier_grad_mean(g: torch.Tensor, tiers: Optional[Tiers],
                   group=None) -> torch.Tensor:
    """The hierarchical pre-reduce: this leaf's flat gradient all-gathered
    over the intra group (``group``, the fast tier) and tree-averaged by
    :func:`worker_mean`, so every device of a node goes on with bitwise
    the same node-mean gradient (its moments, residuals and codes then
    agree, and the exchange ships one row a node). The pairwise tree
    fixes the summation order (exact for identical rows at a power-of-two
    node width), where an all-reduce would leave it to the library. The
    identity on flat tiers."""
    if tiers is None or not tiers.intra_axes:
        return g
    return worker_mean(C.gather_rows(g, group))


def blockwise_exchange(de: torch.Tensor, codec, meta, ctx: WorkerCtx,
                       tiers: Optional[Tiers] = None):
    """The blockwise wire of ``ef_sgd`` and the adaptive 2-bit lanes:
    sign codes of Delta+e and their
    per-256-block mean |.| scales (#14), the EF residual against this
    worker's own dequantized codes, the codes lane-packed into
    worker-ownership rows (#9) and all-to-all'd, unpacked (#9), the (nb,) scales all-gathered
    (a side channel), and each source's codes for MY chunk rescaled by
    that source's scale columns for my chunk: elements [w*c, (w+1)*c) of
    its block-repeated scales (w the flat worker index: chunk ownership
    does not depend on the topology). Chunks need not align to blocks.
    The all-to-all and the scale gather run over the exchange (inter)
    tier. Returns ``(recv_rows (n_src, c), e2)``, ``n_src = n_inter``
    (``n_workers`` when flat)."""
    tiers = tiers if tiers is not None else ctx_tiers(ctx)
    groups = ctx_groups(ctx)
    n = de.numel()
    block = codec.block
    codes2d, scale_b = engine.quantize_blockwise(de, block,
                                                 backend=ctx.backend)
    e2 = de - grids.blockwise_dequantize(codes2d, scale_b).reshape(-1)[:n]
    payload = K.pack_rows(B.pad_rows(codes2d.reshape(-1)[:n], ctx.n_workers),
                          codec.bits, backend=ctx.backend)     # #9
    del codes2d
    codes_rows = K.unpack_rows(C.exchange_rows_tiered(payload, tiers, groups),
                               codec.bits, meta.c, backend=ctx.backend)
    scales = C.gather_side(scale_b, groups.inter)          # (n_src, nb)
    W, nb = scales.shape
    c = meta.c
    w = C.worker_index(ctx.group)
    # block b covers elements [b*block, (b+1)*block): my chunk's columns
    # j in [w*c, (w+1)*c) read block j // block (zero past the scales)
    lo, hi = w * c, (w + 1) * c
    b0 = lo // block
    b1 = max(min(-(-hi // block), nb), b0)
    elem = scales[:, b0:b1, None].expand(W, b1 - b0, block).reshape(W, -1)
    elem = elem[:, lo - b0 * block:hi - b0 * block]
    if elem.shape[1] < c:
        elem = torch.nn.functional.pad(elem, (0, c - elem.shape[1]))
    return codes_rows.to(torch.float32) * elem, e2
