"""Shared pieces of the per-mode distributed updaters (port of
``repro/dist/modes/base.py``).

A mode owns the per-leaf optimizer math (through ``repro_torch.opt``'s
engine) and declares its update-exchange wire as a codec; the step
template in ``repro_torch.dist.step`` owns the rest (weight broadcast ->
forward/backward -> update -> exchange).

Updater contract: ``updater(g, m, v, e, chunk, meta, hp, mark=None)``
with the flat float32 gradient, moments and residual of the whole leaf,
this worker's master chunk, its ``LeafMeta`` and the (4,)
hyperparameter tensor [alpha_t, beta, theta_t, eps] on the device;
returns ``(new_chunk, m', v', e')``. ``mark(name)``, when given, is
called after the update and exchange ("update_exchange") and after the
master update ("master_update"), for per-phase device timing. The port's updaters write them in place:
the returned tensors are the given chunk, m, v and e (the reference
donates these buffers to its step).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.dist.topology import Tiers, flat_tiers


@dataclasses.dataclass(frozen=True)
class WorkerCtx:
    """Worker geometry of one train step: the process group (the
    reference's worker axes), the worker count, the kernels' backend
    (None: by device) and the resolved tiers."""

    group: Any
    n_workers: int
    backend: Optional[str] = None
    tiers: Optional[Tiers] = None


def ctx_tiers(ctx: WorkerCtx) -> Tiers:
    """The context's resolved tiers, defaulting to flat."""
    if ctx.tiers is not None:
        return ctx.tiers
    return flat_tiers(("data",), (ctx.n_workers,))


@dataclasses.dataclass(frozen=True)
class ModeSpec:
    """One optimizer mode: updater factory + wire declaration.

    ``wire_codec(grad_k)`` names the update-exchange codec; the byte
    accounting behind ``train.loop.comm_bytes_per_step`` derives from it
    (packed codes only, scale side-channels excluded), so the figure is
    byte for byte the payload the collectives move."""

    name: str
    make_updater: Callable          # (tc, ctx: WorkerCtx) -> updater
    wire_codec: Callable            # (grad_k) -> codec

    def wire_nbytes(self, c: int, n_workers: int, grad_k=None) -> int:
        """Per-worker, per-leaf update-exchange payload bytes."""
        return n_workers * self.wire_codec(grad_k).payload_nbytes(c)

    def leaf_codec(self, tc, idx: int):
        """Wire codec for leaf ``idx`` (one codec for every leaf: the
        adaptive mode's per-leaf plans are not ported)."""
        return self.wire_codec(tc.grad_k)

    def leaf_wire_nbytes(self, tc, idx: int, c: int, n_workers: int) -> int:
        return n_workers * self.leaf_codec(tc, idx).payload_nbytes(c)

    def leaf_tier_nbytes(self, tc, idx: int, c: int, numel: int,
                         n_workers: int, tiers: Optional[Tiers]) -> dict:
        """Per-worker update-path bytes by link tier; a flat topology has
        everything on the inter tier."""
        if tiers is not None and tiers.intra_axes:
            raise NotImplementedError(
                "hierarchical tiers are not ported yet (ROADMAP.md queue 1)")
        return {"inter": self.leaf_wire_nbytes(tc, idx, c, n_workers),
                "intra": 0}


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
