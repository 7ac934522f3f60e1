"""The fp32 data-parallel Adam baseline (port of
``repro/dist/modes/dp_adam.py``): gradients all-reduced over the
workers, moments chunk-sharded (ZeRO-style), no quantized wire, K15 with
a zero EF residual.

Declared ``tiered=False``: the all-reduce is one reduction over every
worker on any topology. The objective is the local loss sum over the
GLOBAL token count (``dist.step`` all-reduces the count before the
backward in this mode), so the all-reduced gradient is the global mean's.
"""
from __future__ import annotations

import torch

from repro_torch.dist import collectives as C
from repro_torch.dist import sharding as SH
from repro_torch.dist.modes.base import ModeSpec, WorkerCtx, identity_codec
from repro_torch.opt import engine


def make_updater(tc, ctx: WorkerCtx):
    bk = ctx.backend

    def upd(g, m, v, e, chunk, meta, hp, mark=None, draw=None, idx=None):
        # the worker rows of the summed gradient, this worker's row
        rows = C.reduce_rows(SH.flatten_pad(g, ctx.n_workers), ctx.group)
        gc = rows[C.worker_index(ctx.group)]
        # K15 with a zero residual: Delta is exactly
        # alpha_t * m' / sqrt(v' + eps); m' and v' over m and v, e unread
        # and unwritten (it stays the zero chunk of the state layout)
        _, _, de = engine.adam_ef_moments(gc, m, v, torch.zeros_like(m), hp,
                                          backend=bk, out=(m, v))
        del rows, gc
        if mark:
            mark("update_exchange")
        chunk.sub_(de)
        if mark:
            mark("master_update")
        return chunk, m, v, e
    return upd


SPEC = ModeSpec(name="dp_adam", chunk_sharded_moments=True,
                make_updater=make_updater, wire_codec=identity_codec,
                tiered=False)
