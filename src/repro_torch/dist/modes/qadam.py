"""The paper's mode (Algorithms 2+3; port of ``repro/dist/modes/qadam.py``):
Adam+EF per worker (K15), log-grid Q_g codes on the update-exchange wire
(K7 straight to payload rows, K6 on receipt)."""
from __future__ import annotations

from repro_torch.comm import codec as CD
from repro_torch.dist import collectives as C
from repro_torch.dist import sharding as SH
from repro_torch.dist.modes.base import (ModeSpec, WorkerCtx, ctx_groups,
                                         ctx_tiers, tier_grad_mean,
                                         worker_mean)
from repro_torch.opt import engine


def wire_codec(grad_k=None):
    """Log-grid codec packed to its lane width; identity (f32 rows) when
    the wire is unquantized."""
    if grad_k is None:
        return CD.IdentityCodec()
    return CD.LogCodec(k_g=grad_k)


def make_updater(tc, ctx: WorkerCtx):
    codec = wire_codec(tc.grad_k)
    tiers = ctx_tiers(ctx)
    groups = ctx_groups(ctx)
    bk = ctx.backend

    def upd(g, m, v, e, chunk, meta, hp, mark=None, draw=None, idx=None):
        # hierarchical: the node-mean float32 gradient first; the
        # exchange then ships one row a node over the slow tier
        g = tier_grad_mean(g, tiers, groups.intra)
        # K15: m', v' over m, v; Delta+e; the scale from its on-device
        # max|Delta+e| fold (bitwise grids.amax_scale(Delta+e))
        de, scale = engine.adam_ef_delta(g, m, v, e, hp, backend=bk)
        if tc.grad_k is None:
            recv = C.exchange_rows_tiered(
                SH.flatten_pad(de, ctx.n_workers), tiers, groups)
            e.zero_()
        else:
            # K7: codes to payload rows, e' over e
            payload, _ = CD.encode_rows_ef(de, scale, codec, ctx.n_workers,
                                           backend=bk, out=e)
            if not tc.error_feedback:
                e.zero_()
            del de
            # all_to_all, the source scales, K6
            recv = C.exchange_decode_tiered(payload, scale, codec, meta.c,
                                            tiers, groups, backend=bk)
        mean = worker_mean(recv)
        if mark:
            mark("update_exchange")
        chunk.sub_(mean)
        if mark:
            mark("master_update")
        return chunk, m, v, e
    return upd


SPEC = ModeSpec(name="qadam", chunk_sharded_moments=False,
                make_updater=make_updater, wire_codec=wire_codec)
