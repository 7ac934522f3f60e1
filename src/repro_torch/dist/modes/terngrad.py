"""The TernGrad baseline (Wen et al. '17; port of
``repro/dist/modes/terngrad.py``): unbiased stochastic ternary SGD, 2-bit
codes on the wire (#5 ternary, then the all-to-all and K6 ternary with
each source's scale), no error feedback, no moments."""
from __future__ import annotations

from repro_torch.comm import codec as CD
from repro_torch.dist import collectives as C
from repro_torch.dist.modes.base import (ModeSpec, WorkerCtx, ctx_groups,
                                         ctx_tiers, tier_grad_mean,
                                         worker_mean)


def wire_codec(grad_k=None):
    return CD.TernaryCodec()


def make_updater(tc, ctx: WorkerCtx):
    codec = wire_codec()
    tiers = ctx_tiers(ctx)
    groups = ctx_groups(ctx)
    bk = ctx.backend

    def upd(g, m, v, e, chunk, meta, hp, mark=None, draw=None, idx=None):
        g = tier_grad_mean(g, tiers, groups.intra)
        # the uniforms of this (step, leaf, worker), read by #5 at g's
        # flat index
        payload, scale = CD.encode_rows(g, codec, ctx.n_workers,
                                        u=draw(g.numel()), backend=bk)
        recv = C.exchange_decode_tiered(payload, scale, codec, meta.c,
                                        tiers, groups, backend=bk)
        step = hp[0] * worker_mean(recv)
        del payload, recv
        if mark:
            mark("update_exchange")
        chunk.sub_(step)
        if mark:
            mark("master_update")
        return chunk, m, v, e
    return upd


SPEC = ModeSpec(name="terngrad", chunk_sharded_moments=False,
                make_updater=make_updater, wire_codec=wire_codec)
