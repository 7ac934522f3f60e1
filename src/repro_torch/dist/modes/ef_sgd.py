"""The blockwise-EF momentum SGD baseline (Zheng et al. '19; port of
``repro/dist/modes/ef_sgd.py``): sign codes with per-256-block mean |.|
scales (#14), error feedback on the residual. The wire is
``base.blockwise_exchange``.

The momentum and Delta+e are plain tensor operations, as the reference
computes them outside any kernel, each rounded once (no fused
multiply-add): ``m' = beta * m + g``, ``Delta + e = alpha_t * m' + e``.
"""
from __future__ import annotations

import torch

from repro_torch.comm import codec as CD
from repro_torch.dist.modes.base import (ModeSpec, WorkerCtx,
                                         blockwise_exchange, ctx_groups,
                                         ctx_tiers, tier_grad_mean,
                                         worker_mean)

BLOCK = 256


def wire_codec(grad_k=None):
    return CD.BlockwiseCodec(block=BLOCK)


def make_updater(tc, ctx: WorkerCtx):
    codec = wire_codec()
    tiers = ctx_tiers(ctx)
    groups = ctx_groups(ctx)

    def upd(g, m, v, e, chunk, meta, hp, mark=None, draw=None, idx=None):
        g = tier_grad_mean(g, tiers, groups.intra)
        m.mul_(hp[1]).add_(g)                  # m' = beta * m + g
        de = torch.mul(m, hp[0]).add_(e)       # alpha_t * m' + e
        recv, e2 = blockwise_exchange(de, codec, meta, ctx, tiers)
        e.copy_(e2)
        del de, e2
        mean = worker_mean(recv)
        if mark:
            mark("update_exchange")
        chunk.sub_(mean)
        if mark:
            mark("master_update")
        return chunk, m, v, e
    return upd


SPEC = ModeSpec(name="ef_sgd", chunk_sharded_moments=False,
                make_updater=make_updater, wire_codec=wire_codec)
