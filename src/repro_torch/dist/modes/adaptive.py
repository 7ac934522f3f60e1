"""Adaptive mode (port of ``repro/dist/modes/adaptive.py``): qadam's
Adam+EF math with a per-leaf wire plan.

Each leaf rides the codec named by ``tc.bit_plan[idx]`` (registry specs
from :mod:`repro_torch.adapt.allocate`, ``idx`` the reference's leaf
order; a new plan is a new ``make_train_step``, swapped into the session
at a replan boundary). Scalar-scale lanes (log, uniform_amax) take
qadam's wire: K15 for the moments and Delta+e, whose folded amax is the
lane's scale (bitwise the codec's ``compute_scale``), K7 to payload rows
with the residual written over e, the all-to-all, and K6 on receipt.
2-bit blockwise lanes take ef_sgd's sign-code exchange with its
per-block scale side channel (#14, #9; ``base.blockwise_exchange``) but
keep qadam's Adam moments and carry the true EF residual
``de - deq(own codes)``.

The updater also returns one :mod:`repro_torch.adapt.stats` row per leaf
(``emits_stats``): the step reduces the rows across workers and the
session keeps them in its device stats ring, harvested by the controller
at replan boundaries, so steady state adds no host sync.

Without a ``bit_plan`` the mode is qadam (every leaf on ``log:grad_k``),
which is what a fresh adaptive session runs before its first replan.
"""
from __future__ import annotations

from repro_torch.adapt import stats as astats
from repro_torch.comm import codec as CD
from repro_torch.dist import collectives as C
from repro_torch.dist.modes import qadam
from repro_torch.dist.modes.base import (ModeSpec, WorkerCtx,
                                         blockwise_exchange, ctx_groups,
                                         ctx_tiers, tier_grad_mean,
                                         worker_mean)
from repro_torch.kernels import adam_ef as AK
from repro_torch.opt import engine


def leaf_codec(tc, idx: int):
    """The wire codec of leaf ``idx`` (the reference's leaf order)."""
    if getattr(tc, "bit_plan", None) is not None:
        return CD.get_codec(tc.bit_plan[idx])
    return qadam.wire_codec(tc.grad_k if tc.grad_k is not None else 6)


def make_updater(tc, ctx: WorkerCtx):
    tiers = ctx_tiers(ctx)
    groups = ctx_groups(ctx)
    bk = ctx.backend

    def upd(g, m, v, e, chunk, meta, hp, mark=None, draw=None, idx=None):
        codec = leaf_codec(tc, idx)
        g = tier_grad_mean(g, tiers, groups.intra)
        # K15: m', v' over m, v; Delta+e and its folded max |Delta+e|
        _, _, de, amax = AK.adam_moments(g, m, v, e, hp, backend=bk,
                                         out=(m, v))
        row = astats.local_stats(de, g, amax=amax)
        if isinstance(codec, CD.BlockwiseCodec):
            # #14 sign codes and block scales, #9 lanes, the residual
            # against this worker's own codes
            recv, e2 = blockwise_exchange(de, codec, meta, ctx, tiers)
            e.copy_(e2)
            del e2
        else:
            scale = (codec.compute_scale(de, backend=bk)
                     if codec.static_scale is not None
                     else engine.amax_scale(amax))
            # K7: codes to payload rows, e' over e
            payload, _ = CD.encode_rows_ef(de, scale, codec, ctx.n_workers,
                                           backend=bk, out=e)
            # all_to_all, the source scales, K6
            recv = C.exchange_decode_tiered(payload, scale, codec, meta.c,
                                            tiers, groups, backend=bk)
        del de
        if not tc.error_feedback:
            e.zero_()
        mean = worker_mean(recv)
        if mark:
            mark("update_exchange")
        chunk.sub_(mean)
        if mark:
            mark("master_update")
        return chunk, m, v, e, row
    return upd


SPEC = ModeSpec(name="adaptive", chunk_sharded_moments=False,
                make_updater=make_updater, wire_codec=qadam.wire_codec,
                per_leaf=leaf_codec, emits_stats=True)
