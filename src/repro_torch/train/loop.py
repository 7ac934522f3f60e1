"""The training loop's compat surface and the communication accounting
(port of ``repro/train/loop.py``).

The loop itself is ``repro_torch.train.session.TrainSession`` (prefetch,
device-resident losses, checkpoints, resume, scan chunks); ``train()`` is
the reference's thin shim over one session run. ``comm_bytes_per_step``
(the paper's 'Comm' column) is loop-independent accounting over the
step's artifacts."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, Optional

from repro_torch.dist.modes import get_mode
from repro_torch.dist.step import TrainConfig, _leaf_meta, weight_wire_codec
from repro_torch.train.session import SessionConfig, TrainSession
from repro_torch.tree import sorted_leaf_index, tree_leaves


@dataclasses.dataclass
class LoopConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 0            # 0 = never
    ckpt_dir: Optional[str] = None
    eval_every: int = 0
    eval_fn: Optional[Callable] = None
    # > 1: this many steps a dispatch (a CUDA graph on the card); the
    # checkpoint, eval and log cadences must be multiples of it
    scan_chunk: int = 1
    prefetch: int = 2              # staged dispatches; 0 = inline pulls


def comm_bytes_per_step(art, tc: TrainConfig) -> Dict:
    """Per-worker payload bytes of the two quantized channels (the
    paper's 'Comm' column), exact integers from the codecs: per leaf the
    mode's update-exchange codec (``ModeSpec.leaf_tier_nbytes``; a
    per-leaf plan's codec of that leaf, so the figure follows every
    replan) plus the weight-broadcast codec
    (``dist.step.weight_wire_codec``). The float32 scale side-channels
    (one per leaf and worker; one per 256-block on the blockwise lanes)
    are excluded. ``art`` needs ``layout``, ``n_workers`` and ``tiers``.

    ``"tiers"`` splits every figure by link tier: a flat topology has
    every byte on ``inter``; a hierarchical one moves ``n_inter`` payload
    rows a leaf across the slow tier (``update_exchange_bytes`` falls by
    exactly ``1/n_intra``), adds the float32 gradient pre-reduce under
    ``intra.grad_reduce``, and splits the broadcast's inter-first gather
    (each chunk crosses the slow tier once a node, then fans out within
    it). Per model shard: the figures are one rank's."""
    mode = get_mode(tc.mode)
    leaves = tree_leaves(_leaf_meta(art.layout, art.n_workers))
    ref_index = sorted_leaf_index(art.layout.shapes)
    tiers = getattr(art, "tiers", None)
    hier = mode.tiered and tiers is not None and tiers.hierarchical
    ex_inter = ex_intra = 0
    for i, m in enumerate(leaves):
        d = mode.leaf_tier_nbytes(tc, ref_index[i], m.c, m.numel,
                                  art.n_workers, tiers)
        ex_inter += d["inter"]
        ex_intra += d["intra"]
    bc_inter = bc_intra = 0
    for m in leaves:
        p = weight_wire_codec(tc, m.full_numel).payload_nbytes(m.c)
        if hier:
            bc_inter += tiers.n_inter * p
            bc_intra += tiers.n_intra * tiers.n_inter * p
        else:
            bc_inter += art.n_workers * p
    bcast = bc_inter + bc_intra
    return {"update_exchange_bytes": ex_inter,
            "weight_broadcast_bytes": bcast,
            "total_bytes": ex_inter + ex_intra + bcast,
            "shard_params": sum(m.numel for m in leaves),
            "tiers": {
                "inter": {"update_exchange": ex_inter,
                          "weight_broadcast": bc_inter,
                          "total": ex_inter + bc_inter},
                "intra": {"grad_reduce": ex_intra,
                          "weight_broadcast": bc_intra,
                          "total": ex_intra + bc_intra},
            }}


def train(art, tc: TrainConfig, batches: Iterator, lc: LoopConfig, *,
          seed: int = 0, state=None, device="cuda", log=print):
    """One ``TrainSession`` run of ``lc.steps`` steps over
    ``dist.step`` artifacts; returns ``(state, history)``, evals in their
    own ``{"step", "eval"}`` entries. ``tc`` is ``art``'s configuration
    (the reference's signature)."""
    cfg = SessionConfig(log_every=lc.log_every, ckpt_every=lc.ckpt_every,
                        ckpt_dir=lc.ckpt_dir, eval_every=lc.eval_every,
                        eval_fn=lc.eval_fn, scan_chunk=lc.scan_chunk,
                        prefetch=lc.prefetch)
    sess = TrainSession.from_artifacts(art, batches, cfg, seed=seed,
                                       state=state, device=device, log=log)
    try:
        sess.run(lc.steps)
    finally:
        sess.close()
    return sess.state, sess.history
