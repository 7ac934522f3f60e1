"""Communication accounting of the distributed step (port of
``repro/train/loop.py`` ``comm_bytes_per_step``; the loop itself is
``repro_torch.train.session.TrainSession``)."""
from __future__ import annotations

from typing import Dict

from repro_torch.dist.modes import get_mode
from repro_torch.dist.step import TrainConfig, _leaf_meta, weight_wire_codec
from repro_torch.tree import tree_leaves


def comm_bytes_per_step(art, tc: TrainConfig) -> Dict:
    """Per-worker payload bytes of the two quantized channels (the
    paper's 'Comm' column), exact integers from the codecs: per leaf the
    mode's update-exchange codec (``ModeSpec.leaf_tier_nbytes``) plus the
    weight-broadcast codec (``dist.step.weight_wire_codec``). The float32
    scale side-channels are excluded. ``art`` needs ``layout``,
    ``n_workers`` and ``tiers`` (flat: every byte on the inter tier)."""
    mode = get_mode(tc.mode)
    leaves = tree_leaves(_leaf_meta(art.layout, art.n_workers))
    tiers = getattr(art, "tiers", None)
    ex_inter = ex_intra = 0
    for i, m in enumerate(leaves):
        d = mode.leaf_tier_nbytes(tc, i, m.c, m.numel, art.n_workers, tiers)
        ex_inter += d["inter"]
        ex_intra += d["intra"]
    bc_inter = sum(art.n_workers * weight_wire_codec(tc, m.numel)
                   .payload_nbytes(m.c) for m in leaves)
    return {"update_exchange_bytes": ex_inter,
            "weight_broadcast_bytes": bc_inter,
            "total_bytes": ex_inter + ex_intra + bc_inter,
            "shard_params": sum(m.numel for m in leaves),
            "tiers": {
                "inter": {"update_exchange": ex_inter,
                          "weight_broadcast": bc_inter,
                          "total": ex_inter + bc_inter},
                "intra": {"grad_reduce": ex_intra, "weight_broadcast": 0,
                          "total": ex_intra},
            }}
