"""Host-side replan loop for adaptive quantization (port of
``repro/adapt/controller.py``).

The controller owns a ``TrainSession`` running the ``adaptive`` mode and,
every ``replan_every`` steps:

  1. harvests the device stats ring (ONE host sync a window, the loss
     ring's discipline: no steady-state sync is added),
  2. folds the rows into a :class:`repro_torch.adapt.stats.StatsEMA`,
  3. re-solves the bit plan (:mod:`repro_torch.adapt.allocate`) under
     the byte budget from the observed amax / meansq history,
  4. on a plan change, builds the step for the new
     ``TrainConfig.bit_plan`` and ``swap_artifacts``-es it in. The state
     (masters, Adam moments, EF residuals) carries over bitwise: a replan
     changes only the wire. On the card the new plan is captured as a new
     CUDA graph after one eager window dispatch (the session releases the
     old plan's graph first), so a revisited plan is captured again.

Windows end at multiples of ``replan_every`` of the global step, and
the controller takes the session's checkpoints itself: at a checkpoint
step it harvests the stats first (and replans, on a window's end), so
the manifest carries the EMA of every step before it and the plan that
goes on from it, and a resumed run is bitwise an unbroken one wherever
it stopped. (The reference's session writes a boundary's checkpoint
before the window's harvest.)

``measured_exchange_bytes`` re-derives the exchange's bytes from real
encoded payloads (#5 or #14 + #9 on the card), leaf by leaf: the check
behind ``--adapt-verify`` and the accounting tests, where the codecs'
``comm_bytes_per_step`` must equal it exactly (on a hierarchical
topology: the ``n_inter`` rows a leaf that cross the slow tier, and
``measured_tier_bytes`` every tier). Leaf indices, plans and
stats rows follow the reference's leaf order (dict keys sorted), so a
plan or a stats history crosses between the two programs as it is.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.adapt import allocate as A
from repro_torch.adapt import stats as S
from repro_torch.comm import bits as B
from repro_torch.comm import codec as CD
from repro_torch.tree import sorted_leaf_index, tree_leaves


@dataclasses.dataclass
class AdaptConfig:
    budget_ratio: float = 0.6   # exchange byte budget vs fixed log:6
    replan_every: int = 25      # steps between replan boundaries
    ema_decay: float = 0.8      # StatsEMA decay per harvested step
    baseline_width: int = 4     # the fixed lane the budget is quoted vs


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k, v in tree.items() for p in _paths(v, prefix + (k,))]
    return [prefix]


def _ref_order(art) -> List[int]:
    """Port leaf index of each reference leaf index."""
    idx = sorted_leaf_index(art.layout.shapes)
    order = [0] * len(idx)
    for i, r in enumerate(idx):
        order[r] = i
    return order


def _leaf_names(art) -> List[str]:
    """The leaves' names in the reference's order and form
    (``jax.tree_util.keystr``: ``['blocks']['attn']['k']``)."""
    paths = _paths(art.layout.shapes)
    return ["".join(f"['{k}']" for k in paths[i]) for i in _ref_order(art)]


def _ref_metas(art):
    """The step's ``LeafMeta``s in the reference's leaf order."""
    from repro_torch.dist.step import _leaf_meta
    metas = tree_leaves(_leaf_meta(art.layout, art.n_workers))
    return [metas[i] for i in _ref_order(art)]


def leaf_groups_for(art, ema: Optional[S.StatsEMA] = None) -> List[A.Group]:
    """Allocation groups for the artifacts' state leaves (the reference's
    leaf order). Without an EMA (pre-run planning) a uniform prior is
    used: every leaf amax = 1, meansq = 1, so allocation splits on wire
    geometry alone."""
    snap = ema.snapshot() if ema is not None else None
    groups = []
    for i, (name, m) in enumerate(zip(_leaf_names(art), _ref_metas(art))):
        amax, meansq = (1.0, 1.0) if snap is None \
            else (float(snap[i, 0]), float(snap[i, 1]))
        groups.append(A.Group(name=name, numel=m.numel, c=m.c, amax=amax,
                              meansq=meansq))
    return groups


def solve_plan(groups: List[A.Group], n_workers: int,
               acfg: AdaptConfig) -> Tuple[Tuple[str, ...], int, int]:
    """(specs, budget_bytes, baseline_bytes) for one replan."""
    baseline = A.baseline_cost(groups, n_workers, acfg.baseline_width)
    budget = int(acfg.budget_ratio * baseline)
    return A.allocate_specs(groups, budget, n_workers), budget, baseline


def plan_report(groups: List[A.Group], specs: Tuple[str, ...],
                n_workers: int) -> List[Dict[str, Any]]:
    """Per-leaf rows for logs: spec, width, exact exchange bytes."""
    rows = []
    for g, spec in zip(groups, specs):
        codec = CD.get_codec(spec)
        rows.append({"leaf": g.name, "numel": g.numel, "c": g.c,
                     "spec": spec, "bits": codec.bits,
                     "a2a_bytes": n_workers * codec.payload_nbytes(g.c)})
    return rows


def plan_for_model(model, group, tc, *, budget_ratio: float = 0.6,
                   ema: Optional[S.StatsEMA] = None):
    """One-shot (pre-run) plan: build adaptive artifacts, solve under the
    uniform prior (or a given EMA), and return ``(tc2, art2, report)``
    with ``tc2.bit_plan`` set and ``art2`` the step for it."""
    from repro_torch.dist.step import make_train_step
    acfg = AdaptConfig(budget_ratio=budget_ratio)
    tc1 = dataclasses.replace(tc, mode="adaptive", bit_plan=None)
    art1 = make_train_step(model, group, tc1)
    groups = leaf_groups_for(art1, ema)
    specs, budget, baseline = solve_plan(groups, art1.n_workers, acfg)
    tc2 = dataclasses.replace(tc1, bit_plan=specs)
    art2 = make_train_step(model, group, tc2)
    report = plan_report(groups, specs, art2.n_workers)
    return tc2, art2, {"rows": report, "budget_bytes": budget,
                       "baseline_bytes": baseline,
                       "plan_bytes": sum(r["a2a_bytes"] for r in report)}


def _hier_tiers(art, mode):
    """The artifacts' tiers where the mode exchanges over them (None for
    the flat topology and for a mode that is not tiered, dp_adam)."""
    tiers = getattr(art, "tiers", None)
    if mode.tiered and tiers is not None and tiers.hierarchical:
        return tiers
    return None


def _leaf_payload_nbytes(art, tc, mode, m, idx: int, n_src: int,
                         device) -> int:
    """Measured exchange payload bytes of one leaf: a real tensor of its
    numel encoded with its plan codec into the worker rows, of which the
    ``n_src`` rows that cross the exchange tier are counted (all
    ``n_workers`` flat, ``n_inter`` hierarchical; rows are byte-aligned,
    so the slice is the wire array)."""
    codec = mode.leaf_codec(tc, idx)
    if isinstance(codec, CD.IdentityCodec):
        return n_src * m.c * 4
    x = torch.linspace(-1.0, 1.0, m.numel, dtype=torch.float32,
                       device=device)
    if isinstance(codec, CD.BlockwiseCodec):
        from repro_torch.comm import kernels as K
        from repro_torch.opt import engine
        codes2d, _ = engine.quantize_blockwise(x, codec.block)     # #14
        del x
        rows = B.pad_rows(codes2d.reshape(-1)[:m.numel], art.n_workers)
        return K.pack_rows(rows, codec.bits)[:n_src].nbytes        # #9
    u = torch.zeros_like(x) if codec.stochastic else None
    payload, _ = CD.encode_rows(x, codec, art.n_workers, u=u)      # #5
    return payload[:n_src].nbytes


def measured_exchange_bytes(art, tc, device=None) -> int:
    """Measured per-worker exchange payload bytes on the exchange tier:
    each leaf encoded with its plan codec and the wire arrays' ``nbytes``
    summed, the ground truth ``comm_bytes_per_step(...)
    ["update_exchange_bytes"]`` must equal. On a hierarchical topology
    only the ``n_inter`` rows a leaf that cross the slow tier count.
    ``device``: where to encode (default: the CPU)."""
    from repro_torch.dist.modes import get_mode
    mode = get_mode(tc.mode)
    tiers = _hier_tiers(art, mode)
    n_src = tiers.n_inter if tiers is not None else art.n_workers
    device = device or "cpu"
    return sum(_leaf_payload_nbytes(art, tc, mode, m, i, n_src, device)
               for i, m in enumerate(_ref_metas(art)))


def measured_tier_bytes(art, tc, device=None) -> Dict[str, Dict[str, int]]:
    """Measured per-tier wire bytes from real buffers' ``nbytes``, the
    counterpart of ``comm_bytes_per_step(...)["tiers"]``: the exchange
    re-encodes every leaf (:func:`measured_exchange_bytes`); the intra
    tier's gradient reduce makes the float32 buffer it gathers
    (``n_intra`` rows of the shard); the broadcast encodes one real chunk
    a leaf with the weight wire's codec and counts it by the per-tier
    fan-out of the inter-first gather."""
    from repro_torch.dist.modes import get_mode
    from repro_torch.dist.step import weight_wire_codec
    mode = get_mode(tc.mode)
    tiers = _hier_tiers(art, mode)
    n_src = tiers.n_inter if tiers is not None else art.n_workers
    device = device or "cpu"
    ex_inter = ex_intra = bc_inter = bc_intra = 0
    for i, m in enumerate(_ref_metas(art)):
        ex_inter += _leaf_payload_nbytes(art, tc, mode, m, i, n_src, device)
        if tiers is not None:
            ex_intra += torch.zeros((tiers.n_intra, m.numel),
                                    dtype=torch.float32,
                                    device="meta").nbytes
        wc = weight_wire_codec(tc, m.full_numel)
        if isinstance(wc, CD.IdentityCodec):
            p = m.c * 4
        else:
            payload, _ = CD.encode_rows(
                torch.linspace(-1.0, 1.0, m.c, dtype=torch.float32,
                               device=device), wc, 1)
            p = payload.nbytes
        if tiers is not None:
            bc_inter += tiers.n_inter * p
            bc_intra += tiers.n_intra * tiers.n_inter * p
        else:
            bc_inter += art.n_workers * p
    return {"inter": {"update_exchange": ex_inter,
                      "weight_broadcast": bc_inter,
                      "total": ex_inter + bc_inter},
            "intra": {"grad_reduce": ex_intra,
                      "weight_broadcast": bc_intra,
                      "total": ex_intra + bc_intra}}


def verify_accounting(art, tc, device=None) -> Dict[str, Any]:
    """Assert the codecs' accounting == the measured payload bytes, the
    exchange figure and every per-tier entry; returns both (raises
    AssertionError on a mismatch)."""
    from repro_torch.train.loop import comm_bytes_per_step
    booked = comm_bytes_per_step(art, tc)
    accounted = booked["update_exchange_bytes"]
    measured = measured_exchange_bytes(art, tc, device)
    assert accounted == measured, \
        f"accounted {accounted} != measured {measured} exchange bytes"
    mtiers = measured_tier_bytes(art, tc, device)
    assert booked["tiers"] == mtiers, \
        f"accounted tiers {booked['tiers']} != measured {mtiers}"
    return {"accounted": accounted, "measured": measured, "tiers": mtiers}


class AdaptiveController:
    """Drives an adaptive ``TrainSession``: windowed run / harvest /
    replan. Used like a session::

        ctl = AdaptiveController(model, group, tc, batches, acfg, scfg)
        ctl.run(steps)
        ctl.close()

    ``plan_log`` records one entry per plan segment: the step it took
    effect, the specs, and the codecs' accounting at that plan (and the
    measured bytes with ``verify``). ``device``: where the state lives
    (the card unless the caller asks for the CPU)."""

    def __init__(self, model, group, tc, batches, acfg: AdaptConfig,
                 scfg=None, *, seed: int = 0, device="cuda", state=None,
                 log=print, verify: bool = False):
        from repro_torch.dist.step import make_train_step
        from repro_torch.train.loop import comm_bytes_per_step
        from repro_torch.train.session import SessionConfig, TrainSession
        self._comm_bytes = comm_bytes_per_step
        self._make_step = make_train_step
        self.model, self.group = model, group
        self.acfg = acfg
        self.verify = verify
        self._log = log
        self.tc = dataclasses.replace(tc, mode="adaptive")
        self.art = make_train_step(model, group, self.tc)
        scfg = scfg or SessionConfig(log_every=0)
        # checkpoints are taken here, after the harvest at their step
        self._ckpt_every = scfg.ckpt_every if scfg.ckpt_dir else 0
        scfg = dataclasses.replace(
            scfg, stats_ring=max(scfg.stats_ring, acfg.replan_every),
            ckpt_every=0)
        self.session = TrainSession.from_artifacts(
            self.art, batches, scfg, seed=seed, state=state, device=device,
            log=log)
        self.device = self.session._device
        self.ema = S.StatsEMA(len(tree_leaves(self.art.layout.shapes)),
                              acfg.ema_decay)
        self.plan_log: List[Dict[str, Any]] = []
        self.replans = 0
        self._record_plan(0)
        self._sync_ckpt_extra()

    def _sync_ckpt_extra(self):
        """Mirror the live plan and EMA into ``session.ckpt_extra``, so
        every checkpoint carries them and ``resume`` replans from the
        history an unbroken run would have had."""
        self.session.ckpt_extra["bit_plan"] = (
            list(self.tc.bit_plan) if self.tc.bit_plan else None)
        self.session.ckpt_extra["adapt_ema"] = (
            self.ema.state_dict() if self.ema.count > 0.0 else None)

    def _swap(self, plan, step: int):
        self.tc = dataclasses.replace(self.tc, bit_plan=plan)
        self.art = self._make_step(self.model, self.group, self.tc)
        self.session.swap_artifacts(self.art)
        self._record_plan(step)

    def resume(self, ckpt_dir: Optional[str] = None) -> int:
        """Restore an adaptive run: the checkpointed bit plan and stats
        EMA from the manifest's extra, the step for that plan swapped in,
        then the state and stream position (``TrainSession.resume``).
        Returns the restored step (0 when there is no checkpoint). Must
        precede ``run()``."""
        from repro_torch.checkpoint import store
        d = ckpt_dir or self.session.cfg.ckpt_dir
        if not d:
            raise ValueError("no checkpoint directory given")
        found = store.latest_step(d)
        if found is None:
            return 0
        extra = store.read_extra(d, step=found)
        plan = extra.get("bit_plan")
        plan = tuple(plan) if plan else None
        if plan != self.tc.bit_plan:
            self._swap(plan, found)
        if extra.get("adapt_ema"):
            self.ema = S.StatsEMA.from_state(extra["adapt_ema"])
        out = self.session.resume(d, step=found)
        # the checkpoint holds the EMA of every step up to it; at a
        # window's end the unbroken run replanned from that EMA (a no-op
        # where it did so before the checkpoint), inside a window it
        # goes on with the plan it has
        if found % self.acfg.replan_every == 0:
            self.replan()
        self._sync_ckpt_extra()
        return out

    def _record_plan(self, step: int):
        entry = {"step": step, "bit_plan": self.tc.bit_plan,
                 "comm": self._comm_bytes(self.art, self.tc)}
        if self.verify:
            entry["verify"] = verify_accounting(self.art, self.tc,
                                                self.device)
        self.plan_log.append(entry)

    def replan(self) -> bool:
        """Re-solve from the EMA; swap the step when the plan moved.
        Returns True when a swap happened."""
        if self.ema.count <= 0.0:
            return False
        groups = leaf_groups_for(self.art, self.ema)
        specs, _, _ = solve_plan(groups, self.art.n_workers, self.acfg)
        if specs == self.tc.bit_plan:
            return False
        self._swap(specs, self.session.step)
        self.replans += 1
        self._sync_ckpt_extra()
        self._log(f"  replan @{self.session.step}: "
                  f"{self.plan_log[-1]['comm']['update_exchange_bytes']} "
                  f"a2a B/step")
        return True

    def run(self, steps: int):
        """Run ``steps`` optimizer steps with a replan boundary at every
        multiple of ``acfg.replan_every`` (one harvest sync each) and a
        checkpoint at every multiple of the session's ``ckpt_every``."""
        every, ck = self.acfg.replan_every, self._ckpt_every
        end = self.session.step + steps
        while self.session.step < end:
            t = self.session.step
            stop = min(end, (t // every + 1) * every)
            if ck:
                stop = min(stop, (t // ck + 1) * ck)
            self.session.run(stop - t)
            for _, rows in self.session.harvest_stats():
                self.ema.update(rows)
            if stop % every == 0 and stop < end:
                self.replan()
            self._sync_ckpt_extra()
            if ck and stop % ck == 0:
                self.session.checkpoint()
        return self.session.history

    @property
    def state(self):
        return self.session.state

    @property
    def stats(self):
        return self.session.stats

    def close(self):
        self.session.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

