"""Distributed QAdam-EF train step (Algorithms 2+3; port of
``repro/dist/step.py``): a quantized parameter server over the ranks of
a ``torch.distributed`` process group, one model shard, for the paper's
``qadam`` mode, the baselines (``dp_adam``, ``efadam``, ``terngrad``,
``ef_sgd``) and the ``adaptive`` mode's per-leaf wire plans
(``repro_torch.dist.modes``).

One step on each rank (worker):

  1. weight broadcast: every server Q_x-encodes its master chunk (K3
     first where the scale is an amax; K7 uniform), the payloads are
     all-gathered and every worker K6-decodes Q_x(x_t) for the whole
     model (small leaves ride float32 rows). Modes with ``broadcast_ef``
     (``efadam``) send ``Q_x(chunk + es)`` and keep K7's residual as
     the next ``es``;
  2. forward and backward at Q_x(x_t) (Assumption 3) through
     ``Model.loss``: each worker gets the gradient of its own mean loss
     (``dp_adam``: of its loss sum over the global token count);
  3. the mode's update (``repro_torch.dist.modes``; the paper's
     ``qadam``: K15 Adam+EF, K7 log codes to payload rows; stochastic
     codecs draw their uniforms from :func:`draw_uniform`);
  4. the update exchange: all-to-all of the payload rows, K6 decode of
     every worker's codes for this server's chunk with that worker's
     scale, and ``chunk - worker_mean(rows)`` into the master chunk;

and the global loss as sum(s) / sum(n) over workers, one ``all_reduce``
of a 2-vector on the device. Modes with ``emits_stats`` (``adaptive``)
also return ``gstats``: one ``adapt.stats`` row per leaf, stacked in
the reference's leaf order and reduced over the workers (two
``all_reduce``s), on the device. No step reads the device on the host: the
step count, alpha_t and theta_t live on the host.

State per rank (the reference's chunked layout, this rank's slice, each
leaf flat): ``master`` this worker's float32 chunk (c elements) of every
leaf, ``m``, ``v``, ``e`` its moments and EF residual over the whole
leaf (over its chunk where the mode's ``chunk_sharded_moments``), the
mode's ``extra_state`` leaves (chunk-sized: ``efadam``'s ``es``), and the
host step ``count``. The step updates them in place (the reference
donates these buffers).

Batches: the global batch's rows are split over the workers when the
batch divides by their number (worker w takes rows [w*B/W, (w+1)*B/W)),
else every worker takes the whole batch, as ``_batch_geometry``.

Out of scope (raise ``NotImplementedError``, ROADMAP.md queue 1):
``HierarchicalTopology``, a model axis and ``model_gather_quant``. The reference's exchange buckets are XLA
scheduling fences that change no number; the overlap of the exchange
with the backward they allow is queued in ROADMAP.md.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.adapt import stats as astats
from repro_torch.comm import codec as CD
from repro_torch.core.qadam import QAdamConfig, _alpha_t, _theta_t
from repro_torch.core.uniforms import draw_uniform
from repro_torch.dist import collectives as C
from repro_torch.dist import sharding as SH
from repro_torch.dist import topology as T
from repro_torch.dist.modes import WorkerCtx, get_mode
from repro_torch.opt import engine, grids
from repro_torch.tree import (sorted_leaf_index, tree_leaves, tree_map,
                              tree_unflatten)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    alpha: float = 1e-3
    beta: float = 0.99
    theta: float = 0.999
    eps: float = 1e-5
    schedule: str = "constant"          # "sqrt" | "constant" | "halving:K"
    grad_k: Optional[int] = 6           # log-grid k_g; None = f32 wire
    weight_k: Optional[int] = None      # uniform k_x; None = f32 broadcast
    weight_absolute: bool = True        # paper's absolute [-0.5,0.5] grid
    weight_q_min_numel: int = 2 ** 14   # small leaves skip Q_x (norms)
    error_feedback: bool = True
    mode: str = "qadam"
    topology: T.Topology = T.FlatTopology()      # only flat is ported
    model_gather_quant: Optional[int] = None     # not ported
    seed: int = 0                       # the stochastic codecs' draws
    # adaptive mode: one codec spec per leaf, in the reference's leaf
    # order (keys sorted); None = every leaf on log:grad_k
    bit_plan: Optional[Tuple[str, ...]] = None
    # kernels' implementation: "cuda" | "torch" (the plain versions) |
    # None = by the tensors' device
    backend: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class LeafMeta:
    """Per-leaf wire geometry: the leaf's ``shape`` (one model shard is
    the whole leaf), its element count ``numel`` and the per-worker chunk
    length ``c``."""

    shape: Tuple[int, ...]
    c: int
    numel: int


def _leaf_meta(layout: SH.Layout, n_workers: int):
    """Tree of LeafMeta mirroring the parameter tree."""
    def one(shape):
        n = math.prod(shape)
        return LeafMeta(shape=tuple(shape), c=SH.chunk_size(n, n_workers),
                        numel=n)
    return tree_map(one, layout.shapes)


class StepArtifacts(NamedTuple):
    """``step_fn(state, batch)`` is ``broadcast`` -> ``loss_and_grads`` ->
    ``update``; the three are exposed for measurement and checks."""

    init_state: Callable
    step_fn: Callable
    layout: SH.Layout
    n_workers: int
    rank: int
    group: Any
    config: Any
    tiers: Any
    broadcast: Callable        # state -> [Q_x(x_t) leaf, ...]
    loss_and_grads: Callable   # (xs, batch) -> (global loss, [grad, ...])
    update: Callable           # (state, grads) -> state
    # hp_row(t) -> (alpha_t, beta, theta_t, eps) of step t: what
    # ``update`` and ``step_fn`` turn into their (4,) device row when no
    # ``hp`` is given (a K-step dispatch fills a static table from it and
    # passes the rows)
    hp_row: Optional[Callable] = None
    # prepare(device): make the device tables the exchange's codecs read,
    # outside any CUDA graph capture (a session calls it at a plan swap)
    prepare: Optional[Callable] = None


def weight_wire_codec(tc: TrainConfig, numel: int):
    """The weight-broadcast channel's codec for a leaf of ``numel``
    elements, the one source of what moves on channel 2
    (``comm_bytes_per_step`` reads it too). Small or unquantized leaves
    ride float32 (identity)."""
    if tc.weight_k is None or numel < tc.weight_q_min_numel:
        return CD.IdentityCodec()
    return CD.uniform_wire_codec(tc.weight_k, tc.weight_absolute)


def local_batch(batch: Dict[str, torch.Tensor], rank: int,
                n_workers: int) -> Dict[str, torch.Tensor]:
    """This worker's rows of the global batch (``_batch_geometry``): a
    slice of B / W rows when B divides by W, else the whole batch. B is
    read from ``tokens``, or from ``embeds`` for an embedding-input
    model."""
    B = batch["tokens" if "tokens" in batch else "embeds"].shape[0]
    if B % n_workers or n_workers == 1:
        return batch
    b = B // n_workers
    return {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}


def _check_supported(tc: TrainConfig) -> None:
    if not isinstance(tc.topology, T.FlatTopology):
        raise NotImplementedError(
            f"{type(tc.topology).__name__} is not ported yet (ROADMAP.md "
            "queue 1); the port runs the flat topology")
    if tc.model_gather_quant is not None:
        raise NotImplementedError(
            "model_gather_quant (a quantized gather over a model axis) is "
            "not ported yet (ROADMAP.md queue 1)")


def make_train_step(model, group, tc: TrainConfig) -> StepArtifacts:
    """The distributed step of ``tc.mode`` over the ranks of ``group``
    (``repro_torch.launch.mesh.make_process_group``): ``init_state`` and
    ``step_fn(state, batch) -> (state, {"loss"})``."""
    mode = get_mode(tc.mode)      # raises for the modes not ported
    _check_supported(tc)
    n_workers = dist.get_world_size(group)
    rank = dist.get_rank(group)
    shapes = model.init(torch.Generator(), device="meta")
    layout = SH.build_layout(shapes)
    metas_flat = tree_leaves(_leaf_meta(layout, n_workers))
    if tc.bit_plan is not None and len(tc.bit_plan) != len(metas_flat):
        raise ValueError(
            f"bit_plan has {len(tc.bit_plan)} specs for "
            f"{len(metas_flat)} state leaves")
    # each leaf's index in the reference's leaf order: what the draws and
    # the per-leaf plans and stats rows are keyed by
    draw_index = sorted_leaf_index(layout.shapes)
    qcfg = QAdamConfig(alpha=tc.alpha, beta=tc.beta, theta=tc.theta,
                       eps=tc.eps, schedule=tc.schedule)
    tiers = tc.topology.tiers(("data",), (n_workers,))
    updater = mode.make_updater(tc, WorkerCtx(
        group=group, n_workers=n_workers, backend=tc.backend,
        tiers=tiers))

    def flat(tree):
        """A state tree's leaves in the layout's order."""
        return tree_leaves(tree_map(lambda _, x: x, layout.shapes, tree))

    def unflat(leaves):
        return tree_unflatten(layout.shapes, leaves)

    def state_x(meta):     # the length of a leaf's m, v and e
        return meta.c if mode.chunk_sharded_moments else meta.numel

    def hp_row(t):
        return _alpha_t(qcfg, t), tc.beta, _theta_t(qcfg, t), tc.eps

    def prepare(device):
        """Copy the log lanes' levels and decision points of every leaf's
        exchange codec to ``device`` now (the step makes them at first
        use, a host-to-device copy that a graph capture refuses)."""
        for i in range(len(metas_flat)):
            codec = mode.leaf_codec(tc, draw_index[i])
            if getattr(codec, "kind", None) == "log":
                grids.log_table_on(codec.k, device)
                grids.log_grid_on(device)

    # ---------------- init ----------------
    def init_state(seed: int = 0, device="cuda"):
        """Rank ``rank``'s state for ``model.init(seed=seed)``: its master
        chunks, zero moments, residuals and extra leaves, count 0."""
        leaves = tree_leaves(model.init(seed=seed, device=device))
        master = []
        for i, meta in enumerate(metas_flat):
            p = leaves[i].to(torch.float32)
            leaves[i] = None
            row = SH.flatten_pad(p, n_workers)[rank]
            master.append(row if n_workers == 1 else row.clone())
            del p, row

        def zeros(length):
            return unflat([torch.zeros(length(m), dtype=torch.float32,
                                       device=device) for m in metas_flat])
        state = {"master": unflat(master), "m": zeros(state_x),
                 "v": zeros(state_x), "e": zeros(state_x), "count": 0}
        for k in mode.extra_state:     # efadam: the broadcast residual
            state[k] = zeros(lambda m: m.c)
        return state

    # ---------------- weight-broadcast channel ----------------
    def chunks_to_shard(chunk, meta, es=None):
        """My master chunk -> the whole leaf, Q_x(x_t), over the wire.
        With ``es`` (the ``broadcast_ef`` modes) the server sends
        Q_x(chunk + es), its scale from chunk + es, and writes K7's
        residual over ``es``; identity leaves send the chunk and keep
        ``es``."""
        codec = weight_wire_codec(tc, meta.numel)
        if isinstance(codec, CD.IdentityCodec):
            rows = C.gather_rows_tiered(chunk, tiers, group)
            return SH.unflatten_chunked(rows, meta.shape)
        send = chunk if es is None else chunk + es
        scale = codec.compute_scale(send, backend=tc.backend)
        # K7 uniform; its residual is kept as es' where there is an es
        payload, _ = CD.encode_rows_ef(send, scale, codec, 1,
                                       backend=tc.backend, out=es)
        del send
        out = torch.empty(meta.shape, dtype=torch.float32,
                          device=chunk.device)
        return C.broadcast_decode_tiered(payload[0], scale, codec, meta.c,
                                         tiers, group, backend=tc.backend,
                                         out=out)

    # ---------------- the step ----------------
    def broadcast(state):
        """1. weight broadcast: every leaf's Q_x(x_t), in layout order
        (``broadcast_ef`` modes write es' over the state's ``es``)."""
        chunks = flat(state["master"])
        if not mode.broadcast_ef:
            return [chunks_to_shard(ch, m) for ch, m in zip(chunks,
                                                            metas_flat)]
        return [chunks_to_shard(ch, m, es) for ch, m, es in
                zip(chunks, metas_flat, flat(state["es"]))]

    def loss_and_grads(xs, batch):
        """2. forward/backward at Q_x(x_t) on this worker's rows: the
        gradients of its mean loss, and the global loss sum(s) / sum(n)
        over workers (a 0-d tensor on the device)."""
        xs = [x.detach().requires_grad_() for x in xs]
        mine = local_batch(batch, rank, n_workers)
        with torch.enable_grad():
            s, n = model.loss(unflat(xs), mine)
            den = n
            if tc.mode == "dp_adam":
                # local sum / GLOBAL count: the reduced gradient is the
                # global mean's
                den = n.detach().clone()
                dist.all_reduce(den, group=group)
            grads = list(torch.autograd.grad(s / den, xs,
                                             allow_unused=True))
        sn = torch.stack([s.detach(), n.detach().to(torch.float32)])
        dist.all_reduce(sn, group=group)
        return sn[0] / sn[1], grads

    def update(state, grads, mark: Optional[Callable] = None, hp=None):
        """3+4. per-worker update and the mode's exchange, leaf by leaf,
        into the state's tensors; consumes ``grads`` (each entry freed
        after use). ``mark(name)``, when given, is called at the end of
        each leaf's "update_exchange" and "master_update". ``hp``: the
        step's (4,) device row of ``hp_row(count + 1)``, made here when
        not given."""
        return update_stats(state, grads, mark, hp)[0]

    def update_stats(state, grads, mark=None, hp=None):
        """``update``, and the local stats rows ((n_leaves, 3) in the
        reference's leaf order) where the mode emits them, else None."""
        masters = flat(state["master"])
        ms, vs, es = (flat(state[k]) for k in ("m", "v", "e"))
        t = state["count"] + 1
        dev = masters[0].device
        if hp is None:
            hp = engine.hyperparams(*hp_row(t), dev)
        rows = [None] * len(metas_flat) if mode.emits_stats else None
        for i, meta in enumerate(metas_flat):
            g = grads[i]
            grads[i] = None
            g = (torch.zeros(meta.numel, dtype=torch.float32, device=dev)
                 if g is None else g.reshape(-1).to(torch.float32))

            def draw(n, i=draw_index[i]):   # looked up at call time
                return draw_uniform(tc.seed, t, i, rank, n, dev)
            out = updater(g, ms[i], vs[i], es[i], masters[i], meta, hp,
                          mark=mark, draw=draw, idx=draw_index[i])
            if rows is not None:
                rows[draw_index[i]] = out[4]
            del g, out
        return (dict(state, count=t),
                None if rows is None else torch.stack(rows))

    def step_fn(state, batch, mark: Optional[Callable] = None, hp=None):
        """One step; ``mark(name)`` (optional) is called at the end of
        "broadcast" and "forward_backward" and within ``update``; ``hp``
        as in ``update``."""
        xs = broadcast(state)
        if mark:
            mark("broadcast")
        loss, grads = loss_and_grads(xs, batch)
        del xs
        if mark:
            mark("forward_backward")
        state, rows = update_stats(state, grads, mark, hp)
        metrics = {"loss": loss}
        if rows is not None:
            metrics["gstats"] = astats.reduce_stats(rows, group, n_workers)
        return state, metrics

    return StepArtifacts(init_state=init_state, step_fn=step_fn,
                         layout=layout, n_workers=n_workers, rank=rank,
                         group=group, config=tc, tiers=tiers,
                         broadcast=broadcast, loss_and_grads=loss_and_grads,
                         update=update, hp_row=hp_row, prepare=prepare)
