"""Distributed QAdam-EF train step (Algorithms 2+3; port of
``repro/dist/step.py``): a quantized parameter server over the worker
ranks of a ``launch.mesh.Grid`` (or of a plain process group: one model
shard), context parallelism over its model axis, for the paper's
``qadam`` mode, the baselines (``dp_adam``, ``efadam``, ``terngrad``,
``ef_sgd``) and the ``adaptive`` mode's per-leaf wire plans
(``repro_torch.dist.modes``), on the flat or a hierarchical topology
(``repro_torch.dist.topology``).

One step on each rank (worker):

  1. weight broadcast: every server Q_x-encodes its master chunk (K3
     first where the scale is an amax; K7 uniform), the payloads are
     all-gathered and every worker K6-decodes Q_x(x_t) for the whole
     model (small leaves ride float32 rows). Modes with ``broadcast_ef``
     (``efadam``) send ``Q_x(chunk + es)`` and keep K7's residual as
     the next ``es``;
  2. forward and backward at Q_x(x_t) (Assumption 3) through
     ``Model.loss``, the sequence split over the model axis and the
     weights gathered layer by layer from their model shards (float32,
     or int8 with ``model_gather_quant``): each worker gets the gradient
     of its own mean loss (``dp_adam``: of its loss sum over the global
     token count), reduce-scattered onto its shards;
  3. the mode's update (``repro_torch.dist.modes``; the paper's
     ``qadam``: K15 Adam+EF, K7 log codes to payload rows; stochastic
     codecs draw the reference's threefry uniforms, leaf l's under
     ``fold_in(fold_in(fold_in(PRNGKey(seed), t), l), worker)``: one
     launch makes the step's key table from t in device memory at the
     first draw, ``core.uniforms``; :func:`draw_uniform` is the same
     draw for one (step, leaf, worker));
  4. the update exchange: all-to-all of the payload rows, K6 decode of
     every worker's codes for this server's chunk with that worker's
     scale, and ``chunk - worker_mean(rows)`` into the master chunk;

and the global loss as sum(s) / sum(n) over every rank, one
``all_reduce`` of a 2-vector on the device. Modes with ``emits_stats``
(``adaptive``) also return ``gstats``: one ``adapt.stats`` row per
leaf, stacked in the reference's leaf order and reduced over every rank
(two ``all_reduce``s), on the device. No step reads the device on the host: the
step count, alpha_t and theta_t live on the host (a session's K-step
dispatch hands each step its t and its hyperparameters as rows of
device tables).

State per rank (the reference's chunked layout, this rank's slice, each
leaf flat): ``master`` this worker's float32 chunk (c elements) of its
model shard of every leaf, ``m``, ``v``, ``e`` its moments and EF
residual over the whole shard (over its chunk where the mode's
``chunk_sharded_moments``), the mode's ``extra_state`` leaves
(chunk-sized: ``efadam``'s ``es``), and the host step ``count``. The
step updates them in place (the reference donates these buffers).

Batches (``_batch_geometry``): the global batch's rows are split over
the workers when the batch divides by their number (worker w takes rows
[w*B/W, (w+1)*B/W)), else every worker takes the whole batch; the
sequence is split over the model shards when it divides by their number
(shard m takes positions [m*S/Nm, (m+1)*S/Nm)), else every shard takes
all of it.

Exchange buckets (``TrainConfig.exchange_bucket_bytes``, the
reference's per-bucket gradient fences; :func:`_exchange_buckets`): the
leaves are grouped, in the reference's leaf order, into buckets of about
that many exchange payload bytes, and each bucket's update and exchange
(steps 3 and 4) is launched from a gradient hook as soon as every leaf
of the bucket has its gradient, while the backward goes on. On the card
the bucket runs on a side stream that forks from the backward's stream
at the hook and joins the step's stream (event waits, which a CUDA graph
captures) once the backward ends, before the loss's all-reduce, so no
two streams carry collectives after the backward; on the CPU it runs in
the hook.
No number changes: each leaf's update is the same computation on the
same gradient, whenever it runs. A leaf stacked over layers, ``(L,
...)``, has its gradient only once the backward reaches layer 0, so the
leaves that can overlap the backward are those outside the stack (the
head, the final norm); a bucket holding a leaf that gets no gradient
runs after the backward. ``<= 0`` keeps one pass after the backward.
The buckets' updates take no phase marks: they run inside the backward,
so a bucketed step marks "broadcast" and "forward_backward" (the
backward with the updates and exchanges it overlapped) alone, and the
per-leaf "update_exchange" / "master_update" marks come from the single
pass. At ``Nm > 1`` the model axis's all-reduces (the step's stream) and
a bucket's exchange (the side stream) are issued on two streams during
the backward, in one order on every rank; NCCL has run them on one rank
only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.adapt import stats as astats
from repro_torch.comm import codec as CD
from repro_torch.core.qadam import QAdamConfig, _alpha_t, _theta_t
from repro_torch.core import uniforms
from repro_torch.core.uniforms import draw_uniform  # noqa: F401
from repro_torch.dist import collectives as C
from repro_torch.dist import sharding as SH
from repro_torch.dist import topology as T
from repro_torch.dist.modes import WorkerCtx, get_mode
from repro_torch.launch.mesh import Grid
from repro_torch.models import layers as L
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
    # link tiers: FlatTopology, or HierarchicalTopology(nodes, d) with a
    # float32 intra-node reduce and the exchange across nodes only
    topology: T.Topology = T.FlatTopology()
    # int8 gather of the model shards at this k_x (None: float32)
    model_gather_quant: Optional[int] = None
    seed: int = 0                       # the stochastic codecs' draws
    # adaptive mode: one codec spec per leaf, in the reference's leaf
    # order (keys sorted); None = every leaf on log:grad_k
    bit_plan: Optional[Tuple[str, ...]] = None
    # kernels' implementation: "cuda" | "torch" (the plain versions) |
    # None = by the tensors' device
    backend: Optional[str] = None
    # update-exchange buckets of about this many exchange payload bytes,
    # each launched from a gradient hook as soon as its leaves have their
    # gradients; <= 0: one pass after the whole backward
    exchange_bucket_bytes: int = 4 << 20


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The sharded serving step's settings (``dist.serve``): the weight
    gather's int8 Q_x codes at ``weight_k`` bits (None: float32), on the
    absolute grid or by amax; the grid axes whose ranks split the batch
    (those present in the grid), and whether they do."""

    weight_k: Optional[int] = None      # int8 weight-gather bits
    weight_absolute: bool = False
    worker_axes: Tuple[str, ...] = ("pod", "data")
    batch_dim_shardable: bool = True


@dataclasses.dataclass(frozen=True)
class LeafMeta:
    """Per-leaf wire geometry: ``shape`` the local model shard's shape,
    ``numel`` its element count, ``c`` the per-worker chunk length;
    ``dim`` and ``stacked`` the leaf's shard dim (``sharding``) and
    ``full_shape`` the whole leaf's shape."""

    shape: Tuple[int, ...]
    c: int
    numel: int
    dim: int
    stacked: bool
    full_shape: Tuple[int, ...]

    @property
    def full_numel(self) -> int:
        return math.prod(self.full_shape)


def _leaf_meta(layout: SH.Layout, n_workers: int):
    """Tree of LeafMeta mirroring the parameter tree."""
    def one(shape, dim, stacked):
        shp = SH.local_shard_shape(tuple(shape), dim, stacked,
                                   layout.n_shards)
        n = math.prod(shp)
        return LeafMeta(shape=shp, c=SH.chunk_size(n, n_workers), numel=n,
                        dim=dim, stacked=stacked, full_shape=tuple(shape))
    return tree_map(one, layout.shapes, layout.dims, layout.stacked)


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
    # the process grid (launch.mesh.Grid): its model axis and the group
    # over every rank
    grid: Any = None
    # the exchange buckets (lists of leaf indices in layout order, in the
    # reference's bucket order), and what the last bucketed step saw:
    # {"order": buckets in the order they ran, "in_backward": how many
    # ran from a gradient hook, "bytes": exchange bytes each}; with
    # overlap["timing"] set (eager steps on the card, not in a graph
    # capture) also "events": a CUDA event on the backward's stream at
    # each bucket's launch and one at the backward's end
    buckets: Any = None
    overlap: Any = None


def _exchange_buckets(metas_flat, mode, tc, n_workers, tiers=None):
    """Group consecutive leaves into wire buckets of about
    ``tc.exchange_bucket_bytes`` payload each (``metas_flat`` in the
    reference's leaf order, which ``mode.leaf_tier_nbytes`` keys on):
    the reference's buckets for the same layout, mode, topology and
    worker count. ``<= 0`` collapses to one whole-tree bucket. Bucket
    fill counts the payload that crosses the exchange (inter) tier, so
    hierarchical topologies pack ~``devices_per_node`` times more leaves
    a bucket."""
    if tc.exchange_bucket_bytes <= 0 or len(metas_flat) <= 1:
        return [list(range(len(metas_flat)))]
    buckets, cur, cur_bytes = [], [], 0
    for i, meta in enumerate(metas_flat):
        cur.append(i)
        cur_bytes += mode.leaf_tier_nbytes(tc, i, meta.c, meta.numel,
                                           n_workers, tiers)["inter"]
        if cur_bytes >= tc.exchange_bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
    if cur:
        buckets.append(cur)
    return buckets


_SIDE_STREAMS: Dict[int, Any] = {}


def _side_stream(device):
    """The exchange buckets' side stream of a card (one a device)."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _SIDE_STREAMS:
        _SIDE_STREAMS[idx] = torch.cuda.Stream(device=idx)
    return _SIDE_STREAMS[idx]


def weight_wire_codec(tc: TrainConfig, numel: int):
    """The weight-broadcast channel's codec for a leaf of ``numel``
    elements (the whole leaf's, over every model shard), the one source
    of what moves on channel 2 (``comm_bytes_per_step`` reads it too).
    Small or unquantized leaves ride float32 (identity)."""
    if tc.weight_k is None or numel < tc.weight_q_min_numel:
        return CD.IdentityCodec()
    return CD.uniform_wire_codec(tc.weight_k, tc.weight_absolute)


def local_batch(batch: Dict[str, torch.Tensor], rank: int,
                n_workers: int) -> Dict[str, torch.Tensor]:
    """This worker's rows of the global batch (``_batch_geometry``'s
    worker half): a slice of B / W rows when B divides by W, else the
    whole batch. B is read from ``tokens``, or from ``embeds`` for an
    embedding-input model."""
    B = batch["tokens" if "tokens" in batch else "embeds"].shape[0]
    if B % n_workers or n_workers == 1:
        return batch
    b = B // n_workers
    return {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}


def _batch_geometry(batch: Dict[str, torch.Tensor], n_shards: int) -> bool:
    """Whether the sequence splits over the model axis (context
    parallelism): more than one shard, S divides by their number, and
    so do an encoder-decoder's audio frames (else both stay whole)."""
    S = batch["tokens" if "tokens" in batch else "embeds"].shape[1]
    if "audio" in batch and batch["audio"].shape[1] % n_shards:
        return False
    return n_shards > 1 and S % n_shards == 0


def shard_batch(batch: Dict[str, torch.Tensor], rank: int, n_workers: int,
                index: int = 0, n_shards: int = 1
                ) -> Dict[str, torch.Tensor]:
    """This rank's part of the global batch: its worker's rows
    (:func:`local_batch`) and, where the sequence splits over the model
    axis, model shard ``index``'s positions of every entry with a
    sequence dim (an encoder-decoder's audio along its frames)."""
    mine = local_batch(batch, rank, n_workers)
    if not _batch_geometry(mine, n_shards):
        return mine

    def part(v):
        s = v.shape[1] // n_shards
        return v[:, index * s:(index + 1) * s]
    return {k: part(v) if v.dim() >= 2 else v for k, v in mine.items()}


def _make_param_gather(layout: SH.Layout, n_shards: int, group,
                       expert_local: bool, quant_k: Optional[int],
                       quant_absolute: bool = False,
                       quant_min_numel: int = 0,
                       backend: Optional[str] = None,
                       stacked_at_static: bool = False):
    """The forward's parameter hook ``gather(subtree, kind)``
    (``models.layers.ShardCtx``): the whole weights from their model
    shards, float32 (``collectives.gather_shard``) or int8 at k_x =
    ``quant_k`` for leaves of at least ``quant_min_numel`` elements
    (``quantized_gather_shard``); expert tensors stay local when
    ``expert_local``. ``kind`` "static" gathers the leaves outside the
    layer stack (the stacked ones are gathered a layer at a time inside
    the loop, kind "blocks").

    ``stacked_at_static`` (serving): the "static" pass gathers the
    stacked leaves whole too, so a Q_x scale is one a shard across all
    the layers of a leaf (the reference's serving semantics), and the
    per-layer gather does nothing. Training keeps the per-layer
    gather."""
    dims = SH.dims_by_path(layout)

    def gather_leaf(dim: int, stacked: bool, leaf):
        if dim == SH.REPLICATED:
            return leaf
        ax = SH.axis_of(dim, stacked)
        if dim == SH.EXPERT_MARKER and expert_local:
            if quant_k is not None and leaf.numel() >= quant_min_numel:
                # resident experts keep the Q_x wire's semantics
                return C.quantized_gather_shard(leaf, ax, 1, quant_k,
                                                quant_absolute,
                                                backend=backend)
            return leaf
        if quant_k is not None and leaf.numel() * n_shards >= \
                quant_min_numel:
            return C.quantized_gather_shard(leaf, ax, n_shards, quant_k,
                                            quant_absolute, group,
                                            backend=backend)
        return C.gather_shard(leaf, ax, n_shards, group)

    def walk(tree, path, kind):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,), kind) for k, v in tree.items()}
        if kind == "static":
            if path and path[0] in SH._STACKED_KEYS and \
                    not stacked_at_static:
                return tree          # a layer at a time inside the loop
            return gather_leaf(dims[path][0], dims[path][1], tree)
        return gather_leaf(dims[(kind,) + path][0], False, tree)

    def gather(subtree, kind: str):
        if n_shards <= 1 and quant_k is None:
            return subtree
        if stacked_at_static and kind != "static":
            return subtree           # gathered whole in the static pass
        return walk(subtree, (), kind)

    return gather


def make_train_step(model, grid, tc: TrainConfig) -> StepArtifacts:
    """The distributed step of ``tc.mode`` over ``grid``, a
    ``launch.mesh.Grid`` (``make_grid``: workers over its pod and data
    axes, model shards over its model axis) or a plain process group
    (``make_process_group``: its ranks the workers, one model shard):
    ``init_state`` and ``step_fn(state, batch) -> (state, {"loss"})``."""
    mode = get_mode(tc.mode)      # raises for the modes not ported
    if not isinstance(grid, Grid):
        grid = Grid.of_group(grid)
    group = grid.workers
    n_workers, rank = grid.n_workers, grid.worker_index
    n_shards, shard = grid.n_shards, grid.model_index
    shapes = model.init(device="meta")
    layout = SH.build_layout(shapes, n_shards)
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
    topo = tc.topology if tc.topology is not None else T.FlatTopology()
    # a mode that is not tiered (dp_adam) runs flat collectives on any
    # topology: its tiers resolve flat, for the updater and the accounting
    tiers = topo.tiers(grid.worker_axes, grid.wsizes) if mode.tiered \
        else T.flat_tiers(grid.worker_axes, grid.wsizes)
    groups = C.TierGroups(
        inter=grid.group(tiers.inter_axes),
        intra=grid.group(tiers.intra_axes) if tiers.hierarchical else None)
    # the stochastic codecs' draws are keyed by the inter-tier worker
    # index: a node's devices draw the same codes for their node mean
    draw_worker = grid.index_over(tiers.inter_axes)
    updater = mode.make_updater(tc, WorkerCtx(
        group=group, n_workers=n_workers, backend=tc.backend,
        tiers=tiers, groups=groups))
    # the expert stacks stay local (E / n_shards experts a rank) where
    # the sequence splits over the model axis, as the reference's
    # ``expert_local=cp``; else they are gathered whole like any leaf
    gathers = {cp: _make_param_gather(
        layout, n_shards, grid.model, expert_local=cp,
        quant_k=tc.model_gather_quant, quant_absolute=False,
        quant_min_numel=2 ** 14, backend=tc.backend) for cp in (False, True)}
    replicated = [m.dim == SH.REPLICATED for m in metas_flat]
    # buckets over the reference's leaf order, as layout indices
    ref_order = sorted(range(len(metas_flat)), key=draw_index.__getitem__)
    buckets = [[ref_order[j] for j in b] for b in _exchange_buckets(
        [metas_flat[i] for i in ref_order], mode, tc, n_workers, tiers)]
    bucket_bytes = [sum(mode.leaf_tier_nbytes(
        tc, draw_index[i], metas_flat[i].c, metas_flat[i].numel, n_workers,
        tiers)["inter"] for i in b) for b in buckets]
    hooked = tc.exchange_bucket_bytes > 0 and len(buckets) > 1
    overlap: Dict[str, Any] = {}

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
    def init_state(seed: int = 0, device="cuda", key=None):
        """Rank ``rank``'s state for ``model.init(key, seed=seed)`` (the
        reference's ``init_state(PRNGKey(seed))``, or its ``key``): its
        master chunks, zero moments, residuals and extra leaves, count 0."""
        leaves = tree_leaves(model.init(key, seed=seed, device=device))
        master = []
        for i, meta in enumerate(metas_flat):
            p = SH.shard_of(leaves[i].to(torch.float32), meta.dim,
                            meta.stacked, n_shards, shard)
            leaves[i] = None
            row = SH.flatten_pad(p, n_workers)[rank]
            master.append(row if n_workers == 1 and n_shards == 1
                          else row.clone())
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
        codec = weight_wire_codec(tc, meta.full_numel)
        if isinstance(codec, CD.IdentityCodec):
            rows = C.gather_rows_tiered(chunk, tiers, groups)
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
                                         tiers, groups, backend=tc.backend,
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

    def loss_and_grads(xs, batch, hook=None, after=None):
        """2. forward/backward at Q_x(x_t) on this rank's part of the
        batch: the gradients of its worker's mean loss on its model
        shards, and the global loss sum(s) / sum(n) over every rank (a
        0-d tensor on the device).

        The reference differentiates ``psum(s) / psum(n) / Nm`` over
        the model axis; psum's transpose is psum, so each shard's local
        s takes the cotangent 1 / psum(n), which is what ``s / den``
        gives here. Gathered leaves then sum their shards' gradients in
        the gathers' reduce-scatter, and replicated leaves in the
        all-reduce below. A MoE layer's local expert leaves (E / Nm
        experts a rank, never gathered) get theirs through the token
        exchange: its backward returns every shard's cotangents to the
        experts' owner, so each local expert leaf takes the gradient of
        the whole worker's loss through it, divided by psum(n), which
        is what ``jax.grad`` gives in the reference's ``cp_equiv`` run;
        they take no all-reduce.

        ``hook(i, g)``, when given, is called from the backward with leaf
        i's gradient as soon as it exists (its model-axis sum included
        where the leaf is replicated), and ``after(grads)`` once the
        backward ends, before the loss's all-reduce; the gradients are
        returned all the same."""
        xs = [x.detach().requires_grad_() for x in xs]
        cp = _batch_geometry(batch, n_shards)
        mine = shard_batch(batch, rank, n_workers, shard, n_shards)
        ctx = L.ShardCtx(cp_group=grid.model if cp else None,
                         cp_size=n_shards if cp else 1, cp_rank=shard,
                         param_gather=gathers[cp])
        with torch.enable_grad():
            s, n = model.loss(unflat(xs), mine, ctx)
            den = n
            if tc.mode == "dp_adam":
                # local sum / GLOBAL count: the reduced gradient is the
                # global mean's
                den = C.all_reduce(n.detach().clone(), grid.world)
            elif n_shards > 1:
                # the worker's count over its model shards; the gathers'
                # reduce-scatter sums the shards' gradients
                den = C.all_reduce(n.detach().clone(), grid.model)
            handles = [] if hook is None else [
                x.register_hook(lambda g, i=i: hook(i, model_sum(i, g)))
                for i, x in enumerate(xs)]
            try:
                grads = list(torch.autograd.grad(s / den, xs,
                                                 allow_unused=True))
            finally:
                for h in handles:
                    h.remove()
        if hook is None:
            grads = [model_sum(i, g) for i, g in enumerate(grads)]
        if after is not None:
            after(grads)
        sn = torch.stack([s.detach(), n.detach().to(torch.float32)])
        C.all_reduce(sn, grid.world)
        return sn[0] / sn[1], grads

    def model_sum(i, g):
        """Whole leaves take no gather: their gradient misses the
        reduce-scatter's sum over the model shards, summed here."""
        if n_shards > 1 and replicated[i] and g is not None:
            C.all_reduce(g, grid.model)
        return g

    def update(state, grads, mark: Optional[Callable] = None, hp=None,
               t=None):
        """3+4. per-worker update and the mode's exchange, leaf by leaf,
        into the state's tensors; consumes ``grads`` (each entry freed
        after use). ``mark(name)``, when given, is called at the end of
        each leaf's "update_exchange" and "master_update". ``hp``: the
        step's (4,) device row of ``hp_row(count + 1)``, and ``t``: count
        + 1 as a (1,) int64 device tensor, each made here when not
        given."""
        return update_stats(state, grads, mark, hp, t)[0]

    def update_begin(state, hp=None, t_dev=None):
        """The per-step context the leaf updates share."""
        masters = flat(state["master"])
        ms, vs, es = (flat(state[k]) for k in ("m", "v", "e"))
        t = state["count"] + 1
        dev = masters[0].device
        if hp is None:
            hp = engine.hyperparams(*hp_row(t), dev)
        rows = [None] * len(metas_flat) if mode.emits_stats else None
        return dict(masters=masters, ms=ms, vs=vs, es=es, t=t, dev=dev,
                    hp=hp, rows=rows, t_dev=t_dev, keys=None)

    def draw_keys(u):
        """The step's (L, 2) key table, made at the step's first draw."""
        if u["keys"] is None:
            if u["t_dev"] is None:
                u["t_dev"] = uniforms.step_tensor(u["t"], u["dev"])
            u["keys"] = uniforms.step_keys(tc.seed, u["t_dev"],
                                           len(metas_flat), draw_worker,
                                           backend=tc.backend)
        return u["keys"]

    def update_leaf(u, i, g, mark=None):
        """3+4 for leaf i (layout order) with its gradient g (None: no
        gradient reached it, zeros)."""
        meta, dev = metas_flat[i], u["dev"]
        g = (torch.zeros(meta.numel, dtype=torch.float32, device=dev)
             if g is None else g.reshape(-1).to(torch.float32))

        def draw(n, i=draw_index[i]):
            return uniforms.draw(draw_keys(u), i, n, backend=tc.backend)
        out = updater(g, u["ms"][i], u["vs"][i], u["es"][i],
                      u["masters"][i], meta, u["hp"], mark=mark, draw=draw,
                      idx=draw_index[i])
        if u["rows"] is not None:
            u["rows"][draw_index[i]] = out[4]

    def update_end(state, u):
        rows = u["rows"]
        return (dict(state, count=u["t"]),
                None if rows is None else torch.stack(rows))

    def update_stats(state, grads, mark=None, hp=None, t=None):
        """``update``, and the local stats rows ((n_leaves, 3) in the
        reference's leaf order) where the mode emits them, else None."""
        u = update_begin(state, hp, t)
        for i in range(len(metas_flat)):
            g = grads[i]
            grads[i] = None
            update_leaf(u, i, g, mark)
            del g
        return update_end(state, u)

    def bucketed_step(state, xs, batch, hp=None, t=None):
        """2-4 with the update and exchange launched a bucket at a time
        from the backward's gradient hooks (see the module docstring);
        returns ``(loss, state', stats rows)``."""
        u = update_begin(state, hp, t)
        on_card = u["dev"].type == "cuda"
        side = _side_stream(u["dev"]) if on_card else None
        main = torch.cuda.current_stream(u["dev"]) if on_card else None
        owner = {i: k for k, b in enumerate(buckets) for i in b}
        got: Dict[int, Any] = {}
        left = [len(b) for b in buckets]
        ran, keep = [], []
        timing = on_card and bool(overlap.get("timing"))
        events = []

        def mark_event():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(u["dev"]))
            events.append(ev)

        def run(k, in_backward):
            gs = [got.get(i) for i in buckets[k]]
            keep.extend(g for g in gs if g is not None)
            if timing:
                mark_event()
            if side is not None:
                side.wait_stream(torch.cuda.current_stream(u["dev"]))
            with (torch.cuda.stream(side) if side is not None
                  else contextlib.nullcontext()):
                for i, g in zip(buckets[k], gs):
                    update_leaf(u, i, g)
            ran.append((k, in_backward))

        def hook(i, g):
            got[i] = g
            k = owner[i]
            left[k] -= 1
            if left[k] == 0:
                run(k, True)

        def after(grads):
            if timing:
                mark_event()                # the backward's end
            for k in range(len(buckets)):   # buckets a leaf was missing
                if left[k] > 0:
                    for i in buckets[k]:
                        got.setdefault(i, grads[i])
                    run(k, False)
            if side is not None:
                main.wait_stream(side)

        loss, grads = loss_and_grads(xs, batch, hook=hook, after=after)
        del xs, grads
        keep.clear()
        got.clear()
        overlap.update(order=[k for k, _ in ran],
                       in_backward=sum(b for _, b in ran),
                       bytes=[bucket_bytes[k] for k, _ in ran])
        if timing:
            overlap["events"] = events
        state, rows = update_end(state, u)
        return loss, state, rows

    def step_fn(state, batch, mark: Optional[Callable] = None, hp=None,
                t=None):
        """One step; ``mark(name)`` (optional) is called at the end of
        "broadcast" and "forward_backward" and, in the single pass,
        within ``update`` (with buckets "forward_backward" ends after
        the updates the backward overlapped); ``hp`` and ``t`` as in
        ``update``."""
        xs = broadcast(state)
        if mark:
            mark("broadcast")
        if hooked:
            loss, state, rows = bucketed_step(state, xs, batch, hp, t)
            del xs
            if mark:
                mark("forward_backward")
        else:
            loss, grads = loss_and_grads(xs, batch)
            del xs
            if mark:
                mark("forward_backward")
            state, rows = update_stats(state, grads, mark, hp, t)
        metrics = {"loss": loss}
        if rows is not None:
            metrics["gstats"] = astats.reduce_stats(
                rows, grid.world, n_workers * n_shards)
        return state, metrics

    return StepArtifacts(init_state=init_state, step_fn=step_fn,
                         layout=layout, n_workers=n_workers, rank=rank,
                         group=group, config=tc, tiers=tiers,
                         broadcast=broadcast, loss_and_grads=loss_and_grads,
                         update=update, hp_row=hp_row, prepare=prepare,
                         grid=grid, buckets=buckets, overlap=overlap)


def __getattr__(name):
    # compatibility: the serving step lives in repro_torch.dist.serve
    if name in ("make_serve_step", "_cache_specs_for"):
        from repro_torch.dist import serve
        return getattr(serve, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
