"""TrainSession: the prefetching, resumable training loop of both programs
(port of ``repro/train/session.py``):

  * the distributed path, Algorithms 2+3 (``repro_torch.dist.step``
    ``StepArtifacts``): ``TrainSession.from_artifacts(art, batches)``;
  * the single-machine path, Algorithm 1 (``repro_torch.core.qadam``):
    ``TrainSession.from_optimizer(opt, loss_fn, params, batches)``.

    sess = TrainSession.from_artifacts(art, batches, cfg)
    sess.resume(cfg.ckpt_dir)      # no-op when no checkpoint exists
    sess.run(1000)                 # 1000 more optimizer steps
    sess.close()

One single-machine step is ``opt.forward_params`` (Q_x), the loss and its
gradients at those weights (autograd), ``opt.update`` (Q_g + EF) and
``apply_updates_`` (in place); one distributed step is ``art.step_fn``.
The hot loop does not wait on the device in steady state:

  * **prefetch** - a background thread pulls numpy batches from the
    generator (``scan_chunk`` of them stacked a dispatch) and stages them
    to the device (pinned host copy, then a non-blocking copy),
    ``prefetch`` dispatches deep.
  * **device-resident losses** - each step's loss is written into a
    device ring buffer; the host reads the ring with one copy per log
    boundary (and after the first and last dispatch of a run), never per
    step. ``stats`` counts ``dispatches`` and ``syncs`` as the reference
    does, so a test can assert that steady-state steps make zero host
    syncs. The step count, alpha_t and theta_t live on the host.
  * **scan chunks** - ``scan_chunk = K > 1`` runs K steps a dispatch. On
    a CUDA device a dispatch of K steps is one ``torch.cuda.CUDAGraph``
    replay: the first runs eagerly (the warm-up: real training that
    initializes cuBLAS, NCCL and the kernels' tables), then the K steps
    are captured (capture executes nothing) and every later K-step
    dispatch replays them. The graph's inputs are static: the batch is
    copied into a (K, ...) buffer, the hyperparameters come from a (K, 4)
    table the host fills before each replay
    (``opt.engine.HyperparamTable``), the K losses land in a (K,)
    buffer, and the state is updated in place. On the CPU a dispatch is
    the K steps in a loop. A tail of fewer steps runs eagerly.
    ``stats["graph_captures"]`` and ``stats["graph_replays"]`` count
    them. Modes whose quantizer draws uniforms from a host-seeded
    generator (``terngrad``, ``terngrad_sgd``) are refused with K > 1 on
    CUDA (ROADMAP.md queue 2: a counter-based generator in the kernel).
  * **checkpoints** - at a ``ckpt_every`` boundary the state is copied to
    pinned host buffers on a side stream (the compute stream waits for
    that copy before the next step's in-place writes; a device copy of a
    full-width state would not fit beside it), and a writer thread
    serializes the host copy (``repro_torch.checkpoint.store``: atomic
    step dirs, keep-last-N, the reference's format). With ``ckpt_codec``
    the moments are encoded on the device first (#5; K6 decodes them on
    restore). At W > 1 rank 0 gathers the rows of one leaf at a time
    and writes the reference's one global layout.
  * **resume** - ``resume(ckpt_dir)`` restores the state, the step count
    and the data-stream position (the manifest's ``batches_consumed``;
    the fresh generator is fast-forwarded), so a resumed run is bitwise
    an unbroken one. The leaves are read one at a time on the host and
    copied into the state's own tensors: no second state on the device.
  * **evals** - ``eval_fn(state)`` at ``eval_every`` boundaries, each in
    its own ``{"step", "eval"}`` history entry pinned to the true
    post-dispatch step, as are checkpoints.
  * **stats ring** - a mode with ``emits_stats`` (``adaptive``) returns
    one (n_leaves, 3) gradient-stats row block a step; the session keeps
    them in a device ring that shares the loss ring's slots (a dispatch
    writes its K losses and its K row blocks at the same slot, a device
    copy: inside a CUDA graph the K steps write static buffers, and the
    copies into the ring at the host's slot run after the replay, so no
    host integer is frozen into the graph). ``harvest_stats()`` reads the
    ring in one host sync. ``stats_ring`` sets how many steps stay
    resident between harvests.
  * **plan swaps** - ``swap_artifacts(art)`` installs another step of the
    same workers and state layout (the adaptive controller's new bit
    plan) between dispatches: the state tensors carry over as they are.
    On the card the old plan's graph is released (its pool freed before
    the next capture: one graph pool at a time), the new step's device
    tables are made (``art.prepare``) and the next K-step dispatch
    captures the new plan and replays it. A plan met again is captured
    again.

  * **AOT artifacts** - with ``aot_dir`` the session makes the kernel
    library its step launches ready at construction through
    ``repro_torch.perf.aot.load_or_compile``: a matching artifact is
    loaded with ``ctypes`` (no ``nvcc``, no link), else the library is
    built (the build cache first) and exported. ``stats`` counts
    ``compilations`` (this process ran ``nvcc`` for it), ``aot_loads``
    and ``aot_saves``; on the CPU there is no library and they stay 0.
    The build cache is enabled here only when ``REPRO_COMPILE_CACHE``
    names a directory (``perf.cache.ensure_persistent_cache``).
"""
from __future__ import annotations

import dataclasses
import gc
import math
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.comm.codec import WireBuffer, get_codec
from repro_torch.core.qadam import QAdamState, apply_updates_
from repro_torch.opt import engine
from repro_torch.perf import aot
from repro_torch.perf import cache as perf_cache
from repro_torch.tree import (tree_flatten_with_path, tree_leaves, tree_map,
                              tree_map_with_path, tree_unflatten)


@dataclasses.dataclass
class SessionConfig:
    log_every: int = 10        # history/log cadence; 0 = never harvest
    eval_every: int = 0
    eval_fn: Optional[Callable] = None   # eval_fn(state) -> loggable
    ckpt_every: int = 0
    ckpt_dir: Optional[str] = None
    ckpt_keep: int = 3         # keep-last-N versioned checkpoints
    ckpt_async: bool = True    # background writer thread
    # a repro_torch.comm codec spec for compressed optimizer-moment
    # snapshots (e.g. "uniform_amax:7"); None = raw float32. Masters and
    # counters always stay exact; see repro_torch.checkpoint.store.
    ckpt_codec: Optional[str] = None
    scan_chunk: int = 1        # K steps a dispatch (a CUDA graph on CUDA)
    prefetch: int = 2          # staged dispatches in flight; 0 = inline
    check_finite: bool = True  # raise on non-finite harvested loss
    # stats-ring coverage in steps (modes with ``emits_stats``: the
    # adaptive controller's replan window): the per-step stats rows stay
    # on the device for at least this many steps between
    # ``harvest_stats()`` calls; 0 sizes the ring off log_every alone
    stats_ring: int = 0
    # AOT step artifacts (repro_torch.perf.aot): the kernel library the
    # step launches, keyed on (config digest, grid, mode, codec, state
    # signature, card, sources); a warm dir loads it without nvcc
    aot_dir: Optional[str] = None


def stage_batch(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """Host numpy batch -> tensors on ``device``; to a GPU through pinned
    memory with a non-blocking copy (no wait on the device)."""
    device = torch.device(device)
    out = {}
    for k, a in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


def stack_batches(batch_list):
    """Stack a list of same-shape batch trees along a new leading axis
    (the chunk's step axis)."""
    return tree_map(lambda *xs: torch.stack(xs), *batch_list)


def _stack_host(batch_list):
    """Host-side (numpy) stack for the prefetch thread."""
    return {k: np.stack([np.asarray(b[k]) for b in batch_list])
            for k in batch_list[0]}


def _row(batch, i: int):
    """Step ``i`` of a stacked batch tree."""
    return tree_map(lambda x: x[i], batch)


# ---------------------------------------------------------------------------
# K steps a dispatch
# ---------------------------------------------------------------------------

def _tensor_leaves(tree) -> List[tuple]:
    return [(k, x) for k, x in tree_flatten_with_path(tree)
            if isinstance(x, torch.Tensor)]


def _replaced(before: List[tuple], after) -> List[str]:
    """The keys of the state ``after`` a step whose tensors are not the
    ones of ``before`` (``_tensor_leaves`` of the state the step was
    given): what a CUDA graph of the step would not see."""
    now = dict(_tensor_leaves(after))
    return [k for k, x in before
            if k not in now or now[k].data_ptr() != x.data_ptr()] + \
        [k for k in now if k not in dict(before)]


class _Chunks:
    """K steps of ``step(state, batch_i, hp_i) -> (state, outs or None)``
    a dispatch (``outs`` a tuple of device tensors: the loss, and the
    stats rows where the mode emits them), state updated in place, the
    step count read and set through ``get_count`` / ``set_count`` (a
    host int). Step t's hyperparameters ``hp_row(t)`` reach it as row i
    of a static table.

    On a CUDA device the first K-step dispatch runs eagerly (the warm-up),
    the second captures the K steps in one CUDA graph and replays it, and
    each later one is a replay; fewer than K steps run eagerly. Elsewhere
    every dispatch is a loop. A capture that fails raises, as does one
    whose steps return other state tensors than they were given (a graph
    replays against the tensors it captured)."""

    def __init__(self, k: int, step: Callable, hp_row: Callable,
                 get_count: Callable, set_count: Callable, device,
                 stats: Dict[str, int], name: str):
        self.k, self._step, self._hp_row = k, step, hp_row
        self._get, self._set = get_count, set_count
        self.device = torch.device(device)
        self.stats, self.name = stats, name
        self.table = engine.HyperparamTable(k, self.device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self._warm = False
        self._batch = self._outs = self._like = None
        self.capture_s: List[float] = []   # host seconds of each capture

    def reset(self) -> None:
        """Drop the captured graph with its static batch and output
        buffers (the graph's private pool goes with it): the next K-step
        dispatch captures again (after an eager one where none has run
        yet)."""
        self.graph = None
        self._batch = self._outs = None

    def _fill(self, t0: int, k: int) -> None:
        self.table.fill([self._hp_row(t0 + 1 + i) for i in range(k)])

    def _eager(self, state, batch, k: int):
        outs = []
        for i in range(k):
            state, out = self._step(state, _row(batch, i), self.table[i])
            outs.append(out)
        if outs[0] is None:
            return state, None
        self._like = [(o.shape, o.dtype) for o in outs[0]]
        return state, tuple(torch.stack(c) for c in zip(*outs))

    def _capture(self, state, batch) -> None:
        torch.cuda.empty_cache()   # one pool of a step's transients, not two
        self._batch = tree_map(torch.empty_like, batch)
        self._outs = None if self._like is None else tuple(
            torch.zeros((self.k,) + tuple(shape), dtype=dt,
                        device=self.device) for shape, dt in self._like)
        count = self._get(state)
        before = _tensor_leaves(state)
        graph = torch.cuda.CUDAGraph()
        # no garbage collection inside the capture: a finalizer of an
        # earlier object (a graph, a collective's work) would make a CUDA
        # call that the capturing thread may not make
        gc.disable()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                st = state
                for i in range(self.k):
                    st, out = self._step(st, _row(self._batch, i),
                                         self.table[i])
                    if self._outs is not None:
                        for buf, o in zip(self._outs, out):
                            buf[i].copy_(o)
        finally:
            gc.enable()
        moved = _replaced(before, st)
        if moved:
            raise RuntimeError(
                f"scan_chunk={self.k} on CUDA: {self.name}'s step returns "
                f"new tensors for {moved} instead of writing into the ones "
                "it was given, so a CUDA graph of it would replay against "
                "the old ones")
        self._set(state, count)     # capturing executed nothing
        self.graph = graph
        self.stats["graph_captures"] += 1

    def __call__(self, state, batch, k: int):
        """Run the ``k`` steps of the stacked ``batch``; returns (state,
        the outs stacked over the k steps, or None)."""
        t0 = self._get(state)
        self._fill(t0, k)
        if self.device.type != "cuda" or k < self.k or not self._warm:
            out = self._eager(state, batch, k)
            self._warm = self._warm or k == self.k
            return out
        if self.graph is None:
            t = time.perf_counter()
            self._capture(state, batch)
            self.capture_s.append(time.perf_counter() - t)
        tree_map(lambda dst, src: dst.copy_(src), self._batch, batch)
        self.graph.replay()
        self.stats["graph_replays"] += 1
        state = self._set(state, t0 + self.k)
        return state, self._outs


# ---------------------------------------------------------------------------
# the two training programs
# ---------------------------------------------------------------------------
#
# Each program gives its checkpoint as ``ckpt_tree(state)``: the
# reference's layout with the live tensors of this rank as leaves (no
# copies) beside host scalars. ``gather(x)`` turns a live leaf into the
# stored one (None on a rank that does not write) and says whether that is
# a fresh tensor; ``stored_shape(x)`` is its shape; ``scatter(stored,
# live)`` writes this rank's part of a stored leaf into the live tensor;
# ``from_ckpt(tree, state)`` takes the host scalars (the count).

def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a device tensor, on the current stream."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return h.copy_(t, non_blocking=True)


class _SingleProgram:
    """Single-machine path: a ``repro_torch.core.qadam`` optimizer plus a
    ``loss_fn(forward_params, batch) -> 0-d tensor``. State is
    ``{"params": ..., "opt": QAdamState}``; its checkpoint is the
    reference's ``{"params", "opt": QAdamState._asdict()}``, the count an
    int32 and the PRNG key ``[0, seed]`` (the port's draws are not
    threefry; the key is written for the reference and not read back)."""

    def __init__(self, opt, loss_fn):
        self.opt, self.loss_fn = opt, loss_fn
        self.stochastic = opt.stochastic
        self.hp_row = opt.hp_row
        self.name = "the optimizer"

    def aot_facts(self):
        return {"program": "single",
                "opt": type(self.opt).__name__,
                "opt_cfg": getattr(self.opt, "cfg", None),
                "loss_fn": getattr(self.loss_fn, "__qualname__",
                                   repr(self.loss_fn))}

    def stats_shape(self):
        return None

    def init_state(self, params):
        # a private copy: the steps update the parameters in place
        params = tree_map(lambda p: p.detach().clone(), params)
        return {"params": params, "opt": self.opt.init(params)}

    def device(self, state):
        return tree_leaves(state["params"])[0].device

    def step(self, state, batch, hp=None):
        p, s = state["params"], state["opt"]
        fp = self.opt.forward_params(p, s)
        leaves = [l.detach().requires_grad_() for l in tree_leaves(fp)]
        with torch.enable_grad():
            loss = self.loss_fn(tree_unflatten(fp, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(l) if g is None else g
                 for l, g in zip(leaves, grads)]
        del fp, leaves    # the Q_x forward copy is not needed past here
        with torch.no_grad():
            upd, s2 = self.opt.update(tree_unflatten(p, grads), s, p, hp=hp)
            del grads
            apply_updates_(p, upd)
        return {"params": p, "opt": s2}, {"loss": loss.detach()}

    def get_count(self, state) -> int:
        return state["opt"].count

    def set_count(self, state, count: int):
        state["opt"] = state["opt"]._replace(count=count)
        return state

    def ckpt_tree(self, state):
        s = state["opt"]
        return {"params": state["params"],
                "opt": {"count": np.int32(s.count), "m": s.m, "v": s.v,
                        "e": s.e,
                        "key": np.array([0, self.opt.seed], np.uint32)}}

    def gather(self, x):
        return x, False

    def stored_shape(self, x):
        return tuple(x.shape)

    def scatter(self, stored, live):
        live.copy_(stored)

    def from_ckpt(self, tree, state):
        return self.set_count(state, int(tree["opt"]["count"]))

    def barrier(self) -> None:
        pass


def _place(art):
    """Where the artifacts' rank sits: its workers and worker index, its
    model shards and shard index. A flat and a hierarchical step over
    the same ranks sit at the same place: the split into tiers leaves
    chunk ownership and the state layout as they are."""
    g = art.grid
    shards = (1, 0) if g is None else (g.n_shards, g.model_index)
    return (art.n_workers, art.rank) + shards


class _DistProgram:
    """Distributed path: wraps ``dist.step.StepArtifacts``. State is one
    rank's chunked dict (master/m/v/e/count[/es]), on ``device``: its
    chunks of its model shard. Its checkpoint is the reference's global
    layout: each leaf ``worker_sizes + (n_shards, X)``, the rows of every
    (worker, shard) in the grid's rank order, the count an int32 0-d
    array; rank 0 gathers the rows leaf by leaf and writes."""

    def __init__(self, art, device):
        from repro_torch.dist.modes import get_mode
        self.art, self._device = art, device
        mode = get_mode(art.config.mode)
        self.stochastic = bool(getattr(mode.wire_codec(art.config.grad_k),
                                       "stochastic", False))
        self.hp_row = art.hp_row
        self.name = f"mode {art.config.mode!r}"

    def aot_facts(self):
        grid = self.art.grid
        return {"program": "dist", "config": self.art.config,
                "grid": None if grid is None else
                dict(zip(grid.axes, grid.sizes)),
                "n_workers": self.art.n_workers}

    def init_state(self, seed):
        return self.art.init_state(seed=seed, device=self._device)

    def device(self, state):
        return tree_leaves(state["master"])[0].device

    def step(self, state, batch, hp=None):
        return self.art.step_fn(state, batch, hp=hp)

    def stats_shape(self):
        """(n_leaves, N_FIELDS) where the mode emits stats rows, else
        None (no stats ring)."""
        from repro_torch.adapt import stats as astats
        from repro_torch.dist.modes import get_mode
        if not get_mode(self.art.config.mode).emits_stats:
            return None
        return (len(tree_leaves(self.art.layout.shapes)), astats.N_FIELDS)

    def get_count(self, state) -> int:
        return state["count"]

    def set_count(self, state, count: int):
        state["count"] = count
        return state

    def ckpt_tree(self, state):
        tree = {k: v for k, v in state.items() if k != "count"}
        tree["count"] = np.int32(state["count"])
        return tree

    def _geometry(self):
        """(stored leading shape, ranks in all, this rank's place)."""
        grid = self.art.grid
        if grid is None:
            return (self.art.n_workers, 1), self.art.n_workers, \
                self.art.rank
        lead = grid.wsizes + (grid.n_shards,)
        return lead, grid.n_workers * grid.n_shards, grid.rank

    def gather(self, x):
        """This rank's flat leaf -> the ``worker_sizes + (n_shards, X)``
        rows of every rank on rank 0 (a fresh tensor when there is more
        than one rank), None elsewhere."""
        import torch.distributed as dist
        lead, n, rank = self._geometry()
        if n == 1:
            return x.reshape(lead + (-1,)), False
        rows = torch.empty((n, x.numel()), dtype=x.dtype, device=x.device) \
            if rank == 0 else None
        dist.gather(x, list(rows.unbind(0)) if rank == 0 else None,
                    dst=0, group=self._group())
        return (rows.reshape(lead + (-1,)), True) if rank == 0 \
            else (None, False)

    def _group(self):
        grid = self.art.grid
        return self.art.group if grid is None else grid.world

    def stored_shape(self, x):
        return self._geometry()[0] + (x.numel(),)

    def scatter(self, stored, live):
        _, n, rank = self._geometry()
        live.copy_(stored.reshape(n, -1)[rank])

    def from_ckpt(self, tree, state):
        return self.set_count(state, int(tree["count"]))

    def barrier(self) -> None:
        import torch.distributed as dist
        if self._geometry()[1] > 1:
            dist.barrier(group=self._group())


# ---------------------------------------------------------------------------
# background batch prefetcher
# ---------------------------------------------------------------------------

class _Prefetcher:
    """Pulls host batches from the generator and stages them to the
    device on a background thread, ``depth`` dispatches ahead. Work is
    demand-driven: the session requests the exact dispatch sizes it will
    run (so chunks group deterministically and the consumed-batch count
    stays exact for resume). ``stacked``: a dispatch's k batches come
    stacked along a new leading axis. ``depth == 0`` pulls inline."""

    def __init__(self, batches: Iterator, place: Callable, depth: int,
                 stacked: bool):
        self._batches, self._place, self.depth = batches, place, depth
        self._stacked = stacked
        if depth > 0:
            self._plan: queue.Queue = queue.Queue()
            self._out: queue.Queue = queue.Queue(maxsize=depth)
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._fill, name="train-prefetch", daemon=True)
            self._thread.start()

    def _pull(self, k: int):
        if not self._stacked:
            return self._place(next(self._batches))
        return self._place(_stack_host([next(self._batches)
                                        for _ in range(k)]))

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._out.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _fill(self):
        while not self._stop.is_set():
            try:
                k = self._plan.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                item = self._pull(k)
            except Exception as e:  # surfaced on the consumer side
                self._put(e)
                return
            if not self._put(item):
                return

    def request(self, sizes: List[int]):
        if self.depth > 0:
            for k in sizes:
                self._plan.put(k)

    def get(self, k: int):
        if self.depth <= 0:
            return self._pull(k)
        item = self._out.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        if self.depth > 0:
            self._stop.set()
            while True:     # unblock a producer stuck on a full queue
                try:
                    self._out.get_nowait()
                except queue.Empty:
                    break
            self._thread.join(timeout=2.0)


# ---------------------------------------------------------------------------
# the session
# ---------------------------------------------------------------------------

class TrainSession:
    """Training session over one program (distributed or single-machine).

    ``run(n)`` executes exactly ``n`` optimizer steps (``n`` batches).
    ``history`` collects ``{"step", "loss"}`` entries at log boundaries
    and ``{"step", "eval"}`` entries at eval boundaries. ``stats``:
    ``dispatches`` (step or chunk calls), ``syncs`` (host reads of the
    device on the critical path, zero in steady state), ``steps``,
    ``ckpts``, ``graph_captures``, ``graph_replays``, ``compilations``,
    ``aot_loads``, ``aot_saves``.
    """

    def __init__(self, program, batches: Iterator,
                 cfg: Optional[SessionConfig] = None, *, init_arg=None,
                 state=None, log: Callable = print):
        self.cfg = cfg or SessionConfig()
        self._program = program
        self._batches = batches
        self._log = log
        self.chunk = max(1, self.cfg.scan_chunk)
        for name, every in (("log_every", self.cfg.log_every),
                            ("eval_every", self.cfg.eval_every),
                            ("ckpt_every", self.cfg.ckpt_every)):
            if every and self.chunk > 1 and every % self.chunk:
                raise ValueError(
                    f"{name}={every} must be a multiple of "
                    f"scan_chunk={self.chunk}")
        self._state = state if state is not None \
            else program.init_state(init_arg)
        self._device = program.device(self._state)
        if self.chunk > 1 and self._device.type == "cuda" and \
                program.stochastic:
            raise NotImplementedError(
                f"scan_chunk={self.chunk} on CUDA: {program.name} draws "
                "TernGrad's uniforms from a generator seeded on the host "
                "each step, which a CUDA graph would freeze; it runs with "
                "scan_chunk=1 until its kernel draws from a counter-based "
                "generator (ROADMAP.md queue 2)")
        # every unharvested step since the last log boundary (or stats
        # harvest) stays resident, plus one chunk of slack
        cover = max(self.cfg.log_every, self.cfg.stats_ring, 1)
        self._ring_len = self.chunk * (math.ceil(cover / self.chunk) + 1)
        self._ring = torch.zeros((self._ring_len,), dtype=torch.float32,
                                 device=self._device)
        sshape = program.stats_shape()
        self._sring = None if sshape is None else torch.zeros(
            (self._ring_len,) + tuple(sshape), dtype=torch.float32,
            device=self._device)
        self._slot = 0
        self._pending: Dict[int, int] = {}  # ring slot -> its unread step
        self._stat_pending: Dict[int, int] = {}
        self._step = 0                     # optimizer steps executed
        self._prefetch: Optional[_Prefetcher] = None
        self.stats = {"dispatches": 0, "syncs": 0, "steps": 0, "ckpts": 0,
                      "graph_captures": 0, "graph_replays": 0,
                      "compilations": 0, "aot_loads": 0, "aot_saves": 0}
        perf_cache.ensure_persistent_cache()   # opt-in via the env
        aot.load_or_compile(
            program.step, (self._state,), aot_dir=self.cfg.aot_dir,
            facts=dict(program.aot_facts(), chunk=self.chunk,
                       ring_len=self._ring_len),
            stats=self.stats, device=self._device)
        self._chunks = None
        if self.chunk > 1:
            self._chunks = _Chunks(
                self.chunk, self._one, program.hp_row, program.get_count,
                program.set_count, self._device, self.stats, program.name)
        # extra JSON-safe entries merged into every checkpoint manifest
        # beside "batches_consumed"
        self.ckpt_extra: Dict[str, Any] = {}
        self.history: List[Dict[str, Any]] = []
        self._ckpt_q: Optional[queue.Queue] = None
        self._ckpt_thread: Optional[threading.Thread] = None
        self._ckpt_err: Optional[BaseException] = None
        self._ckpt_stream = None
        self._capture_s: List[float] = []  # kept past close()
        self._closed = False

    @classmethod
    def from_artifacts(cls, art, batches: Iterator,
                       cfg: Optional[SessionConfig] = None, *, seed: int = 0,
                       state=None, device="cuda",
                       log: Callable = print) -> "TrainSession":
        """Distributed session over ``dist.step.make_train_step``
        artifacts, one per rank: this rank's state from
        ``art.init_state(seed, device)``, or ``state`` as given (e.g.
        ``convert.dist_state_from_numpy``). Every rank pulls the same
        global batches; the step takes its own rows."""
        return cls(_DistProgram(art, device), batches, cfg, init_arg=seed,
                   state=state, log=log)

    @classmethod
    def from_optimizer(cls, opt, loss_fn: Callable, params,
                       batches: Iterator,
                       cfg: Optional[SessionConfig] = None, *,
                       log: Callable = print) -> "TrainSession":
        """Single-machine session over a ``repro_torch.core.qadam``
        optimizer and ``loss_fn(forward_params, batch) -> 0-d tensor``.
        The session trains a copy of ``params`` on their device."""
        return cls(_SingleProgram(opt, loss_fn), batches, cfg,
                   init_arg=params, log=log)

    def _one(self, state, batch, hp=None):
        state, metrics = self._program.step(state, batch, hp)
        if "gstats" in metrics:
            return state, (metrics["loss"], metrics["gstats"])
        return state, (metrics["loss"],)

    def _sync(self, x: torch.Tensor) -> np.ndarray:
        self.stats["syncs"] += 1
        return x.cpu().numpy()

    # -- loss ring ------------------------------------------------------

    def harvest_losses(self) -> List[tuple]:
        """Pull every still-resident per-step loss off the device in ONE
        host sync; returns ``[(step, loss), ...]`` and clears the pending
        ring slots."""
        if not self._pending:
            return []
        vals = self._sync(self._ring)
        out = sorted((step, float(vals[slot]))
                     for slot, step in self._pending.items())
        self._pending.clear()
        if self.cfg.check_finite:
            for s, v in out:
                if not np.isfinite(v):
                    raise FloatingPointError(f"loss diverged at step {s}")
        return out

    def harvest_stats(self) -> List[tuple]:
        """Pull every still-resident per-step stats row block off the
        device in ONE host sync; returns ``[(step, (n_leaves, N_FIELDS)
        ndarray), ...]`` sorted by step and clears the pending slots.
        Empty for modes without ``emits_stats``."""
        if self._sring is None or not self._stat_pending:
            return []
        vals = self._sync(self._sring)
        out = sorted(((step, vals[slot])
                      for slot, step in self._stat_pending.items()),
                     key=lambda t: t[0])
        self._stat_pending.clear()
        return out

    # -- adaptive replans ----------------------------------------------

    def swap_artifacts(self, art) -> None:
        """Install other ``dist.step`` artifacts (same workers, same state
        layout: the adaptive controller's next bit plan, or another
        topology over the same ranks) between dispatches. The state
        tensors carry over untouched, so masters, moments and EF
        residuals go on bitwise from the previous plan. On the card the
        old plan's graph is dropped and the next K-step dispatch
        captures the new plan."""
        if not isinstance(self._program, _DistProgram):
            raise ValueError("swap_artifacts requires a distributed session")
        from repro_torch.dist.modes import get_mode
        old = self._program.art
        om, nm = get_mode(old.config.mode), get_mode(art.config.mode)
        if (_place(art) != _place(old) or art.layout != old.layout
                or om.chunk_sharded_moments != nm.chunk_sharded_moments
                or om.extra_state != nm.extra_state
                or om.emits_stats != nm.emits_stats):
            raise ValueError("swap_artifacts cannot change the workers, "
                             "the state layout or the stats rows")
        self._program.art = art
        self._program.hp_row = art.hp_row
        if art.prepare is not None:
            art.prepare(self._device)
        if self._chunks is not None:
            self._chunks.reset()
            self._chunks._hp_row = art.hp_row

    # -- checkpointing --------------------------------------------------

    def _raise_writer_error(self):
        if self._ckpt_err is not None:
            err, self._ckpt_err = self._ckpt_err, None
            raise err

    def _ensure_writer(self):
        if self._ckpt_thread is not None:
            return
        self._ckpt_q = queue.Queue()

        def writer():
            while True:
                item = self._ckpt_q.get()
                try:
                    if item is None:
                        return
                    self._write(*item)
                except BaseException as e:   # re-raised on the main thread
                    self._ckpt_err = e
                finally:
                    item = None    # the host copy is free once written
                    self._ckpt_q.task_done()

        self._ckpt_thread = threading.Thread(
            target=writer, name="train-ckpt-writer", daemon=True)
        self._ckpt_thread.start()

    def _write(self, tree, step: int, extra: Dict, done) -> None:
        if done is not None:
            done.synchronize()     # the device-to-host copies landed
        store.save(self.cfg.ckpt_dir, tree, step=step,
                   keep=self.cfg.ckpt_keep, extra=extra)

    def _snapshot(self, tree):
        """The checkpoint tree as a host copy that later steps cannot
        touch, and the event that marks its copies done (None on the
        CPU); (None, None) on a rank that does not write. Leaf by leaf:
        the program gathers the stored leaf (rank 0's rows of every rank
        when W > 1), ``ckpt_codec`` encodes a moment leaf where it lies
        (#5 on the card), and the result is copied into pinned memory on
        a side stream. The compute stream waits for those copies before
        its next in-place write. A gathered or encoded leaf is a
        transient on the device: the host waits for its copy before the
        next leaf, so at most one is held."""
        prog = self._program
        cd = get_codec(self.cfg.ckpt_codec) if self.cfg.ckpt_codec else None
        cuda = self._device.type == "cuda"
        if cuda:
            if self._ckpt_stream is None:
                self._ckpt_stream = torch.cuda.Stream(self._device)
            side = self._ckpt_stream
            main = torch.cuda.current_stream(self._device)
        writes = True

        def copy(x: torch.Tensor, fresh: bool) -> torch.Tensor:
            if not cuda:
                return x if fresh else x.clone()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                h = _host_copy(x)
            if fresh:
                side.synchronize()
            return h

        def leaf(key, x):
            nonlocal writes
            if not isinstance(x, torch.Tensor):
                return x
            x, fresh = prog.gather(x)
            if x is None:
                writes = False
                return None
            if cd is not None and store.codec_eligible(key, x):
                b = cd.encode(x)
                return store.EncodedLeaf(
                    WireBuffer(payload=copy(b.payload, True),
                               scale=copy(b.scale, True), spec=b.spec,
                               shape=b.shape), store.dtype_name(x.dtype))
            return copy(x, fresh)

        host = tree_map_with_path(leaf, tree)
        if not writes:
            return None, None
        if not cuda:
            return host, None
        done = torch.cuda.Event()
        done.record(side)
        main.wait_event(done)
        return host, done

    def checkpoint(self, step: Optional[int] = None):
        """Snapshot the live state to the host (an asynchronous copy on
        CUDA: the hot loop goes on) and write it out; with
        ``cfg.ckpt_async`` the npz and manifest are written by the writer
        thread, off the critical path. Every rank calls it; rank 0
        writes."""
        self._raise_writer_error()
        if not self.cfg.ckpt_dir:
            raise ValueError("SessionConfig.ckpt_dir is not set")
        step = self._step if step is None else step
        host, done = self._snapshot(self._program.ckpt_tree(self._state))
        self.stats["ckpts"] += 1
        if host is None:           # a rank that does not write
            return
        extra = {"batches_consumed": self._step, **self.ckpt_extra}
        if self.cfg.ckpt_async:
            self._ensure_writer()
            self._ckpt_q.put((host, step, extra, done))
        else:
            self._write(host, step, extra, done)

    def wait_for_checkpoints(self):
        """Block until every queued checkpoint is on disk (every rank
        meets rank 0's writes here)."""
        if self._ckpt_q is not None:
            self._ckpt_q.join()
        self._raise_writer_error()
        self._program.barrier()

    def resume(self, ckpt_dir: Optional[str] = None,
               step: Optional[int] = None) -> int:
        """Restore the latest (or given) checkpoint under ``ckpt_dir``
        (default ``cfg.ckpt_dir``): state, step count and data-stream
        position - the generator is fast-forwarded past every batch the
        checkpointed run consumed, so going on is bitwise an unbroken
        run. Returns the restored step (0 when there is no checkpoint).
        Must precede the first ``run()``.

        The stored leaves are read one at a time into host memory (a
        codec leaf decoded on the state's device, K6 on the card) and
        this rank's part is copied into the state's own tensors, which
        keep their addresses: the device holds the state and at most one
        leaf, never a second state."""
        if self._step:
            raise RuntimeError("resume() must precede run()")
        d = ckpt_dir or self.cfg.ckpt_dir
        if not d:
            raise ValueError("no checkpoint directory given")
        found = store.latest_step(d) if step is None else step
        if found is None:
            return 0
        prog = self._program
        tree = prog.ckpt_tree(self._state)
        live = dict(_tensor_leaves(tree))
        like = tree_map(
            lambda x: torch.empty(prog.stored_shape(x), dtype=x.dtype,
                                  device="meta")
            if isinstance(x, torch.Tensor) else x, tree)

        def sink(key, t):
            if key not in live:
                return t
            prog.scatter(t, live[key])
            return None
        got = store.restore(d, like, device=self._device, step=found,
                            sink=sink)
        self._state = prog.from_ckpt(got, self._state)
        extra = store.read_extra(d, step=found)
        consumed = int(extra.get("batches_consumed", found))
        for _ in range(consumed):
            next(self._batches)
        self._step = consumed
        return found

    # -- the hot loop ---------------------------------------------------

    @staticmethod
    def _boundary_hits(i0: int, k: int, every: int) -> List[int]:
        if every <= 0:
            return []
        return [s for s in range(i0 + 1, i0 + k + 1) if s % every == 0]

    def run(self, steps: int) -> List[Dict[str, Any]]:
        """Run exactly ``steps`` more optimizer steps; returns the tail of
        ``history``. The host reads the device only at log and eval
        boundaries and after the first and last dispatch of the run."""
        if self._closed:
            raise RuntimeError("session is closed")
        if steps <= 0:
            return []
        if self._prefetch is None:
            self._prefetch = _Prefetcher(
                self._batches, lambda b: stage_batch(b, self._device),
                self.cfg.prefetch, stacked=self.chunk > 1)
        q, r = divmod(steps, self.chunk)
        plan = [self.chunk] * q + ([r] if r else [])
        self._prefetch.request(plan)
        hist_start = len(self.history)
        run_start = self._step
        t0 = time.perf_counter()
        for di, k in enumerate(plan):
            batch = self._prefetch.get(k)
            if self._slot + k > self._ring_len:
                self._slot = 0
            sl, i0 = self._slot, self._step
            if self._chunks is None:
                self._state, out = self._one(self._state, batch)
                outs = tuple(o[None] for o in out)
            else:
                self._state, outs = self._chunks(self._state, batch, k)
            self._ring[sl:sl + k].copy_(outs[0])
            if self._sring is not None:
                self._sring[sl:sl + k].copy_(outs[1])
            for j in range(k):
                self._pending[sl + j] = i0 + j + 1
                if self._sring is not None:
                    self._stat_pending[sl + j] = i0 + j + 1
            self._slot += k
            self._step += k
            self.stats["dispatches"] += 1
            self.stats["steps"] += k
            log_hits = self._boundary_hits(i0, k, self.cfg.log_every)
            last = di == len(plan) - 1
            if self.cfg.log_every > 0 and (log_hits or di == 0 or last):
                want = set(log_hits)
                if di == 0 or last:
                    want.add(self._step)
                rate = (time.perf_counter() - t0) / max(1, self._step
                                                         - run_start)
                for s, v in self.harvest_losses():
                    if s in want:
                        self.history.append({"step": s, "loss": v})
                        self._log(f"step {s:5d}  loss {v:.4f}  "
                                  f"({rate:.2f}s/step)")
            # evals and checkpoints fire per boundary crossed, pinned to
            # the true post-dispatch step: a boundary inside a tail
            # dispatch must not label later state with an earlier step
            # (cadences are chunk multiples: at most one hit each)
            if self.cfg.eval_fn is not None and \
                    self._boundary_hits(i0, k, self.cfg.eval_every):
                ev = self.cfg.eval_fn(self._state)
                self.history.append({"step": self._step, "eval": ev})
                self._log(f"  eval @{self._step}: {ev}")
            if self.cfg.ckpt_every and self.cfg.ckpt_dir and \
                    self._boundary_hits(i0, k, self.cfg.ckpt_every):
                self.checkpoint()
        return self.history[hist_start:]

    # -- accessors / lifecycle ------------------------------------------

    @property
    def state(self):
        """The live train state (between dispatches): ``{"params",
        "opt"}`` single-machine, the rank's chunked dict distributed."""
        return self._state

    @property
    def step(self) -> int:
        return self._step

    @property
    def capture_seconds(self) -> List[float]:
        """Host seconds of each CUDA graph capture so far (none off the
        card or at scan_chunk=1)."""
        if self._chunks is None:
            return list(self._capture_s)
        return list(self._chunks.capture_s)

    def close(self):
        """Stop the prefetch thread, flush pending checkpoints, and
        release what the session holds for its steps: the captured CUDA
        graph with its static batch and output buffers, and the staged
        batches. The state stays readable (``state``). Dropping the
        chunk runner and the prefetcher also breaks the session's only
        reference cycles (their bound method and closure), so once the
        caller drops the session and its state the device memory is free
        without a garbage collection. A second call does nothing."""
        if self._closed:
            return
        self._closed = True
        if self._prefetch is not None:
            self._prefetch.close()
            self._prefetch = None
        if self._chunks is not None:
            self._capture_s = list(self._chunks.capture_s)
            self._chunks.reset()
            self._chunks = None
        self.wait_for_checkpoints()
        if self._ckpt_q is not None:
            self._ckpt_q.put(None)
            self._ckpt_thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# single-machine chunked step builders (``opt.multistep`` re-exports them)
# ---------------------------------------------------------------------------

def _chunked(opt, step: Callable, donate: bool) -> Callable:
    """``fn(params, state, stacked) -> (params, state, losses or None)``:
    K = the leading size of ``stacked`` steps of ``step((params, state),
    row, hp) -> ((params, state), loss or None)``. ``donate``: the given
    tensors are updated in place and returned, and on CUDA the K steps
    become one CUDA graph per K and set of state tensors (the first call
    eager, the second captured and replayed). Without it the steps run on
    copies, eagerly."""
    runners: Dict[tuple, _Chunks] = {}
    stats = {"graph_captures": 0, "graph_replays": 0}

    def get_count(st):
        return st[1].count

    def set_count(st, count):
        st[1] = st[1]._replace(count=count)
        return st

    def one(st, row, hp):
        (p, s), loss = step((st[0], st[1]), row, hp)
        st[0], st[1] = p, s
        return st, None if loss is None else (loss,)

    def fn(params, state, stacked):
        if not donate:
            params = tree_map(lambda p: p.detach().clone(), params)
            state = state._replace(**{f: tree_map(torch.clone,
                                                  getattr(state, f))
                                      for f in ("m", "v", "e")})
        k = tree_leaves(stacked)[0].shape[0]
        dev = tree_leaves(params)[0].device
        tensors = [t for tr in (params, state.m, state.v, state.e)
                   for t in tree_leaves(tr)]
        key = (k, donate, tuple(t.data_ptr() for t in tensors))
        run = runners.get(key)
        if run is None:
            run = runners[key] = _Chunks(k, one, opt.hp_row, get_count,
                                         set_count, dev, stats,
                                         "the optimizer")
        st, outs = run([params, state], stacked, k)
        # a graph's loss buffer is overwritten by its next replay
        return st[0], st[1], None if outs is None else outs[0].clone()

    fn.stats = stats
    return fn


def make_chunked_update(opt, donate: bool = True) -> Callable:
    """K optimizer updates a call: ``fn(params, state, gstack)`` with
    ``gstack`` a gradient tree stacked over a leading step axis. Returns
    (params, state); with ``donate`` the given ones, updated in place."""
    def step(ps, g, hp):
        p, s = ps
        upd, s2 = opt.update(g, s, p, hp=hp)
        apply_updates_(p, upd)
        return (p, s2), None
    inner = _chunked(opt, step, donate)

    def fn(params, state, gstack):
        with torch.no_grad():
            p, s, _ = inner(params, state, gstack)
        return p, s
    fn.stats = inner.stats
    return fn


def make_chunked_train_step(opt, loss_fn: Callable,
                            donate: bool = True) -> Callable:
    """K full steps a call (Q_x forward params -> gradients -> update ->
    apply): ``fn(params, state, batches)`` with ``batches`` a batch tree
    stacked over a leading step axis. Returns (params, state, the (K,)
    losses); with ``donate`` the given params and state, updated in
    place."""
    program = _SingleProgram(opt, loss_fn)

    def step(ps, batch, hp):
        out, metrics = program.step({"params": ps[0], "opt": ps[1]}, batch,
                                    hp)
        return (out["params"], out["opt"]), metrics["loss"]
    return _chunked(opt, step, donate)
