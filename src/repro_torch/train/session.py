"""TrainSession: the prefetching training loop of both programs (port
of ``repro/train/session.py``):

  * the distributed path, Algorithms 2+3 (``repro_torch.dist.step``
    ``StepArtifacts``): ``TrainSession.from_artifacts(art, batches)``;
  * the single-machine path, Algorithm 1 (``repro_torch.core.qadam``):
    ``TrainSession.from_optimizer(opt, loss_fn, params, batches)``.

    sess = TrainSession.from_artifacts(art, batches, cfg)
    sess.run(1000)                 # 1000 optimizer steps
    sess.close()

One single-machine step is ``opt.forward_params`` (Q_x), the loss and its
gradients at those weights (autograd), ``opt.update`` (Q_g + EF) and
``apply_updates``; one distributed step is ``art.step_fn``. The hot loop
does not wait on the device in steady state:

  * **prefetch** - a background thread pulls numpy batches from the
    generator and stages them to the device (pinned host copy, then a
    non-blocking copy), ``prefetch`` batches deep.
  * **device-resident losses** - each step's loss is written into a
    device ring buffer; the host reads the ring with one copy per log
    boundary (and after the first step), never per step. ``stats``
    counts ``dispatches`` and ``syncs`` as the reference does, so a test
    can assert that steady-state steps make zero host syncs.
  * the step count, alpha_t and theta_t live on the host
    (``QAdamState.count``), so no step reads the device for them.

The reference's scan chunking (``scan_chunk``), checkpoints, resume
and AOT artifacts wait for later slices (ROADMAP.md queue 1).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.core.qadam import apply_updates
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass
class SessionConfig:
    log_every: int = 10        # history/log cadence; 0 = never harvest
    prefetch: int = 2          # staged batches in flight; 0 = synchronous
    check_finite: bool = True  # raise on non-finite harvested loss


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


class _SingleProgram:
    """Single-machine path: a ``repro_torch.core.qadam`` optimizer plus a
    ``loss_fn(forward_params, batch) -> 0-d tensor``. State is
    ``{"params": ..., "opt": QAdamState}``."""

    def __init__(self, opt, loss_fn):
        self.opt, self.loss_fn = opt, loss_fn

    def init_state(self, params):
        # a private copy: the session replaces its state every step
        params = tree_map(lambda p: p.detach().clone(), params)
        return {"params": params, "opt": self.opt.init(params)}

    def device(self, state):
        return tree_leaves(state["params"])[0].device

    def step(self, state, batch):
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
            upd, s2 = self.opt.update(tree_unflatten(p, grads), s, p)
            del grads
            p2 = apply_updates(p, upd)
        return {"params": p2, "opt": s2}, {"loss": loss.detach()}


class _DistProgram:
    """Distributed path: wraps ``dist.step.StepArtifacts``. State is one
    rank's chunked dict (master/m/v/e/count), on ``device``."""

    def __init__(self, art, device):
        self.art, self._device = art, device

    def init_state(self, seed):
        return self.art.init_state(seed=seed, device=self._device)

    def device(self, state):
        return tree_leaves(state["master"])[0].device

    def step(self, state, batch):
        return self.art.step_fn(state, batch)


class _Prefetcher:
    """Pulls host batches from the generator and stages them to the
    device on a background thread, ``depth`` batches ahead. Work is
    demand-driven: the session requests the exact number of batches it
    will run. ``depth == 0`` pulls inline."""

    def __init__(self, batches: Iterator, place: Callable, depth: int):
        self._batches, self._place, self.depth = batches, place, depth
        if depth > 0:
            self._plan: queue.Queue = queue.Queue()
            self._out: queue.Queue = queue.Queue(maxsize=depth)
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._fill, name="train-prefetch", daemon=True)
            self._thread.start()

    def _pull(self):
        return self._place(next(self._batches))

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
                self._plan.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                item = self._pull()
            except Exception as e:  # surfaced on the consumer side
                self._put(e)
                return
            if not self._put(item):
                return

    def request(self, n: int):
        if self.depth > 0:
            for _ in range(n):
                self._plan.put(1)

    def get(self):
        if self.depth <= 0:
            return self._pull()
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


class TrainSession:
    """Training session over one program (distributed or single-machine).

    ``run(n)`` executes exactly ``n`` optimizer steps (``n`` batches).
    ``history`` collects ``{"step", "loss"}`` entries at log boundaries.
    ``stats``: ``dispatches`` (step calls), ``syncs`` (host reads of the
    device on the critical path, zero in steady state), ``steps``.
    """

    def __init__(self, program, batches: Iterator,
                 cfg: Optional[SessionConfig] = None, *, init_arg=None,
                 state=None, log: Callable = print):
        self.cfg = cfg or SessionConfig()
        self._program = program
        self._batches = batches
        self._log = log
        self._state = state if state is not None \
            else program.init_state(init_arg)
        self._device = program.device(self._state)
        # every unharvested step since the last log boundary stays
        # resident, plus one slot of slack
        self._ring_len = max(self.cfg.log_every, 1) + 1
        self._ring = torch.zeros((self._ring_len,), dtype=torch.float32,
                                 device=self._device)
        self._slot = 0
        self._pending: Dict[int, int] = {}  # ring slot -> its unread step
        self._step = 0                     # optimizer steps executed
        self._prefetch: Optional[_Prefetcher] = None
        self.history: List[Dict[str, Any]] = []
        self.stats = {"dispatches": 0, "syncs": 0, "steps": 0}
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

    # -- the hot loop ---------------------------------------------------

    def run(self, steps: int) -> List[Dict[str, Any]]:
        """Run exactly ``steps`` more optimizer steps; returns the tail of
        ``history``. The host reads the device only at log boundaries and
        after the first and last step of the run."""
        if self._closed:
            raise RuntimeError("session is closed")
        if steps <= 0:
            return []
        if self._prefetch is None:
            self._prefetch = _Prefetcher(
                self._batches, lambda b: stage_batch(b, self._device),
                self.cfg.prefetch)
        self._prefetch.request(steps)
        hist_start = len(self.history)
        run_start = self._step
        t0 = time.perf_counter()
        every = self.cfg.log_every
        for di in range(steps):
            batch = self._prefetch.get()
            if self._slot == self._ring_len:
                self._slot = 0
            self._state, metrics = self._program.step(self._state, batch)
            self._ring[self._slot] = metrics["loss"]
            self._step += 1
            self._pending[self._slot] = self._step
            self._slot += 1
            self.stats["dispatches"] += 1
            self.stats["steps"] += 1
            hit = every > 0 and self._step % every == 0
            if every > 0 and (hit or di == 0 or di == steps - 1):
                rate = (time.perf_counter() - t0) / max(1, self._step
                                                         - run_start)
                for s, v in self.harvest_losses():
                    if s == self._step:
                        self.history.append({"step": s, "loss": v})
                        self._log(f"step {s:5d}  loss {v:.4f}  "
                                  f"({rate:.2f}s/step)")
        return self.history[hist_start:]

    # -- accessors / lifecycle ------------------------------------------

    @property
    def state(self):
        """The live train state (between steps): ``{"params", "opt"}``
        single-machine, the rank's chunked dict distributed."""
        return self._state

    @property
    def step(self) -> int:
        return self._step

    def close(self):
        """Stop the prefetch thread."""
        if self._closed:
            return
        self._closed = True
        if self._prefetch is not None:
            self._prefetch.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
