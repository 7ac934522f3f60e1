"""Dry run of the port at production scale: every (arch x input shape x
grid) without a card, its memory, operations, bytes and collective
bytes a rank, and the roofline terms (port of ``repro/launch/dryrun.py``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dry.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b \\
      --shape train_4k --smoke --mesh single        # the test harness

There is no XLA to lower and compile: the dry run takes rank 0 of the
grid and runs the port's real step on the ``meta`` device, where every
tensor has its shape and dtype and no storage, so it touches no real
memory and launches no kernel:

  * ``train`` shapes: ``dist.step.make_train_step`` and one
    ``step_fn(state, batch)``, the state from ``init_state`` at the
    rank's shard shapes; ``prefill`` and ``decode`` shapes:
    ``dist.serve.make_serve_step``'s step on the rank's model shard of
    the float32 parameters, its part of the cache, and the global
    inputs it slices;
  * the grid's process groups are recording stand-ins
    (:class:`RecordingDist` in place of ``torch.distributed`` in
    ``dist.collectives`` and ``adapt.stats``): each collective records
    (kind, group size, result bytes, the group's ranks) and returns;
    the bytes a rank moves are the reference's ring model
    (:func:`event_bytes`), each collective's time that over the slowest
    link its group crosses (``launch.mesh.link_bw``);
  * operations: ``torch.utils.flop_counter.FlopCounterMode``; bytes: the
    sum of every operator's inputs and outputs (views excluded); eager
    PyTorch fuses nothing, so this is the port's own traffic;
  * the hand-written kernels are charged their own traffic and
    operations (``repro_torch.kernels.meta``: each input read once, each
    output written once; 2 M K N for the products), never their plain
    versions' passes;
  * memory: ``argument_bytes`` the rank's state (or parameters and
    cache) and batch, ``output_bytes`` what the step returns,
    ``temp_bytes`` the high-water mark of the storages the step made
    (tracked by the dispatch mode, released by weakref finalizers),
    ``code_bytes`` the kernel library's size where one is loaded, else
    null. The only real memory a dry run touches is the host staging the
    step makes anyway (a step's hyperparameter row, the log grid's
    tables: ``host_staging_bytes``); a tensor on a card fails it.

Every layer runs, so nothing is calibrated (``--no-calibrate`` is
accepted; ``calibrate_s`` is 0). The roofline uses the H100 SXM5 data
sheet (``launch.mesh``): a model of the card, not a measurement.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import weakref
from typing import Dict, List, Optional

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
HARDWARE = "H100 SXM5 data sheet"


# --------------------------------------------------------------------------
# collectives: the recording stand-in and the ring model
# --------------------------------------------------------------------------

def event_bytes(kind: str, n: int, size: float) -> float:
    """The reference's ring model per collective (n = group size, S =
    result bytes): all_gather S(n-1)/n; reduce_scatter S(n-1) (input =
    S n); all_reduce 2S(n-1)/n; all_to_all S(n-1)/n; permute S."""
    if kind == "all-gather":
        return size * (n - 1) / n
    if kind == "reduce-scatter":
        return size * (n - 1)
    if kind == "all-reduce":
        return 2 * size * (n - 1) / n
    if kind == "all-to-all":
        return size * (n - 1) / n
    return size


def ring_totals(events) -> Dict:
    """Per-kind modeled bytes of ``(kind, n, result bytes, ...)`` events,
    their ``"total"`` and ``"counts"``: the reference's
    ``parse_collectives`` result for the same collectives."""
    agg = {k: 0.0 for k in KINDS}
    cnt = {k: 0 for k in KINDS}
    for kind, n, size, *_ in events:
        if kind not in agg:
            continue
        agg[kind] += event_bytes(kind, n, size)
        cnt[kind] += 1
    out = dict(agg)
    out["total"] = sum(agg.values())
    out["counts"] = cnt
    return out


class RecordingGroup:
    """A process group of the dry run's grid: its global ranks."""

    def __init__(self, members):
        self.members = tuple(int(r) for r in members)

    @property
    def size(self) -> int:
        return len(self.members)

    def __repr__(self):
        return f"RecordingGroup({self.size} ranks)"


class _Done:
    def wait(self):
        return True


class RecordingDist:
    """The ``torch.distributed`` calls the port's collectives make, for
    rank ``rank``: each records ``(kind, group size, result bytes,
    members)`` in :attr:`events` and returns (the results are meta
    tensors already)."""

    class ReduceOp:
        SUM, MAX = "sum", "max"

    class P2POp:
        def __init__(self, op, tensor, peer, group=None):
            self.op, self.tensor, self.peer, self.group = (op, tensor, peer,
                                                           group)

    def __init__(self, rank: int = 0):
        self.rank = rank
        self.events: List[tuple] = []

    def _record(self, kind, group, nbytes):
        self.events.append((kind, group.size, int(nbytes), group.members))

    @staticmethod
    def _nbytes(t):
        return t.numel() * t.element_size()

    def get_world_size(self, group=None):
        return group.size

    def get_rank(self, group=None):
        return group.members.index(self.rank)

    def get_global_rank(self, group, rank):
        return group.members[rank]

    def get_backend(self, group=None):
        return "nccl"

    def all_reduce(self, x, op=None, group=None, async_op=False):
        self._record("all-reduce", group, self._nbytes(x))

    def all_gather_into_tensor(self, out, x, group=None, async_op=False):
        self._record("all-gather", group, self._nbytes(out))

    def all_to_all_single(self, out, x, *args, group=None, **kw):
        self._record("all-to-all", group, self._nbytes(out))

    def reduce_scatter_tensor(self, out, x, op=None, group=None,
                              async_op=False):
        self._record("reduce-scatter", group, self._nbytes(out))

    def isend(self, *a, **k):
        raise RuntimeError("the dry run batches point-to-point ops")

    irecv = isend

    def batch_isend_irecv(self, ops):
        if ops:
            self._record("collective-permute", ops[0].group,
                         self._nbytes(ops[0].tensor))
        return [_Done() for _ in ops]

    def barrier(self, group=None, **kw):
        self._record("barrier", group, 0)


def recording_grid(sizes, axes, rec: RecordingDist):
    """Rank ``rec.rank``'s ``launch.mesh.Grid`` over ``sizes`` x ``axes``
    (ranks row-major, as ``make_grid``), its groups recording stand-ins
    (None for a group of one rank)."""
    import itertools
    from repro_torch.launch.mesh import Grid, _unravel
    world = math.prod(sizes)
    coords = _unravel(rec.rank, sizes)
    all_coords = [_unravel(r, sizes) for r in range(world)]
    groups = {}
    for k in range(len(axes) + 1):
        for sub in itertools.combinations(range(len(axes)), k):
            fixed = [i for i in range(len(axes)) if i not in sub]
            members = [r for r, c in enumerate(all_coords)
                       if all(c[i] == coords[i] for i in fixed)]
            key = tuple(axes[i] for i in sub)
            groups[key] = RecordingGroup(members) if len(members) > 1 \
                else None
    world_g = groups[tuple(axes)] or RecordingGroup([rec.rank])
    return Grid(axes=tuple(axes), sizes=tuple(sizes), coords=tuple(coords),
                groups=groups, world=world_g)


@contextlib.contextmanager
def recording(rec: RecordingDist):
    """Route the port's ``torch.distributed`` calls to ``rec``."""
    from repro_torch.adapt import stats as AS
    from repro_torch.dist import collectives as C
    saved = (C.dist, AS.dist)
    C.dist = AS.dist = rec
    try:
        yield rec
    finally:
        C.dist, AS.dist = saved


# --------------------------------------------------------------------------
# operations, bytes and memory on the meta device
# --------------------------------------------------------------------------

# allocations and aliases: no bytes move
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "lift_fresh", "detach", "alias"}


def _tensor_bytes(t) -> int:
    """A tensor's bytes, no more than its storage's (an expanded view
    reads its storage once)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


class Meter:
    """Counts every operator's traffic and the live storages the step
    makes (and kernels' charges via ``kernels.meta``), beside a
    ``FlopCounterMode``."""

    def __init__(self, flop_counter, known_storages=()):
        self.fc = flop_counter
        self.bytes = 0
        self.real = 0               # operator outputs on a card
        self.host_bytes = 0         # host staging (numpy rows, tables)
        self.paused = 0
        self.excluded_flops = 0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.known = set(known_storages)
        self.live: Dict[int, int] = {}
        self.cur = self.peak = 0
        self._stack: List[int] = []

    # kernels.meta's accountant
    def begin(self):
        self._stack.append(self.fc.get_total_flops())
        self.paused += 1

    def end(self, name, traffic, flops, result):
        self.paused -= 1
        self.excluded_flops += self.fc.get_total_flops() - self._stack.pop()
        if name is None:
            return
        k = self.kernels.setdefault(name, {"launches": 0, "bytes": 0,
                                           "flops": 0.0})
        k["launches"] += 1
        k["bytes"] += int(traffic)
        k["flops"] += float(flops)
        self.bytes += int(traffic)
        self.track(result)

    @property
    def kernel_flops(self) -> float:
        return sum(k["flops"] for k in self.kernels.values())

    @property
    def flops(self) -> float:
        return self.fc.get_total_flops() - self.excluded_flops + \
            self.kernel_flops

    def _release(self, key):
        self.cur -= self.live.pop(key, 0)

    def track(self, out):
        import torch
        from torch.utils._pytree import tree_flatten
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            if t.device.type != "meta":
                if t.device.type == "cpu":
                    self.host_bytes += t.numel() * t.element_size()
                else:
                    self.real += 1
                continue
            s = t.untyped_storage()
            key = s._cdata
            if key in self.live or key in self.known:
                continue
            self.live[key] = s.nbytes()
            self.cur += s.nbytes()
            self.peak = max(self.peak, self.cur)
            weakref.finalize(s, self._release, key)

    def op(self, func, args, kwargs, out):
        import torch
        from torch.utils._pytree import tree_flatten
        if self.paused:
            return
        self.track(out)
        if func.is_view or func.overloadpacket.__name__ in _NO_TRAFFIC:
            return
        self.bytes += sum(_tensor_bytes(t) for t in tree_flatten(
            (args, kwargs, out))[0] if isinstance(t, torch.Tensor))


@contextlib.contextmanager
def metering(known_storages=()):
    """A :class:`Meter` over everything run inside, installed as the
    kernels' accountant."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels import meta as KM

    fc = FlopCounterMode(display=False)
    meter = Meter(fc, known_storages)

    class _Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            meter.op(func, args, kwargs or {}, out)
            return out

    saved = KM.accountant
    KM.accountant = meter
    try:
        with fc, _Mode():
            yield meter
    finally:
        KM.accountant = saved


def _storages(tree) -> set:
    import torch
    from torch.utils._pytree import tree_flatten
    return {t.untyped_storage()._cdata for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor)}


def _nbytes(tree) -> int:
    """Bytes of a tree's tensors (a view of a larger batch counts its
    own elements)."""
    import torch
    from torch.utils._pytree import tree_flatten
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


# --------------------------------------------------------------------------
# one configuration
# --------------------------------------------------------------------------

def _meta_batch(cfg, gbatch, seq, enc_seq, *, train=True):
    """The global batch on the meta device, with the data pipeline's
    dtypes."""
    import torch
    m = "meta"
    b = {}
    if cfg.input_mode == "embeddings":
        b["embeds"] = torch.empty((gbatch, seq, cfg.d_model), device=m)
    else:
        b["tokens"] = torch.empty((gbatch, seq), dtype=torch.int32,
                                  device=m)
    if cfg.input_mode == "audio+tokens":
        b["audio"] = torch.empty((gbatch, enc_seq, cfg.d_model), device=m)
    if train:
        b["targets"] = torch.empty((gbatch, seq), dtype=torch.int32,
                                   device=m)
        b["mask"] = torch.empty((gbatch, seq), device=m)
    return b


def apply_model_overrides(cfg, overrides: Optional[dict]):
    """dataclasses.replace on ModelConfig, with ssm./moe. nesting."""
    if not overrides:
        return cfg
    top, ssm_o, moe_o = {}, {}, {}
    for k, v in overrides.items():
        if k.startswith("ssm."):
            ssm_o[k[4:]] = v
        elif k.startswith("moe."):
            moe_o[k[4:]] = v
        else:
            top[k] = v
    if ssm_o and cfg.ssm is not None:
        top["ssm"] = dataclasses.replace(cfg.ssm, **ssm_o)
    if moe_o and cfg.moe is not None:
        top["moe"] = dataclasses.replace(cfg.moe, **moe_o)
    return dataclasses.replace(cfg, **top)


def _train_run(model, grid, tc, batch, art):
    """(argument trees, run) of one train step on rank 0."""
    from repro_torch.dist.step import shard_batch
    state = art.init_state(seed=0, device="meta")
    mine = shard_batch(batch, grid.worker_index, grid.n_workers,
                       grid.model_index, grid.n_shards)

    def run():
        return art.step_fn(state, batch)
    return (state, mine), run


def _serve_run(model, grid, kind, gbatch, seq, enc_seq, W, shardable,
               batch):
    """(argument trees, run) of one prefill or decode step on rank 0."""
    import torch
    from repro_torch.dist.serve import make_serve_step
    from repro_torch.dist.step import ServeConfig
    sc = ServeConfig(worker_axes=W, batch_dim_shardable=shardable)
    step, _, _ = make_serve_step(model, grid, sc, kind=kind)
    params = step.shard_params(model.init(device="meta"))
    if kind == "prefill":
        rows = step.rows(gbatch) if step.batch_sharded and \
            gbatch % step.n_workers == 0 else slice(0, gbatch)
        mine = {k: v[rows] for k, v in batch.items()}
        return (params, mine), lambda: step(params, batch)
    cfg = model.cfg
    cache = step.init_cache(gbatch, seq, device="meta", encoder_seq=enc_seq)
    if cfg.input_mode == "embeddings":
        inputs = {"embeds": torch.empty((gbatch, 1, cfg.d_model),
                                        device="meta")}
    else:
        inputs = {"token": torch.empty((gbatch, 1), dtype=torch.int32,
                                       device="meta")}
    rows = step.rows(gbatch)
    mine = {k: v[rows] for k, v in inputs.items()}
    return (params, cache, mine), lambda: step(params, inputs, cache,
                                               seq - 1)


def build_and_compile(arch: str, shape_name: str, multi_pod: bool,
                      grid_override=None, smoke: bool = False,
                      train_overrides: Optional[dict] = None,
                      model_overrides: Optional[dict] = None,
                      calibrate: bool = True, adaptive: bool = False,
                      adapt_budget: float = 0.6) -> Dict:
    """One (arch, shape, grid) on rank 0, on the meta device; the
    reference's result keys. ``grid_override``: (sizes, axes)."""
    import torch
    from repro_torch import build
    from repro_torch.configs import INPUT_SHAPES, get_config, \
        shape_applicable
    from repro_torch.dist.step import TrainConfig, make_train_step
    from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_BF16, link_bw,
                                         production_grid_shape)
    from repro_torch.models.model import Model
    from repro_torch.train.loop import comm_bytes_per_step

    t_start = time.time()
    if not shape_applicable(arch, shape_name):
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": "full-attention arch: long_500k needs "
                          "sub-quadratic attention (DESIGN.md §5)"}
    cfg = apply_model_overrides(get_config(arch, smoke=smoke),
                                model_overrides)
    seq, gbatch, kind = INPUT_SHAPES[shape_name]
    if smoke:
        seq, gbatch = 64, 8
    sizes, axes = grid_override or production_grid_shape(
        multi_pod=multi_pod)
    ms = dict(zip(axes, sizes))
    n_dev = math.prod(sizes)
    enc_seq = 0
    if cfg.arch_type == "encdec":
        enc_seq = cfg.encoder_seq if smoke else 1536  # 1500 padded /16
    W = tuple(a for a in ("pod", "data") if a in ms)
    batch_shardable = bool(W) and gbatch % math.prod(ms[a] for a in W) == 0
    result = {"arch": arch, "shape": shape_name, "kind": kind,
              "mesh": "x".join(str(s) for s in sizes),
              "n_devices": n_dev, "skipped": False,
              "seq": seq, "global_batch": gbatch, "hardware": HARDWARE}

    rec = RecordingDist(rank=0)
    model = Model(cfg)
    launched = _launch_counts()
    with torch.no_grad(), recording(rec):
        grid = recording_grid(sizes, axes, rec)
        batch = _meta_batch(cfg, gbatch, seq, enc_seq,
                            train=kind != "decode")
        if kind == "train":
            tc = TrainConfig(**(train_overrides or {}))
            if adaptive:
                from repro_torch.adapt.controller import plan_for_model
                tc, art, rep = plan_for_model(model, grid, tc,
                                              budget_ratio=adapt_budget)
                result["bit_plan"] = rep
            else:
                art = make_train_step(model, grid, tc)
            result["comm_accounting"] = comm_bytes_per_step(art, tc)
            args, run = _train_run(model, grid, tc, batch, art)
        else:
            args, run = _serve_run(model, grid, kind, gbatch, seq, enc_seq,
                                   W, batch_shardable, batch)
        t_lower = time.time()
        rec.events.clear()
        with metering(_storages(args)) as meter:
            out = run()
        t_run = time.time()
    if _launch_counts() != launched:
        raise AssertionError("the dry run launched a kernel")
    if meter.real:
        raise AssertionError(f"the dry run made {meter.real} tensors on a "
                             "card")

    coll = ring_totals(rec.events)
    t_coll = sum(event_bytes(k, n, s) / link_bw(m)
                 for k, n, s, m in rec.events if k in KINDS)
    flops, nbytes = float(meter.flops), float(meter.bytes)
    terms = {"compute_s": flops / PEAK_FLOPS_BF16,
             "memory_s": nbytes / HBM_BW, "collective_s": t_coll}
    bottleneck = max(terms, key=terms.get)
    n_active = cfg.n_active_params()
    if kind == "train":
        model_flops = 6 * n_active * gbatch * seq / n_dev
    elif kind == "prefill":
        model_flops = 2 * n_active * gbatch * seq / n_dev
    else:
        model_flops = 2 * n_active * gbatch / n_dev
    lib = build.loaded_path()
    arg_bytes = [_nbytes(a) for a in args]
    result.update({
        "lower_s": round(t_lower - t_start, 2),
        "compile_s": round(t_run - t_lower, 2),
        "calibrate_s": 0,
        "hlo_flops": flops, "hlo_bytes": nbytes,
        "collective_bytes": coll["total"],
        "collectives": {k: coll[k] for k in KINDS},
        "collective_counts": coll["counts"],
        "barriers": sum(1 for e in rec.events if e[0] == "barrier"),
        "host_staging_bytes": meter.host_bytes,
        "roofline": terms, "bottleneck": bottleneck.replace("_s", ""),
        "model_flops": model_flops,
        "useful_flops_ratio": (model_flops / flops) if flops else None,
        "n_params": cfg.n_params(), "n_active_params": n_active,
        "kernels": meter.kernels,
        "memory": {
            "argument_bytes": sum(arg_bytes),
            "state_bytes": arg_bytes[0] if kind == "train" else None,
            "batch_bytes": arg_bytes[-1],
            "output_bytes": _nbytes(out),
            "temp_bytes": meter.peak,
            "code_bytes": lib.stat().st_size if lib else None,
        },
    })
    return result


def _launch_counts():
    """Every kernel wrapper's launch counter (none may move)."""
    from repro_torch.comm import kernels as K
    from repro_torch.comm import matmul as MM
    from repro_torch.kernels import adam_ef as A
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.serve import paged as P
    out = {}
    for mod in (K, MM, A, FA, P):
        for k, v in vars(mod).items():
            if "launches" in k and isinstance(v, int):
                out[f"{mod.__name__}.{k}"] = v
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL here")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configs and grids (test harness)")
    ap.add_argument("--no-calibrate", action="store_true",
                    help="accepted; the meta run counts every layer")
    ap.add_argument("--adaptive", action="store_true",
                    help="train shapes: solve the repro_torch.adapt bit "
                         "plan and report per-leaf lanes + projected wire "
                         "bytes")
    ap.add_argument("--adapt-budget", type=float, default=0.6,
                    help="a2a byte budget vs the fixed log-grid wire")
    ap.add_argument("--train-overrides", default=None,
                    help="json dict of TrainConfig overrides")
    ap.add_argument("--model-overrides", default=None,
                    help='json dict, e.g. {"moe.dispatch":"sort"}')
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCH_IDS, INPUT_SHAPES

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    overrides = json.loads(args.train_overrides) if args.train_overrides \
        else None
    m_overrides = json.loads(args.model_overrides) if args.model_overrides \
        else None
    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
                grid_override = None
                if args.smoke:
                    grid_override = (((2, 2, 2), ("pod", "data", "model"))
                                     if mp else ((2, 2), ("data", "model")))
                    tag = (f"{arch} x {shape} x smoke-"
                           f"{'2x2x2' if mp else '2x2'}")
                try:
                    res = build_and_compile(
                        arch, shape, mp, grid_override=grid_override,
                        smoke=args.smoke, train_overrides=overrides,
                        model_overrides=m_overrides,
                        calibrate=not args.no_calibrate,
                        adaptive=args.adaptive,
                        adapt_budget=args.adapt_budget)
                    res["multi_pod"] = mp
                    if overrides:
                        res["train_overrides"] = overrides
                    if m_overrides:
                        res["model_overrides"] = m_overrides
                    if res.get("skipped"):
                        print(f"[SKIP] {tag}: {res['reason']}", flush=True)
                    else:
                        r = res["roofline"]
                        useful = res["useful_flops_ratio"]
                        print(
                            f"[OK] {tag}: flops={res['hlo_flops']:.3g} "
                            f"bytes={res['hlo_bytes']:.3g} "
                            f"coll={res['collective_bytes']:.3g} "
                            f"bottleneck={res['bottleneck']} "
                            f"(c={r['compute_s']:.4f}s m={r['memory_s']:.4f}s"
                            f" x={r['collective_s']:.4f}s) "
                            f"useful={useful and round(useful, 3)} "
                            f"compile={res['compile_s']}s (a model on the "
                            f"{HARDWARE})", flush=True)
                        if res.get("bit_plan"):
                            bp = res["bit_plan"]
                            lanes = {}
                            for row in bp["rows"]:
                                lanes[row["spec"]] = \
                                    lanes.get(row["spec"], 0) + 1
                            print(
                                "     bit plan: "
                                + " ".join(f"{s}x{n}" for s, n
                                           in sorted(lanes.items()))
                                + f" | a2a {bp['plan_bytes']}B/step "
                                f"(budget {bp['budget_bytes']}B, fixed "
                                f"{bp['baseline_bytes']}B)", flush=True)
                except Exception as ex:  # noqa
                    res = {"arch": arch, "shape": shape, "multi_pod": mp,
                           "error": f"{type(ex).__name__}: {ex}"}
                    print(f"[FAIL] {tag}: {res['error']}", flush=True)
                results.append(res)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(res) + "\n")
    return results


if __name__ == "__main__":
    main()
