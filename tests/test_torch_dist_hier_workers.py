"""The port's hierarchical topology at four workers against the JAX
package: four gloo ranks (``torch.multiprocessing`` spawn, a
``FileStore``) on a ``(pod=2, data=2)`` grid (``launch.mesh.make_grid``)
against the reference's ``make_train_step`` with
``HierarchicalTopology(2, 2)`` on a ``(pod=2, data=2)`` mesh of four
simulated CPU devices in a subprocess, both from the reference's
initial state (``test_torch_dist_workers.py``'s harness, here over
grids).

Tiers:
  * ``qadam`` and ``efadam``, three steps: losses within rel 2.3e-4 and
    the master within rel L2 4e-6, the tiers of
    ``tests/test_torch_dist.py`` (the reference's own drift between its
    equivalent programs is at least this, ROADMAP.md queue 3); the
    measured drifts are printed (``pytest -s``);
  * within the port, bitwise: ``HierarchicalTopology(2, 1)`` on a
    ``(pod=2, data=1)`` grid is the flat step at two workers (one device
    a node); a node's two devices hold the same m, v, e and encode the
    same payload rows; the bytes the inter tier's all-to-all moves
    equal ``leaf_tier_nbytes``'s;
  * a planted fault (each device ships the rows of the other intra
    position) fails the gate;
  * the ``adaptive`` and ``terngrad`` modes at 2x2:
    ``tests/test_torch_dist_hier_modes_workers.py``.

This module also holds the grid harness that those and
``tests/test_torch_model_axis_workers.py`` run on.
"""
import dataclasses
import hashlib
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config as tget
from repro_torch.convert import dist_state_from_numpy
from repro_torch.data.pipeline import batch_for_model as tbatches
from repro_torch.dist.step import TrainConfig as TTC
from repro_torch.dist.step import make_train_step as t_make_train_step
from repro_torch.launch import mesh as TM
from repro_torch.models.model import Model as TModel

HERE = Path(__file__).resolve().parent
SEQ, BATCH, STEPS = 32, 8, 3
BASE = dict(alpha=1e-3, beta=0.99, theta=0.999, grad_k=6, weight_k=7,
            weight_absolute=True)      # test_torch_dist.BASE
# the adaptive plan of test_torch_dist_workers: every lane on two leaves
PLAN = ("blockwise:256", "log:2", "log:6", "log:30", "log:126",
        "uniform_amax:14:w16") * 2


@dataclasses.dataclass(frozen=True)
class Run:
    """One trajectory: the architecture's smoke model, the grid
    ``(pod, data, model)`` (pod 0: no pod axis), the topology
    ``(nodes, devices)`` or None (flat) and the TrainConfig keywords."""

    arch: str
    grid: tuple
    kw: dict
    topology: tuple = None
    steps: int = STEPS


RUNS = {
    "hier_qadam": Run("yi-6b", (2, 2, 1), BASE, (2, 2)),
    "hier_efadam": Run("yi-6b", (2, 2, 1),
                       dict(BASE, mode="efadam", weight_absolute=False),
                       (2, 2)),
    "hier_adaptive": Run("yi-6b", (2, 2, 1),
                         dict(BASE, mode="adaptive", bit_plan=PLAN), (2, 2)),
    # test_torch_dist_workers' TernGrad settings; the reference's draws
    # replayed by (step, leaf, inter-tier worker)
    "hier_terngrad": Run("yi-6b", (2, 2, 1),
                         dict(BASE, mode="terngrad", alpha=2e-2, grad_k=None,
                              weight_k=None), (2, 2)),
}


def _paths(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{path}/{k}")
    else:
        yield path, tree


def _save(path, **arrays):
    """np.savez, published by a rename once complete."""
    tmp = f"{path}.tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# the reference, in a subprocess on four simulated devices
# ---------------------------------------------------------------------------

def _reference_main(out_dir: str, module: str, names) -> None:
    """Subprocess body: the reference's runs ``names`` of ``module``'s
    RUNS. The initial states are saved first (the port's ranks start
    from them while the reference compiles), then each run's losses and
    final state."""
    import importlib

    import jax
    from repro.configs import get_config as jget
    from repro.data.pipeline import batch_for_model as jbatches
    from repro.dist import topology as JT
    from repro.dist.step import TrainConfig as JTC
    from repro.dist.step import make_train_step as j_make_train_step
    from repro.models.model import Model as JModel
    runs = importlib.import_module(module).RUNS
    arts = {}
    for name in names:
        run = runs[name]
        pod, data, model = run.grid
        if pod:
            mesh = jax.make_mesh((pod, data, model),
                                 ("pod", "data", "model"))
        else:
            mesh = jax.make_mesh((data, model), ("data", "model"))
        topo = (JT.HierarchicalTopology(*run.topology) if run.topology
                else JT.FlatTopology())
        art = j_make_train_step(JModel(jget(run.arch, smoke=True)), mesh,
                                JTC(**run.kw, worker_axes=("pod", "data"),
                                    topology=topo))
        state = art.init_state(jax.random.PRNGKey(0))
        _save(os.path.join(out_dir, f"init_{name}.npz"),
              state=np.array(jax.tree.map(np.asarray, state), dtype=object))
        arts[name] = (art, state)
    for name in names:
        art, state = arts[name]
        step = jax.jit(art.step_fn)
        batches = jbatches(jget(runs[name].arch, smoke=True), SEQ, BATCH)
        losses = []
        for _ in range(runs[name].steps):
            state, metrics = step(state, next(batches))
            losses.append(float(metrics["loss"]))
        _save(os.path.join(out_dir, f"ref_{name}.npz"),
              losses=np.asarray(losses),
              state=np.array(jax.tree.map(np.asarray, state), dtype=object))


def start_reference(tmp_path_factory, module: str, names):
    """The reference subprocess for ``module``'s runs ``names``, started
    once per test module; yields (out_dir, proc)."""
    out = tmp_path_factory.mktemp("ref")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    code = (f"import sys; sys.path.insert(0, {str(HERE)!r}); "
            "import test_torch_dist_hier_workers as t; "
            f"t._reference_main({str(out)!r}, {module!r}, {tuple(names)!r})")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    yield out, proc
    if proc.poll() is None:
        proc.kill()
    proc.wait(timeout=30)
    proc.stdout.close()


def wait_for(path: Path, proc, timeout: float = 400.0) -> Path:
    deadline = time.monotonic() + timeout
    while not path.exists():
        if proc.poll() not in (None, 0):
            raise RuntimeError("the reference subprocess failed:\n"
                               + proc.stdout.read())
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path.name} from the reference")
        time.sleep(0.2)
    return path


# ---------------------------------------------------------------------------
# the port, four gloo ranks
# ---------------------------------------------------------------------------

def make_step(run: Run, kw=None, topology="run"):
    """(grid, artifacts) of ``run`` on this rank (``kw`` replaces the
    run's TrainConfig keywords, ``topology`` its topology)."""
    from repro_torch.dist import topology as T
    pod, data, model = run.grid
    grid = TM.make_grid(pod=pod, data=data, model=model, device="cpu")
    topo = run.topology if topology == "run" else topology
    tc = TTC(**(run.kw if kw is None else kw),
             topology=T.HierarchicalTopology(*topo) if topo
             else T.FlatTopology())
    return grid, t_make_train_step(TModel(tget(run.arch, smoke=True)), grid,
                                   tc)


def run_steps(art, state, run: Run, steps=None, batches=None):
    """``steps`` steps of ``art`` from ``state`` (on ``batches``, by
    default the run's stream from its start): (state, losses)."""
    if batches is None:
        batches = tbatches(tget(run.arch, smoke=True), SEQ, BATCH)
    losses = []
    for _ in range(run.steps if steps is None else steps):
        state, m = art.step_fn(state, {
            k: torch.from_numpy(v) for k, v in next(batches).items()})
        losses.append(float(m["loss"]))
    return state, np.asarray(losses)


def state_arrays(state, prefix: str, keys=("master",)):
    """``{prefix:key:path: array}`` of a rank's state."""
    return {f"{prefix}:{k}:{p}": t.numpy() for k in keys
            for p, t in _paths(state[k])}


def port_state(init_path, grid):
    init = np.load(init_path, allow_pickle=True)["state"].item()
    return dist_state_from_numpy(init, grid.worker_index, grid.n_workers,
                                 "cpu", grid.model_index, grid.n_shards)


def _rank_main(rank, world, store_path, out_dir, module, body, args):
    """Spawned process body: one gloo rank running ``module.body(rank,
    out_dir, *args)``, which returns the arrays this rank saves."""
    import importlib
    torch.set_num_threads(1)
    TM.make_process_group(
        "cpu", store=torch.distributed.FileStore(store_path, world),
        rank=rank, world_size=world)
    try:
        fn = getattr(importlib.import_module(module), body)
        results = fn(rank, out_dir, *args)
        _save(os.path.join(out_dir, f"port_{body}_{rank}.npz"), **results)
    finally:
        TM.close_process_group()


def spawn(module: str, body: str, out_dir: Path, args=(), world: int = 4,
          timeout: float = 400.0):
    """Run ``module.body`` on ``world`` gloo ranks; each rank's saved
    arrays, in rank order."""
    import torch.multiprocessing as mp
    ctx = mp.spawn(_rank_main,
                   args=(world, str(out_dir / f"store_{body}"),
                         str(out_dir), module, body, args),
                   nprocs=world, join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{world} gloo ranks did not finish")
    return [dict(np.load(out_dir / f"port_{body}_{r}.npz"))
            for r in range(world)]


def gate(ref_path, ranks, prefix: str):
    """(losses within rel 2.3e-4, master within rel L2 4e-6) of the
    ranks' run ``prefix`` against the reference's saved run: the
    reference's master leaves are ``worker_sizes + (n_shards, c)``, rank
    r's chunk its row r."""
    from test_torch_dist import _gate
    ref = np.load(ref_path, allow_pickle=True)
    n = len(ranks)
    want = {p: np.asarray(a).reshape(n, -1)
            for p, a in _paths(ref["state"].item()["master"])}
    losses = ranks[0][f"{prefix}:losses"]
    for r in ranks:
        np.testing.assert_array_equal(r[f"{prefix}:losses"], losses)
    got = {p: np.stack([r[f"{prefix}:master:{p}"] for r in ranks])
           for p in want}
    print(f"{prefix}: ", end="")
    return _gate(ref["losses"], want, losses, got)


# ---------------------------------------------------------------------------
# this module's rank body
# ---------------------------------------------------------------------------

def _digest(t: torch.Tensor) -> np.ndarray:
    return np.frombuffer(hashlib.sha256(t.contiguous().numpy().tobytes())
                         .digest(), np.uint8)


def hier_body(rank, out_dir, init_dir, names, degenerate):
    """The hierarchical runs ``names`` on this rank: each clean run from
    the reference's initial state; qadam's payload digests, inter-tier
    bytes and planted fault; the adaptive run's accounting; TernGrad's
    payload digests on the reference's draws; and with ``degenerate``,
    on a (pod=2, data=1) and a flat grid of the first two ranks, the
    W x 1 degeneracy."""
    import repro_torch.dist.collectives as C
    from repro_torch.adapt.controller import verify_accounting
    from repro_torch.train.loop import comm_bytes_per_step
    out = {}
    for name in names:
        run = RUNS[name]
        grid, art = make_step(run)
        state = port_state(Path(init_dir) / f"init_{name}.npz", grid)
        if name == "hier_terngrad":
            import repro_torch.dist.step as S
            from test_torch_dist_workers import _reference_draws
            draws, S.draw_uniform = S.draw_uniform, _reference_draws
            sent, tiered = [], C.exchange_rows_tiered

            def watch(rows, tiers, groups):
                sent.append(_digest(rows))
                return tiered(rows, tiers, groups)
            C.exchange_rows_tiered = watch
            try:
                state, losses = run_steps(art, state, run)
            finally:
                S.draw_uniform, C.exchange_rows_tiered = draws, tiered
            out[f"{name}:losses"] = losses
            out["terngrad:sent"] = np.stack(sent)
            out.update(state_arrays(state, name))
            continue
        if name != "hier_qadam":
            state, losses = run_steps(art, state, run)
            out[f"{name}:losses"] = losses
            out.update(state_arrays(state, name))
            if name == "hier_adaptive":
                verify_accounting(art, art.config)
                out["adaptive:verified"] = np.ones(1)
            continue
        # qadam: the payload rows each device encodes and the bytes the
        # inter tier moves, counted in the run's first step
        sent, moved = [], [0]
        tiered, exch = C.exchange_rows_tiered, C.exchange_rows

        def watch_tiered(rows, tiers, groups):
            sent.append(_digest(rows))
            return tiered(rows, tiers, groups)

        def watch_exchange(rows, group):
            moved[0] += rows.nbytes
            return exch(rows, group)
        C.exchange_rows_tiered, C.exchange_rows = watch_tiered, \
            watch_exchange
        batches = tbatches(tget(run.arch, smoke=True), SEQ, BATCH)
        try:
            state, l1 = run_steps(art, state, run, 1, batches)
        finally:
            C.exchange_rows_tiered, C.exchange_rows = tiered, exch
        out["qadam:sent"] = np.stack(sent)
        out["qadam:moved"] = np.asarray([moved[0]])
        out["qadam:accounted"] = np.asarray(
            [comm_bytes_per_step(art, art.config)["update_exchange_bytes"]])
        state, l2 = run_steps(art, state, run, run.steps - 1, batches)
        out["hier_qadam:losses"] = np.concatenate([l1, l2])
        out.update(state_arrays(state, "hier_qadam",
                                ("master", "m", "v", "e")))
        # planted fault: each device ships the other intra position's rows
        def swapped(rows, tiers, groups):
            if not tiers.hierarchical:
                return exch(rows, groups.inter)
            j = 1 - C.worker_index(groups.intra)
            grid_rows = rows.reshape((tiers.n_inter, tiers.n_intra)
                                     + rows.shape[1:])
            return exch(grid_rows[:, j].contiguous(), groups.inter)
        C.exchange_rows_tiered = swapped
        try:
            state = port_state(Path(init_dir) / f"init_{name}.npz", grid)
            state, losses = run_steps(art, state, run)
        finally:
            C.exchange_rows_tiered = tiered
        out["fault:losses"] = losses
        out.update(state_arrays(state, "fault"))
    # W x 1: HierarchicalTopology(2, 1) on (pod=2, data=1) against the
    # flat step on (data=2), the first two ranks, from model.init
    if not degenerate:
        return out
    sub = torch.distributed.new_group([0, 1])
    if rank < 2:
        for label, run, topo in (
                ("wx1", Run("yi-6b", (2, 1, 1), BASE, (2, 1)), (2, 1)),
                ("flat2", Run("yi-6b", (0, 2, 1), BASE), None)):
            grid = _sub_grid(sub, run.grid, rank)
            art = t_make_train_step(TModel(tget("yi-6b", smoke=True)), grid,
                                    TTC(**BASE, topology=_topo(topo)))
            assert art.tiers.hierarchical == (topo is not None)
            state, losses = run_steps(art, art.init_state(0, "cpu"), run)
            out[f"{label}:losses"] = losses
            out.update(state_arrays(state, label, ("master", "m", "v", "e")))
    return out


def _topo(topo):
    from repro_torch.dist import topology as T
    return T.HierarchicalTopology(*topo) if topo else T.FlatTopology()


def _sub_grid(group, geometry, rank):
    """A two-rank grid over ``group`` (ranks 0 and 1 of four)."""
    pod, data, _ = geometry
    if pod:
        axes, sizes, coords = ("pod", "data", "model"), (pod, data, 1), \
            (rank, 0, 0)
        groups = {(): None, ("pod",): group, ("data",): None,
                  ("model",): None, ("pod", "data"): group,
                  ("pod", "model"): group, ("data", "model"): None,
                  ("pod", "data", "model"): group}
    else:
        axes, sizes, coords = ("data", "model"), (data, 1), (rank, 0)
        groups = {(): None, ("data",): group, ("model",): None,
                  ("data", "model"): group}
    return TM.Grid(axes=axes, sizes=sizes, coords=coords, groups=groups,
                   world=group)


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

MODULE = "test_torch_dist_hier_workers"


def start_hier(tmp_path_factory, names, degenerate):
    """The reference's runs ``names`` in a subprocess and the port's on
    four spawned ranks (``hier_body``): yields (out_dir, proc, ranks)."""
    gen = start_reference(tmp_path_factory, MODULE, names)
    out, proc = next(gen)
    for name in names:
        wait_for(out / f"init_{name}.npz", proc)
    work = tmp_path_factory.mktemp("port")
    ranks = spawn(MODULE, "hier_body", work, (str(out), names, degenerate))
    yield out, proc, ranks
    for _ in gen:
        pass


@pytest.fixture(scope="module")
def hier(tmp_path_factory):
    yield from start_hier(tmp_path_factory, ("hier_qadam", "hier_efadam"),
                          True)


@pytest.mark.parametrize("name", ["hier_qadam", "hier_efadam"])
def test_hierarchical_against_reference(hier, name):
    out, proc, ranks = hier
    ok = gate(wait_for(out / f"ref_{name}.npz", proc), ranks, name)
    assert ok == (True, True)


def test_planted_fault_fails_the_gate(hier):
    out, proc, ranks = hier
    assert gate(wait_for(out / "ref_hier_qadam.npz", proc), ranks,
                "fault") != (True, True)


def test_node_devices_hold_the_same_state(hier):
    """Ranks (node, 0) and (node, 1) hold bitwise the same m, v, e (their
    master chunks differ: each owns its own) and encode the same payload
    rows every leaf; nodes differ."""
    _, _, ranks = hier
    for node in (0, 1):
        a, b = ranks[2 * node], ranks[2 * node + 1]
        np.testing.assert_array_equal(a["qadam:sent"], b["qadam:sent"])
        for k in a:
            if k.startswith(("hier_qadam:m:", "hier_qadam:v:",
                             "hier_qadam:e:")):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert not np.array_equal(ranks[0]["qadam:sent"], ranks[2]["qadam:sent"])


def test_inter_bytes_equal_the_accounting(hier):
    """One step's all-to-all bytes over the inter tier equal
    ``comm_bytes_per_step``'s exchange figure (``leaf_tier_nbytes``'s
    ``n_inter`` rows a leaf)."""
    _, _, ranks = hier
    for r in ranks:
        assert int(r["qadam:moved"][0]) == int(r["qadam:accounted"][0])


def test_one_device_a_node_is_the_flat_step(hier):
    """``HierarchicalTopology(2, 1)`` on a (pod=2, data=1) grid (its
    tiered path, one device a node) is bitwise the flat step at two
    workers: losses, master, m, v and e."""
    _, _, ranks = hier
    for r in ranks[:2]:
        keys = [k for k in r if k.startswith("wx1:")]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(
                r[k], r["flat2:" + k[len("wx1:"):]], err_msg=k)
