"""The port's distributed step at two and four workers against the JAX
package: gloo processes (``torch.multiprocessing`` spawn, a
``FileStore``), each on its own rows of the global batch, against the
reference's ``make_train_step`` on simulated CPU devices in a subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
``tests/test_distributed.py`` runs it), both from the reference's initial
state. Three steps: losses within rel 2.3e-4 and the master within rel
L2 4e-6 (the tiers of ``tests/test_torch_dist.py``), for the paper's
``qadam`` and the fp32 ``dp_adam`` here, ``ef_sgd`` and ``efadam`` in
``tests/test_torch_dist_modes_workers.py``, ``terngrad`` in
``tests/test_torch_dist_terngrad_workers.py`` (the runs are in
``RUNS``). A planted fault must fail the gate: one worker's
row dropped from ``worker_mean`` (``qadam``), or every worker reading
worker 0's chunk of the reduced gradient (``dp_adam``) or worker 0's
scale columns (``ef_sgd``, whose smoke model has 501 tokens, so that
chunks end inside 256-element blocks).
"""
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
from repro_torch.dist.modes import worker_mean as t_worker_mean
from repro_torch.dist.step import TrainConfig as TTC
from repro_torch.dist.step import make_train_step as t_make_train_step
from repro_torch.launch import mesh as TM
from repro_torch.models.model import Model as TModel

# JAX and the reference are imported by the parent's tests and by the
# reference subprocess only (and by the ranks that replay the reference's
# TernGrad draws): the spawned gloo ranks import this module and start
# faster without them.
HERE = Path(__file__).resolve().parent
STEPS, BATCH = 3, 8
WIDTHS = (2, 4)
BASE = dict(alpha=1e-3, beta=0.99, theta=0.999, grad_k=6, weight_k=7,
            weight_absolute=True)      # test_torch_dist.BASE
# name -> (TrainConfig keywords, the smoke model's vocabulary or None)
RUNS = {
    "qadam": (BASE, None),
    "dp_adam": (dict(BASE, mode="dp_adam"), None),
    "efadam": (dict(BASE, mode="efadam", weight_absolute=False), None),
    "terngrad": (dict(BASE, mode="terngrad", alpha=2e-2, grad_k=None,
                      weight_k=None), None),
    "ef_sgd": (dict(BASE, mode="ef_sgd", alpha=1e-2, beta=0.9, grad_k=None,
                    weight_k=None), 501),
    # every lane of the adaptive plan on two leaves of the smoke model
    # (its 12 leaves in the reference's order)
    "adaptive": (dict(BASE, mode="adaptive", bit_plan=(
        "blockwise:256", "log:2", "log:6", "log:30", "log:126",
        "uniform_amax:14:w16") * 2), None),
}
FAULTS = ("qadam", "dp_adam", "ef_sgd")


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


def _config(get_config, vocab):
    import dataclasses
    cfg = get_config("yi-6b", smoke=True)
    return cfg if vocab is None else dataclasses.replace(cfg,
                                                         vocab_size=vocab)


def _reference_main(out_dir: str, names, widths=WIDTHS) -> None:
    """Subprocess body: the reference's runs ``names`` at ``widths`` (2
    and 4) workers on simulated CPU devices. The initial states are saved first
    (the port's ranks start from them while the reference compiles),
    then the trajectories."""
    import jax
    from repro.configs import get_config as jget
    from repro.dist.step import TrainConfig as JTC
    from repro.dist.step import make_train_step as j_make_train_step
    from repro.models.model import Model as JModel
    from test_torch_dist import SEQ, _reference
    for name in names:
        kw, vocab = RUNS[name]
        jm = JModel(_config(jget, vocab))
        for w in widths:
            mesh = jax.make_mesh((w, 1), ("data", "model"))
            art = j_make_train_step(jm, mesh, JTC(**kw,
                                                  worker_axes=("data",)))
            init = jax.tree.map(np.asarray,
                                art.init_state(jax.random.PRNGKey(0)))
            _save(os.path.join(out_dir, f"init_{name}{w}.npz"),
                  state=np.array(init, dtype=object), seq=SEQ)
    for name in names:
        kw, vocab = RUNS[name]
        jm = JModel(_config(jget, vocab))
        for w in widths:
            _, losses, master = _reference(jm, kw, STEPS, w, BATCH)
            _save(os.path.join(out_dir, f"ref_{name}{w}.npz"),
                  losses=np.asarray(losses),
                  master=np.array(master, dtype=object))


def _reference_draws(seed, t, leaf, worker, n, device):
    """The reference's TernGrad uniforms for (step, leaf, worker)."""
    import jax
    key = jax.random.fold_in(jax.random.PRNGKey(seed), t)
    key = jax.random.fold_in(jax.random.fold_in(key, leaf), worker)
    return torch.from_numpy(np.array(jax.random.uniform(key, (n,)))).to(
        device)


def _plant(name: str, run: str) -> None:
    """Install this run's planted fault (or the replayed draws)."""
    import repro_torch.dist.collectives as C
    import repro_torch.dist.modes.qadam as Q
    import repro_torch.dist.step as S
    if name == "terngrad":
        S.draw_uniform = _reference_draws
    if run != "fault":
        return
    if name == "qadam":
        Q.worker_mean = lambda rows: t_worker_mean(rows[:-1])
    else:                                   # dp_adam, ef_sgd
        C.worker_index = lambda group: 0


def _port_worker(rank, n_workers, store_path, init_path, out_dir, name):
    """Spawned process body: one gloo rank of the port's step for run
    ``name``, the clean run and then, where there is one, the run with
    its planted fault."""
    torch.set_num_threads(1)
    TM.make_process_group(
        "cpu", store=torch.distributed.FileStore(store_path, n_workers),
        rank=rank, world_size=n_workers)
    try:
        ref = np.load(init_path, allow_pickle=True)
        init, seq = ref["state"].item(), int(ref["seq"])
        kw, vocab = RUNS[name]
        tm = TModel(_config(tget, vocab))
        results = {}
        for run in ("clean", "fault") if name in FAULTS else ("clean",):
            _plant(name, run)
            art = t_make_train_step(tm, torch.distributed.group.WORLD,
                                    TTC(**kw))
            state = dist_state_from_numpy(init, rank, n_workers, "cpu")
            batches = tbatches(tm.cfg, seq, BATCH)
            losses = []
            for _ in range(STEPS):
                state, m = art.step_fn(state, {
                    k: torch.from_numpy(v) for k, v in next(batches).items()})
                losses.append(float(m["loss"]))
            results[f"{run}:losses"] = np.asarray(losses)
            for p, t in _paths(state["master"]):
                results[f"{run}:{p}"] = t.numpy()
        _save(os.path.join(out_dir, f"port_{name}{n_workers}_{rank}.npz"),
              **results)
    finally:
        TM.close_process_group()


def _wait_for(path: Path, proc, timeout: float = 300.0) -> Path:
    deadline = time.monotonic() + timeout
    while not path.exists():
        if proc.poll() not in (None, 0):
            raise RuntimeError("the reference subprocess failed:\n"
                               + proc.stdout.read())
        if time.monotonic() > deadline:
            raise TimeoutError(f"no {path.name} from the reference")
        time.sleep(0.2)
    return path


def start_reference(tmp_path_factory, names, widths=WIDTHS):
    """The reference subprocess for runs ``names`` at ``widths`` workers,
    started once per test module; yields (out_dir, proc)."""
    out = tmp_path_factory.mktemp("ref")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    code = (f"import sys; sys.path.insert(0, {str(HERE)!r}); "
            "import test_torch_dist_workers as t; "
            f"t._reference_main({str(out)!r}, {tuple(names)!r}, "
            f"{tuple(widths)!r})")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    yield out, proc
    if proc.poll() is None:
        proc.kill()
    proc.wait(timeout=30)
    proc.stdout.close()


def _spawn(name, n_workers, init_path, out_dir, timeout=240):
    import torch.multiprocessing as mp
    ctx = mp.spawn(_port_worker,
                   args=(n_workers, str(out_dir / f"store{n_workers}"),
                         str(init_path), str(out_dir), name),
                   nprocs=n_workers, join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{n_workers} gloo ranks did not finish")
    return [np.load(out_dir / f"port_{name}{n_workers}_{r}.npz")
            for r in range(n_workers)]


def check_against_reference(reference, tmp_path, name, n_workers):
    """Run ``name`` on ``n_workers`` gloo ranks and hold it against the
    reference: the clean run passes the gate, the planted fault fails
    it."""
    from test_torch_dist import _gate
    out, proc = reference
    ranks = _spawn(name, n_workers,
                   _wait_for(out / f"init_{name}{n_workers}.npz", proc),
                   tmp_path)
    ref = np.load(_wait_for(out / f"ref_{name}{n_workers}.npz", proc),
                  allow_pickle=True)
    want_l = ref["losses"]
    # the reference's master leaves are (n_workers, 1, c): rank r's chunk
    # is row r
    want = {p: np.asarray(a).reshape(n_workers, -1)
            for p, a in _paths(ref["master"].item())}
    for run in ("clean", "fault") if name in FAULTS else ("clean",):
        losses = ranks[0][f"{run}:losses"]
        for r in ranks:
            np.testing.assert_array_equal(r[f"{run}:losses"], losses)
        got = {p: np.stack([r[f"{run}:{p}"] for r in ranks]) for p in want}
        print(f"{name} at {n_workers} workers, {run}: ", end="")
        ok = _gate(want_l, want, losses, got)
        if run == "clean":
            assert ok == (True, True)
        else:
            assert ok != (True, True)


NAMES = ("qadam", "dp_adam")


@pytest.fixture(scope="module")
def multi_reference(tmp_path_factory):
    yield from start_reference(tmp_path_factory, NAMES)


@pytest.mark.parametrize("n_workers", WIDTHS)
def test_workers_against_reference(multi_reference, tmp_path, n_workers):
    check_against_reference(multi_reference, tmp_path, "qadam", n_workers)


@pytest.mark.parametrize("n_workers", WIDTHS)
def test_dp_adam_workers_against_reference(multi_reference, tmp_path,
                                           n_workers):
    check_against_reference(multi_reference, tmp_path, "dp_adam", n_workers)
