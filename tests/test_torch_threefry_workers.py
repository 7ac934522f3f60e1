"""The distributed ``terngrad`` mode at four gloo workers against the JAX
package with the port's own threefry draws (no replay), by the machinery
and at the tiers of ``tests/test_torch_dist_workers.py``: each rank
records its draws, and every draw is bitwise the reference's
``jax.random.uniform(fold_in(fold_in(fold_in(PRNGKey(seed), t), leaf),
worker))``; the losses agree across ranks and the trajectory is the
reference's at the trajectory tier (losses within rel 2.3e-4, the master
within rel L2 4e-6).
"""
import os
import time

import numpy as np
import pytest
import torch

import test_torch_dist_workers as W
from repro_torch.configs import get_config as tget
from repro_torch.convert import dist_state_from_numpy
from repro_torch.core import uniforms
from repro_torch.data.pipeline import batch_for_model as tbatches
from repro_torch.dist.step import TrainConfig as TTC
from repro_torch.dist.step import make_train_step as t_make_train_step
from repro_torch.launch import mesh as TM
from repro_torch.models.model import Model as TModel

# JAX is imported by the parent's test only: the spawned ranks import
# this module and start faster without it
N_WORKERS = 4


def _rank(rank, n_workers, store_path, init_path, out_dir):
    """Spawned process body: one gloo rank of the port's ``terngrad``
    step from the reference's initial state, its draws recorded."""
    torch.set_num_threads(1)
    TM.make_process_group(
        "cpu", store=torch.distributed.FileStore(store_path, n_workers),
        rank=rank, world_size=n_workers)
    try:
        seen = []
        draw = uniforms.draw

        def rec(keys, leaf, n, backend=None):
            u = draw(keys, leaf, n, backend=backend)
            seen.append((leaf, u.clone()))
            return u
        uniforms.draw = rec
        ref = np.load(init_path, allow_pickle=True)
        init, seq = ref["state"].item(), int(ref["seq"])
        kw, vocab = W.RUNS["terngrad"]
        tm = TModel(W._config(tget, vocab))
        art = t_make_train_step(tm, torch.distributed.group.WORLD, TTC(**kw))
        state = dist_state_from_numpy(init, rank, n_workers, "cpu")
        batches = tbatches(tm.cfg, seq, W.BATCH)
        losses = []
        for _ in range(W.STEPS):
            state, m = art.step_fn(state, {
                k: torch.from_numpy(v) for k, v in next(batches).items()})
            losses.append(float(m["loss"]))
        out = {"losses": np.asarray(losses),
               "leaves": np.asarray([leaf for leaf, _ in seen])}
        out.update({f"u{j}": u.numpy() for j, (_, u) in enumerate(seen)})
        out.update({f"m:{p}": t.numpy()
                    for p, t in W._paths(state["master"])})
        W._save(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        TM.close_process_group()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    yield from W.start_reference(tmp_path_factory, ("terngrad",),
                                 (N_WORKERS,))


def test_terngrad_four_workers_own_draws(reference, tmp_path):
    import jax
    import torch.multiprocessing as mp
    from test_torch_dist import _gate
    out, proc = reference
    init = W._wait_for(out / f"init_terngrad{N_WORKERS}.npz", proc)
    ctx = mp.spawn(_rank, args=(N_WORKERS, str(tmp_path / "store"),
                                str(init), str(tmp_path)),
                   nprocs=N_WORKERS, join=False)
    deadline = time.monotonic() + 240
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{N_WORKERS} gloo ranks did not finish")
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(N_WORKERS)]
    ref = np.load(W._wait_for(out / f"ref_terngrad{N_WORKERS}.npz", proc),
                  allow_pickle=True)
    seed = W.RUNS["terngrad"][0].get("seed", 0)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["losses"], ranks[0]["losses"])
        leaves = got["leaves"]
        n_leaves = len(leaves) // W.STEPS
        assert n_leaves > 1 and n_leaves * W.STEPS == len(leaves)
        for j, leaf in enumerate(leaves):
            key = jax.random.fold_in(jax.random.PRNGKey(seed),
                                     j // n_leaves + 1)
            key = jax.random.fold_in(jax.random.fold_in(key, int(leaf)), r)
            u = got[f"u{j}"]
            want = np.asarray(jax.random.uniform(key, u.shape))
            np.testing.assert_array_equal(want.view(np.int32),
                                          u.view(np.int32))
    want = {p: np.asarray(a).reshape(N_WORKERS, -1)
            for p, a in W._paths(ref["master"].item())}
    got = {p: np.stack([r[f"m:{p}"] for r in ranks]) for p in want}
    print(f"terngrad at {N_WORKERS} workers, own draws: ", end="")
    assert _gate(ref["losses"], want, ranks[0]["losses"], got) == \
        (True, True)
