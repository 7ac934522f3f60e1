"""Expert parallelism over the model axis on four gloo ranks (the
harness of ``tests/test_torch_dist_hier_workers.py``), at
deepseek-moe-16b's smoke size with ``capacity_factor=16.0`` (no pair is
dropped, as the reference's ``tests/dist_scripts/cp_equiv.py`` makes
it: which pairs a shard drops depends on how the tokens are split).

  * ``dp_adam`` on ``(data=2, model=2)``, each rank holding 2 of the 4
    experts and exchanging tokens with ``collectives.expert_exchange``,
    equals ``(data=4, model=1)`` from the same ``model.init``, and that
    equals the reference's unsharded ``(4, 1)`` run from the
    reference's initial state; three steps each, under both dispatches.
    Tiers: the two port geometries within loss rel 2.3e-4 and max abs
    1e-6 of each other (the reference allows its own cp_equiv 1e-3 for
    MoE); against the reference, losses within rel 2.3e-4 and the
    masters within rel L2 4e-6 (``test_torch_dist._gate``'s tiers);
  * the exchange's backward against autograd through a gathered
    emulation: every rank's (E, C, d) slots gathered, the tiled
    all-to-all written as one reshape in one process, the sum of every
    rank's loss differentiated; each rank's gradient bitwise, both
    directions (the exchange moves elements, so no sum order enters).
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_dist_hier_workers as H

ARCH = "deepseek-moe-16b"
CP = dict(H.BASE, mode="dp_adam")
DISPATCHES = ("einsum", "sort")
GEOS = ((0, 2, 2), (0, 4, 1))
MAX_ABS = 1e-6
MODULE = "test_torch_moe_axis_workers"
E, C, D = 4, 3, 5        # the exchange test's slots


def _cfg(get, dispatch):
    cfg = get(ARCH, smoke=True)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=16.0, dispatch=dispatch))


def _reference_main(out_dir: str) -> None:
    """Subprocess body: the reference's unsharded (4, 1) dp_adam run of
    each dispatch on four simulated devices, its initial state saved
    first (the port's ranks start from it)."""
    import jax
    from repro.configs import get_config as jget
    from repro.data.pipeline import batch_for_model as jbatches
    from repro.dist.step import TrainConfig as JTC
    from repro.dist.step import make_train_step as j_make_train_step
    from repro.models.model import Model as JModel
    for dispatch in DISPATCHES:
        cfg = _cfg(jget, dispatch)
        mesh = jax.make_mesh((4, 1), ("data", "model"))
        art = j_make_train_step(JModel(cfg), mesh,
                                JTC(**CP, worker_axes=("data",)))
        state = art.init_state(jax.random.PRNGKey(0))
        if dispatch == DISPATCHES[0]:      # the same tree for both
            H._save(os.path.join(out_dir, "init.npz"), state=np.array(
                jax.tree.map(np.asarray, state), dtype=object))
        step = jax.jit(art.step_fn)
        batches = jbatches(cfg, H.SEQ, H.BATCH)
        losses = []
        for _ in range(H.STEPS):
            state, metrics = step(state, next(batches))
            losses.append(float(metrics["loss"]))
        H._save(os.path.join(out_dir, f"ref_{dispatch}.npz"),
                losses=np.asarray(losses),
                state=np.array(jax.tree.map(np.asarray, state),
                               dtype=object))


def _exchange_grads(rank, grid):
    """The expert exchange and its backward against the gathered
    emulation, on this rank's model group; returns the mismatches."""
    from repro_torch.dist import collectives as CL
    n, m = grid.n_shards, grid.model_index
    w = grid.worker_index

    def draw(seed, shape):
        g = torch.Generator().manual_seed(seed)
        return torch.randn(shape, generator=g)
    bad = []
    for to_experts in (True, False):
        shape = (E, C, D) if to_experts else (E // n, n * C, D)
        xs = [draw(100 * w + 10 * j + to_experts, shape) for j in range(n)]
        ws = [draw(1000 + 100 * w + 10 * j + to_experts,
                   _out_shape(shape, n, to_experts)) for j in range(n)]
        x = xs[m].clone().requires_grad_()
        y = CL.expert_exchange(x, grid.model, to_experts)
        (g,) = torch.autograd.grad(torch.sum(y * ws[m]), [x])
        # the emulation: every shard's x, the exchange as one permutation
        xa = [t.clone().requires_grad_() for t in xs]
        ya = _emulate(xa, to_experts)
        (ga,) = torch.autograd.grad(
            sum(torch.sum(yj * wj) for yj, wj in zip(ya, ws)), [xa[m]])
        bad += [int(not torch.equal(y.detach(), ya[m].detach())),
                int(not torch.equal(g, ga))]
    return np.asarray(bad)


def _out_shape(shape, n, to_experts):
    if to_experts:
        e, c, d = shape
        return (e // n, n * c, d)
    el, nc, d = shape
    return (n * el, nc // n, d)


def _emulate(xs, to_experts):
    """The tiled all-to-all of every shard's tensor, in one process."""
    n = len(xs)
    if to_experts:       # shard i gets block i of every shard's experts
        e = xs[0].shape[0] // n
        return [torch.cat([x[i * e:(i + 1) * e] for x in xs], dim=1)
                for i in range(n)]
    c = xs[0].shape[1] // n     # shard i gets columns block i of every shard
    return [torch.cat([x[:, i * c:(i + 1) * c] for x in xs], dim=0)
            for i in range(n)]


def axis_body(rank, out_dir, init_path):
    """The dp_adam runs on this rank: (4, 1) from the reference's
    initial state, (2, 2) and (4, 1) from ``model.init(seed=0)``; and
    the exchange's check."""
    from repro_torch.configs import get_config as tget
    from repro_torch.dist import topology as T
    from repro_torch.dist.step import TrainConfig
    from repro_torch.dist.step import make_train_step
    from repro_torch.launch import mesh as TM
    from repro_torch.models.model import Model
    out = {}
    for dispatch in DISPATCHES:
        cfg = _cfg(tget, dispatch)
        for geo, ref_init in ((GEOS[1], True),) + tuple(
                (g, False) for g in GEOS):
            pod, data, model = geo
            grid = TM.make_grid(pod=pod, data=data, model=model,
                                device="cpu")
            art = make_train_step(Model(cfg), grid, TrainConfig(
                **CP, topology=T.FlatTopology()))
            batches = H.tbatches(cfg, H.SEQ, H.BATCH)
            start = (H.port_state(init_path, grid) if ref_init
                     else art.init_state(0, "cpu"))
            state, losses = H.run_steps(art, start, H.Run(ARCH, geo, CP),
                                        batches=batches)
            tag = f"{dispatch}@{data}x{model}" + ("ref" if ref_init else "")
            out[f"{tag}:losses"] = losses
            out.update(H.state_arrays(state, tag))
            if geo == (0, 2, 2) and dispatch == "einsum":
                out["exchange_bad"] = _exchange_grads(rank, grid)
    return out


@pytest.fixture(scope="module")
def axis(tmp_path_factory):
    ref = tmp_path_factory.mktemp("ref")
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    code = (f"import sys; sys.path.insert(0, {str(H.HERE)!r}); "
            f"import {MODULE} as t; t._reference_main({str(ref)!r})")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        init = H.wait_for(ref / "init.npz", proc)
        ranks = H.spawn(MODULE, "axis_body", tmp_path_factory.mktemp("port"),
                        (str(init),))
        for dispatch in DISPATCHES:
            H.wait_for(ref / f"ref_{dispatch}.npz", proc)
        yield ranks, ref
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=30)
        proc.stdout.close()


def _whole(ranks, tag, geo):
    """The (data, model) master chunks of ``tag`` -> whole parameters."""
    from repro_torch.configs import get_config as tget
    from repro_torch.dist import sharding as SH
    from repro_torch.models.model import Model
    _, data, model = geo
    shapes = Model(tget(ARCH, smoke=True)).init(device="meta")
    layout = SH.build_layout(shapes, model)
    dims = SH.dims_by_path(layout)
    out = {}
    for path, shape in H._paths(layout.shapes):
        dim, stacked = dims[tuple(path.strip("/").split("/"))]
        local = SH.local_shard_shape(shape, dim, stacked, model)
        shards = []
        for m in range(model):
            rows = np.concatenate([ranks[w * model + m][f"{tag}:master:{path}"]
                                   for w in range(data)])
            shards.append(rows[:int(np.prod(local))].reshape(local))
        ax = SH.axis_of(dim, stacked)
        out[path] = shards[0] if ax is None else np.concatenate(shards, ax)
    return out


@pytest.mark.parametrize("dispatch", DISPATCHES)
def test_expert_parallel_equals_unsharded(axis, dispatch):
    ranks, ref = axis
    assert H.gate(ref / f"ref_{dispatch}.npz", ranks,
                  f"{dispatch}@4x1ref") == (True, True)
    a, b = f"{dispatch}@2x2", f"{dispatch}@4x1"
    la, lb = ranks[0][f"{a}:losses"], ranks[0][f"{b}:losses"]
    rel = float(np.max(np.abs(la - lb) / np.abs(lb)))
    pa, pb = _whole(ranks, a, (0, 2, 2)), _whole(ranks, b, (0, 4, 1))
    err = max(float(np.max(np.abs(pa[k] - pb[k]))) for k in pa)
    print(f"{dispatch}: (2, 2) vs (4, 1) loss rel {rel:.2e}, parameters "
          f"max abs {err:.2e}")
    assert rel <= 2.3e-4 and err <= MAX_ABS
    assert any("moe/w_gate" in k for k in pa)


def test_exchange_backward_against_gathered_autograd(axis):
    ranks, _ = axis
    for r in ranks:
        np.testing.assert_array_equal(r["exchange_bad"], 0)
