"""The SSM and hybrid family over the model axis (context parallelism)
on four gloo ranks (the harness of
``tests/test_torch_dist_hier_workers.py``), at smoke size: 32-token
sequences, 16 positions (two SSD chunks of 8) a shard. Tier 1.

  * ``dp_adam`` on ``(data=2, model=2)`` equals ``(data=4, model=1)``
    from the same ``model.init``, for mamba2-2.7b under both
    ``cp_exchange`` values (``"gather"``: every shard's (decay, state)
    summary all-gathered; ``"ladder"``: the log-step prefix over point
    to point shifts) and for hymba-1.5b (its meta prefix in front of
    the gathered K/V); and ``(4, 1)`` from the reference's initial
    state equals the reference's unsharded ``(4, 1)`` run. Three steps
    each. Tiers: the two port geometries within loss rel 2.3e-4 and
    parameters max abs 1e-6 of each other; against the reference,
    ``test_torch_dist._gate``'s tiers (losses rel 2.3e-4, masters rel
    L2 4e-6).
  * The loss and gradients of one batch, every leaf whole on every
    rank and the sequence split over each model pair (the summaries
    exchange, the conv halo and their backwards: a reduce-scatter, the
    reverse shifts), summed over the pair, against ``jax.grad`` of the
    reference's unsharded loss: rtol 2e-4 / atol 1e-5 (the family's
    gradient tier, ``tests/test_torch_ssm_family.py``).
  * ``Model.prefill`` over a model pair: the SSM state and conv tail
    gathered from the last shard equal the unsharded prefill's (rtol
    1e-5 / atol 1e-6).
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_dist_hier_workers as H

CP = dict(H.BASE, mode="dp_adam")
# (name, arch, cp_exchange): mamba2's unsharded reference run serves both
RUNS = (("mamba2_gather", "mamba2-2.7b", "gather"),
        ("mamba2_ladder", "mamba2-2.7b", "ladder"),
        ("hymba_gather", "hymba-1.5b", "gather"))
REF_ARCHS = ("mamba2-2.7b", "hymba-1.5b")
GEOS = ((0, 2, 2), (0, 4, 1))
MAX_ABS = 1e-6
GRAD_TOL = dict(rtol=2e-4, atol=1e-5)
MODULE = "test_torch_ssm_axis_workers"


def _cfg(get, arch, exchange="gather"):
    cfg = get(arch, smoke=True)
    return dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, cp_exchange=exchange))


def _grad_batch(cfg):
    rng = np.random.default_rng(17)
    toks = rng.integers(1, cfg.vocab_size, size=(2, H.SEQ + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def _reference_main(out_dir: str) -> None:
    """Subprocess body: per architecture, the model's initial tree with
    the loss and gradients of one batch, and the reference's unsharded
    (4, 1) dp_adam run from its initial state (saved first)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.data.pipeline import batch_for_model as jbatches
    from repro.dist.step import TrainConfig as JTC
    from repro.dist.step import make_train_step as j_make_train_step
    from repro.models.model import Model as JModel
    for arch in REF_ARCHS:
        cfg = _cfg(jget, arch)
        model = JModel(cfg)
        params = model.init(jax.random.PRNGKey(1))
        toks, tgts = _grad_batch(cfg)
        (s, _), g = jax.value_and_grad(model.loss, has_aux=True)(
            params, {"tokens": jnp.asarray(toks),
                     "targets": jnp.asarray(tgts)})
        H._save(os.path.join(out_dir, f"grads_{arch}.npz"),
                params=np.array(jax.tree.map(np.asarray, params),
                                dtype=object),
                grads=np.array(jax.tree.map(np.asarray, g), dtype=object),
                loss=np.asarray(s))
        mesh = jax.make_mesh((4, 1), ("data", "model"))
        art = j_make_train_step(model, mesh, JTC(**CP, worker_axes=("data",)))
        state = art.init_state(jax.random.PRNGKey(0))
        H._save(os.path.join(out_dir, f"init_{arch}.npz"), state=np.array(
            jax.tree.map(np.asarray, state), dtype=object))
        step = jax.jit(art.step_fn)
        batches = jbatches(cfg, H.SEQ, H.BATCH)
        losses = []
        for _ in range(H.STEPS):
            state, metrics = step(state, next(batches))
            losses.append(float(metrics["loss"]))
        H._save(os.path.join(out_dir, f"ref_{arch}.npz"),
                losses=np.asarray(losses),
                state=np.array(jax.tree.map(np.asarray, state),
                               dtype=object))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield "/".join(path), tree


def _grads_and_prefill(grid, cfg, ref_path):
    """This rank's part of the gradient and prefill checks, over its
    model pair: the pair's summed loss and gradients of every leaf, and
    whether the pair's prefill state and tail match the unsharded one."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.dist import collectives as C
    from repro_torch.models import layers as L
    from repro_torch.models.model import Model
    ref = np.load(ref_path, allow_pickle=True)
    model = Model(cfg)
    params = params_from_numpy(ref["params"].item(), "cpu")
    n, m = grid.n_shards, grid.model_index
    ctx = L.ShardCtx(cp_group=grid.model, cp_size=n, cp_rank=m)
    toks, tgts = _grad_batch(cfg)
    s = H.SEQ // n
    batch = {"tokens": torch.from_numpy(toks[:, m * s:(m + 1) * s]),
             "targets": torch.from_numpy(tgts[:, m * s:(m + 1) * s])}
    leaves = dict(_flat(params))
    for t in leaves.values():
        t.requires_grad_()
    with torch.enable_grad():
        loss, _ = model.loss(params, batch, ctx)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    out = {"loss": C.all_reduce(loss.detach().clone(), grid.model).numpy()}
    for name, g in zip(leaves, grads):
        g = torch.zeros_like(leaves[name]) if g is None else g
        out[f"grad:{name}"] = C.all_reduce(g.clone(), grid.model).numpy()
    with torch.no_grad():
        _, whole = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                                 H.SEQ)
        _, mine = model.prefill(params, batch, s, ctx=ctx)
    out["prefill_ok"] = np.asarray([
        np.allclose(mine[k].numpy(), whole[k].numpy(), rtol=1e-5, atol=1e-6)
        for k in ("ssm", "conv")])
    return out


def axis_body(rank, out_dir, ref_dir):
    """The runs of every entry of RUNS on this rank: (4, 1) from the
    reference's initial state, (2, 2) and (4, 1) from
    ``model.init(seed=0)``; and the gradient and prefill checks on
    (2, 2)."""
    from pathlib import Path

    from repro_torch.configs import get_config as tget
    from repro_torch.dist import topology as T
    from repro_torch.dist.step import TrainConfig
    from repro_torch.dist.step import make_train_step
    from repro_torch.launch import mesh as TM
    from repro_torch.models.model import Model
    ref_dir = Path(ref_dir)
    out = {}
    for name, arch, exchange in RUNS:
        cfg = _cfg(tget, arch, exchange)
        runs = tuple((g, False) for g in GEOS)
        if exchange == "gather":
            runs = ((GEOS[1], True),) + runs
        for geo, ref_init in runs:
            pod, data, model = geo
            grid = TM.make_grid(pod=pod, data=data, model=model,
                                device="cpu")
            art = make_train_step(Model(cfg), grid, TrainConfig(
                **CP, topology=T.FlatTopology()))
            start = (H.port_state(H.wait_for(ref_dir / f"init_{arch}.npz",
                                             _Alive()), grid)
                     if ref_init else art.init_state(0, "cpu"))
            state, losses = H.run_steps(
                art, start, H.Run(arch, geo, CP),
                batches=H.tbatches(cfg, H.SEQ, H.BATCH))
            tag = f"{name}@{data}x{model}" + ("ref" if ref_init else "")
            out[f"{tag}:losses"] = losses
            out.update(H.state_arrays(state, tag))
            if geo == GEOS[0]:
                res = _grads_and_prefill(
                    grid, cfg, H.wait_for(ref_dir / f"grads_{arch}.npz",
                                          _Alive()))
                out.update({f"{name}:{k}": v for k, v in res.items()})
    return out


class _Alive:
    """A stand-in process for ``H.wait_for`` in a rank: the test's
    fixture watches the reference subprocess itself."""

    @staticmethod
    def poll():
        return None


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
        H.wait_for(ref / f"init_{REF_ARCHS[0]}.npz", proc)
        ranks = H.spawn(MODULE, "axis_body", tmp_path_factory.mktemp("port"),
                        (str(ref),))
        for arch in REF_ARCHS:
            H.wait_for(ref / f"ref_{arch}.npz", proc)
        yield ranks, ref
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=30)
        proc.stdout.close()


def _whole(ranks, tag, geo, arch):
    """The (data, model) master chunks of ``tag`` -> whole parameters."""
    from repro_torch.configs import get_config as tget
    from repro_torch.dist import sharding as SH
    from repro_torch.models.model import Model
    _, data, model = geo
    shapes = Model(tget(arch, smoke=True)).init(device="meta")
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


@pytest.mark.parametrize("name,arch", [(n, a) for n, a, _ in RUNS])
def test_model_axis_equals_unsharded(axis, name, arch):
    """(2, 2) against (4, 1), both from the port's ``model.init``; and
    (4, 1) from the reference's initial state against the reference."""
    ranks, ref = axis
    base = name.replace("ladder", "gather")
    assert H.gate(ref / f"ref_{arch}.npz", ranks,
                  f"{base}@4x1ref") == (True, True)
    a, b = f"{name}@2x2", f"{name}@4x1"
    la, lb = ranks[0][f"{a}:losses"], ranks[0][f"{b}:losses"]
    rel = float(np.max(np.abs(la - lb) / np.abs(lb)))
    pa, pb = _whole(ranks, a, GEOS[0], arch), _whole(ranks, b, GEOS[1], arch)
    err = max(float(np.max(np.abs(pa[k] - pb[k]))) for k in pa)
    print(f"{name}: (2, 2) vs (4, 1) loss rel {rel:.2e}, parameters max "
          f"abs {err:.2e}")
    assert rel <= 2.3e-4 and err <= MAX_ABS
    assert any("ssm/in_proj" in k for k in pa)


@pytest.mark.parametrize("name,arch", [(n, a) for n, a, _ in RUNS])
def test_sharded_gradients_equal_the_reference(axis, name, arch):
    """Each model pair's summed loss and gradients against ``jax.grad``
    of the reference's unsharded loss; every rank agrees."""
    ranks, ref = axis
    want = np.load(ref / f"grads_{arch}.npz", allow_pickle=True)
    np.testing.assert_allclose(ranks[0][f"{name}:loss"], want["loss"],
                               rtol=1e-5)
    grads = dict(_flat(want["grads"].item()))
    for r in ranks:
        for path, g in grads.items():
            np.testing.assert_allclose(r[f"{name}:grad:{path}"], g,
                                       err_msg=path, **GRAD_TOL)


@pytest.mark.parametrize("name", [n for n, _, _ in RUNS])
def test_sharded_prefill_takes_the_last_shard_state(axis, name):
    ranks, _ = axis
    for r in ranks:
        np.testing.assert_array_equal(r[f"{name}:prefill_ok"], True)
