"""The encoder-decoder family (whisper-small) over the model axis on four
gloo ranks (the harness of ``tests/test_torch_dist_hier_workers.py``),
at smoke size: 32-token sequences beside 16 audio frames. Tier 1.

  * ``dp_adam`` on ``(data=2, model=2)`` and on ``(data=1, model=4)``
    equals ``(data=4, model=1)`` from the same ``model.init``; and
    ``(4, 1)`` from the reference's initial state equals the
    reference's unsharded ``(4, 1)`` run. Three steps each. Tiers: the
    port's geometries within loss rel 2.3e-4 and parameters max abs
    1e-6 of each other; against the reference, ``test_torch_dist._gate``'s
    tiers (losses rel 2.3e-4, masters rel L2 4e-6).
  * The loss and gradients of one batch, every leaf whole on every rank,
    the tokens and the audio frames split over each model group of
    ``(2, 2)`` and ``(1, 4)`` (the encoder's self-attention and the
    cross-attention gather K/V along the frames; the backward
    reduce-scatters them), summed over the group, against ``jax.grad``
    of the reference's unsharded loss: rtol 2e-4 / atol 1e-5 (the
    family's gradient tier, ``tests/test_torch_encdec_family.py``).
  * The audio split rule: with 18 frames, which 4 shards do not divide,
    ``(1, 4)`` keeps the sequence whole on every shard (tokens and
    frames: the reference's ``_batch_geometry``) and equals ``(4, 1)``.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_dist_hier_workers as H

ARCH = "whisper-small"
CP = dict(H.BASE, mode="dp_adam")
GEOS = ((0, 2, 2), (0, 1, 4), (0, 4, 1))
ODD_FRAMES = 18            # not a multiple of 4 shards
MAX_ABS = 1e-6
GRAD_TOL = dict(rtol=2e-4, atol=1e-5)
MODULE = "test_torch_encdec_axis_workers"


def _cfg(get, frames=None):
    cfg = get(ARCH, smoke=True)
    return cfg if frames is None else dataclasses.replace(
        cfg, encoder_seq=frames)


def _grad_batch(cfg):
    rng = np.random.default_rng(17)
    toks = rng.integers(1, cfg.vocab_size, size=(2, H.SEQ + 1))
    audio = rng.normal(size=(2, cfg.encoder_seq, cfg.d_model), scale=0.7)
    return (toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32),
            audio.astype(np.float32))


def _reference_main(out_dir: str) -> None:
    """Subprocess body: the model's initial tree with the loss and
    gradients of one batch, and the reference's unsharded (4, 1)
    dp_adam run from its initial state (saved first)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.data.pipeline import batch_for_model as jbatches
    from repro.dist.step import TrainConfig as JTC
    from repro.dist.step import make_train_step as j_make_train_step
    from repro.models.model import Model as JModel
    cfg = _cfg(jget)
    model = JModel(cfg)
    mesh = jax.make_mesh((4, 1), ("data", "model"))
    art = j_make_train_step(model, mesh, JTC(**CP, worker_axes=("data",)))
    state = art.init_state(jax.random.PRNGKey(0))
    H._save(os.path.join(out_dir, "init.npz"), state=np.array(
        jax.tree.map(np.asarray, state), dtype=object))
    params = model.init(jax.random.PRNGKey(1))
    toks, tgts, audio = _grad_batch(cfg)
    (s, _), g = jax.value_and_grad(model.loss, has_aux=True)(
        params, {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts),
                 "audio": jnp.asarray(audio)})
    H._save(os.path.join(out_dir, "grads.npz"),
            params=np.array(jax.tree.map(np.asarray, params), dtype=object),
            grads=np.array(jax.tree.map(np.asarray, g), dtype=object),
            loss=np.asarray(s))
    step = jax.jit(art.step_fn)
    batches = jbatches(cfg, H.SEQ, H.BATCH)
    losses = []
    for _ in range(H.STEPS):
        state, metrics = step(state, next(batches))
        losses.append(float(metrics["loss"]))
    H._save(os.path.join(out_dir, "ref.npz"), losses=np.asarray(losses),
            state=np.array(jax.tree.map(np.asarray, state), dtype=object))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield "/".join(path), tree


def _grads(grid, cfg, ref_path):
    """This rank's part of the gradient check, over its model group: the
    group's summed loss and gradients of every leaf, the batch's tokens
    and frames split along the group."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.dist import collectives as C
    from repro_torch.dist.step import shard_batch
    from repro_torch.models import layers as L
    from repro_torch.models.model import Model
    ref = np.load(ref_path, allow_pickle=True)
    params = params_from_numpy(ref["params"].item(), "cpu")
    n, m = grid.n_shards, grid.model_index
    ctx = L.ShardCtx(cp_group=grid.model, cp_size=n, cp_rank=m)
    toks, tgts, audio = _grad_batch(cfg)
    batch = shard_batch({"tokens": torch.from_numpy(toks),
                         "targets": torch.from_numpy(tgts),
                         "audio": torch.from_numpy(audio)}, 0, 1, m, n)
    assert batch["audio"].shape[1] == cfg.encoder_seq // n
    leaves = dict(_flat(params))
    for t in leaves.values():
        t.requires_grad_()
    with torch.enable_grad():
        loss, _ = Model(cfg).loss(params, batch, ctx)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    out = {"loss": C.all_reduce(loss.detach().clone(), grid.model).numpy()}
    for name, g in zip(leaves, grads):
        out[f"grad:{name}"] = C.all_reduce(g.clone(), grid.model).numpy()
    return out


def axis_body(rank, out_dir, ref_dir):
    """On this rank: (4, 1) from the reference's initial state; (2, 2),
    (1, 4) and (4, 1) from ``model.init(seed=0)``, the gradient check on
    (2, 2) and (1, 4); then (1, 4) and (4, 1) at ODD_FRAMES frames."""
    from pathlib import Path

    from repro_torch.configs import get_config as tget
    from repro_torch.dist import topology as T
    from repro_torch.dist.step import TrainConfig
    from repro_torch.dist.step import make_train_step
    from repro_torch.launch import mesh as TM
    from repro_torch.models.model import Model
    ref_dir = Path(ref_dir)
    out = {}
    runs = [("whisper", None, GEOS[2], True)]
    runs += [("whisper", None, g, False) for g in GEOS]
    runs += [("odd", ODD_FRAMES, g, False) for g in GEOS[1:]]
    for name, frames, geo, ref_init in runs:
        cfg = _cfg(tget, frames)
        pod, data, model = geo
        grid = TM.make_grid(pod=pod, data=data, model=model, device="cpu")
        art = make_train_step(Model(cfg), grid, TrainConfig(
            **CP, topology=T.FlatTopology()))
        start = (H.port_state(H.wait_for(ref_dir / "init.npz", _Alive()),
                              grid)
                 if ref_init else art.init_state(0, "cpu"))
        state, losses = H.run_steps(
            art, start, H.Run(ARCH, geo, CP),
            batches=H.tbatches(cfg, H.SEQ, H.BATCH))
        tag = f"{name}@{data}x{model}" + ("ref" if ref_init else "")
        out[f"{tag}:losses"] = losses
        out.update(H.state_arrays(state, tag))
        if name == "whisper" and not ref_init and model > 1:
            res = _grads(grid, cfg, H.wait_for(ref_dir / "grads.npz",
                                               _Alive()))
            out.update({f"{tag}:{k}": v for k, v in res.items()})
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
        H.wait_for(ref / "init.npz", proc)
        ranks = H.spawn(MODULE, "axis_body", tmp_path_factory.mktemp("port"),
                        (str(ref),))
        H.wait_for(ref / "ref.npz", proc)
        yield ranks, ref
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=30)
        proc.stdout.close()


def _whole(ranks, tag, geo, frames=None):
    """The (data, model) master chunks of ``tag`` -> whole parameters."""
    from repro_torch.configs import get_config as tget
    from repro_torch.dist import sharding as SH
    from repro_torch.models.model import Model
    _, data, model = geo
    shapes = Model(_cfg(tget, frames)).init(device="meta")
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


def _same_run(ranks, name, geo, frames=None):
    """(loss rel, parameters max abs) of ``geo`` against (4, 1)."""
    a, b = f"{name}@{geo[1]}x{geo[2]}", f"{name}@4x1"
    la, lb = ranks[0][f"{a}:losses"], ranks[0][f"{b}:losses"]
    rel = float(np.max(np.abs(la - lb) / np.abs(lb)))
    pa = _whole(ranks, a, geo, frames)
    pb = _whole(ranks, b, GEOS[2], frames)
    err = max(float(np.max(np.abs(pa[k] - pb[k]))) for k in pa)
    print(f"{a} vs (4, 1): loss rel {rel:.2e}, parameters max abs {err:.2e}")
    assert any("enc_blocks/attn/q" in k for k in pa)
    return rel, err


def test_reference_initial_state_matches_the_reference(axis):
    """(4, 1) from the reference's initial state against the reference's
    own unsharded run."""
    ranks, ref = axis
    assert H.gate(ref / "ref.npz", ranks, "whisper@4x1ref") == (True, True)


@pytest.mark.parametrize("geo", GEOS[:2], ids=["2x2", "1x4"])
def test_model_axis_equals_unsharded(axis, geo):
    """(2, 2) and (1, 4), the frames split over the model axis, against
    (4, 1), all from the port's ``model.init``."""
    ranks, _ = axis
    rel, err = _same_run(ranks, "whisper", geo)
    assert rel <= 2.3e-4 and err <= MAX_ABS


@pytest.mark.parametrize("geo", GEOS[:2], ids=["2x2", "1x4"])
def test_sharded_gradients_equal_the_reference(axis, geo):
    """Each model group's summed loss and gradients against ``jax.grad``
    of the reference's unsharded loss; every rank agrees."""
    ranks, ref = axis
    tag = f"whisper@{geo[1]}x{geo[2]}"
    want = np.load(ref / "grads.npz", allow_pickle=True)
    np.testing.assert_allclose(ranks[0][f"{tag}:loss"], want["loss"],
                               rtol=1e-5)
    grads = dict(_flat(want["grads"].item()))
    for r in ranks:
        for path, g in grads.items():
            np.testing.assert_allclose(r[f"{tag}:grad:{path}"], g,
                                       err_msg=path, **GRAD_TOL)


def test_audio_split_rule(axis):
    """With ODD_FRAMES frames over 4 shards the sequence stays whole:
    the port's ``_batch_geometry`` decides as the reference's does (also
    at 16 frames, which split), ``shard_batch`` hands every shard the
    whole tokens and frames, and (1, 4) equals (4, 1)."""
    from repro.dist.step import _batch_geometry as j_geometry
    from repro_torch.dist.step import _batch_geometry, shard_batch
    ranks, _ = axis
    for frames in (ODD_FRAMES, 16):
        for n in (1, 2, 4):
            batch = {"tokens": np.zeros((2, H.SEQ), np.int32),
                     "audio": np.zeros((2, frames, 8), np.float32)}
            _, want = j_geometry(batch, n, ("data",), 1, True)
            tb = {k: torch.from_numpy(v) for k, v in batch.items()}
            assert _batch_geometry(tb, n) == want, (frames, n)
            mine = shard_batch(tb, 0, 1, n - 1, n)
            split = n if want else 1
            assert mine["audio"].shape[1] == frames // split
            assert mine["tokens"].shape[1] == H.SEQ // split
    rel, err = _same_run(ranks, "odd", GEOS[1], ODD_FRAMES)
    assert rel <= 2.3e-4 and err <= MAX_ABS
