"""The port's model axis against itself, and the checkpoints of a
model-sharded run against the JAX package's store, on four gloo ranks
(the harness of ``tests/test_torch_dist_hier_workers.py``).

  * the reference's ``cp_equiv`` claim (``tests/dist_scripts/
    cp_equiv.py``) in the port: ``dp_adam`` on ``(data=2, model=2)``
    equals ``(data=4, model=1)`` from the same ``model.init`` for
    yi-6b, gemma2-2b, gemma3-4b and qwen2.5-14b (QKV bias), three
    steps: losses within rel 2.3e-4 and every parameter within max abs
    1e-6 (``cp_equiv.py`` allows the reference rel 2e-3 and 2e-4; the
    port reorders only the sums over shards and rows, 3.7e-9 measured);
  * a checkpoint the reference's store writes for the (data=2, model=2)
    state (its ``worker_sizes + (n_shards, X)`` arrays, from the
    reference's initial state made in a subprocess) restores in the
    port bitwise, one the port writes restores in the reference's store
    bitwise, and a resume at W x Nm = 4 is bitwise an unbroken run.
"""
import numpy as np
import pytest
import torch

import test_torch_dist_hier_workers as H
from test_torch_dist_hier_workers import BASE, Run

CP = dict(BASE, mode="dp_adam")
# the reference's initial state of the checkpointed run (no steps)
RUNS = {"cp_yi": Run("yi-6b", (0, 2, 2), CP, steps=0)}
EQUIV_ARCHS = ("yi-6b", "gemma2-2b", "gemma3-4b", "qwen2.5-14b")
EQUIV_MAX_ABS = 1e-6
CKPT_STEP = 6
MODULE = "test_torch_model_axis_equiv_workers"


def equiv_body(rank, out_dir, init_dir, ckpt_in, ckpt_out, ckpt_resume):
    """The port against itself at (data=4, model=1) and (data=2,
    model=2); the checkpoints."""
    from pathlib import Path

    from repro_torch.train.session import SessionConfig, TrainSession
    out = {}
    for arch in EQUIV_ARCHS:
        for geo in ((0, 2, 2), (0, 4, 1)):
            run = Run(arch, geo, CP)
            grid, art = H.make_step(run)
            state, losses = H.run_steps(art, art.init_state(0, "cpu"), run)
            tag = f"{arch}@{geo[1]}x{geo[2]}"
            out[f"{tag}:losses"] = losses
            out.update(H.state_arrays(state, tag))
    # checkpoints of the (data=2, model=2) dp_adam state
    run = Run("yi-6b", (0, 2, 2), CP)
    grid, art = H.make_step(run)

    def session(d, state=None, **kw):
        return TrainSession.from_artifacts(
            art, H.tbatches(H.tget(run.arch, smoke=True), H.SEQ, H.BATCH),
            SessionConfig(log_every=1, ckpt_dir=d, **kw), state=state,
            device="cpu", log=lambda *_: None)
    def start():
        return H.port_state(Path(init_dir) / "init_cp_yi.npz", grid)
    keys = ("master", "m", "v", "e")
    with session(ckpt_in) as sess:               # the reference's writes
        assert sess.resume() == CKPT_STEP
        out.update(H.state_arrays(sess.state, "restored", keys))
    with session(ckpt_out, state=start(), ckpt_every=2) as sess:
        sess.run(2)                              # the port's writes
        sess.wait_for_checkpoints()
        out.update(H.state_arrays(sess.state, "written", keys))
    with session(None, state=start()) as sess:
        sess.run(4)                              # unbroken
        out["unbroken:losses"] = np.asarray([h["loss"]
                                             for h in sess.history])
        out.update(H.state_arrays(sess.state, "unbroken", keys))
    with session(ckpt_resume, state=start(), ckpt_every=2) as sess:
        sess.run(2)
        sess.wait_for_checkpoints()
        first = [h["loss"] for h in sess.history]
    with session(ckpt_resume) as sess:
        assert sess.resume() == 2
        sess.run(2)
        out["resumed:losses"] = np.asarray(
            first + [h["loss"] for h in sess.history])
        out.update(H.state_arrays(sess.state, "resumed", keys))
    return out


@pytest.fixture(scope="module")
def cp(tmp_path_factory):
    import jax
    from repro.checkpoint import store as jstore
    gen = H.start_reference(tmp_path_factory, MODULE, tuple(RUNS))
    out, proc = next(gen)
    H.wait_for(out / "init_cp_yi.npz", proc)
    # a checkpoint of the (data=2, model=2) state in the reference's
    # store: its initial state, every array replaced by draws
    rng = np.random.default_rng(1)
    ref = np.load(out / "init_cp_yi.npz", allow_pickle=True)["state"].item()
    saved = {k: (jax.tree.map(lambda a: rng.standard_normal(a.shape)
                              .astype(np.float32), v) if k != "count"
                 else np.int32(CKPT_STEP)) for k, v in ref.items()}
    ckpt_in = tmp_path_factory.mktemp("ckpt_in")
    jstore.save(str(ckpt_in), saved, step=CKPT_STEP,
                extra={"batches_consumed": CKPT_STEP})
    ckpt_out = tmp_path_factory.mktemp("ckpt_out")
    ckpt_resume = tmp_path_factory.mktemp("ckpt_resume")
    work = tmp_path_factory.mktemp("port")
    ranks = H.spawn(MODULE, "equiv_body", work,
                    (str(out), str(ckpt_in), str(ckpt_out),
                     str(ckpt_resume)))
    yield dict(ranks=ranks, saved=saved, like=ref, ckpt_out=ckpt_out)
    for _ in gen:
        pass


def _whole(ranks, tag, geo, arch):
    """Rank r's master chunks of ``tag`` -> the whole parameters: the
    (data, model) chunks reassembled through the layout."""
    from repro_torch.dist import sharding as SH
    from repro_torch.models.model import Model as TModel
    _, data, model = geo
    shapes = TModel(H.tget(arch, smoke=True)).init(device="meta")
    layout = SH.build_layout(shapes, model)
    dims = SH.dims_by_path(layout)
    out = {}
    for path, shape in H._paths(layout.shapes):
        keys = tuple(path.strip("/").split("/"))
        dim, stacked = dims[keys]
        shards = []
        for m in range(model):
            rows = np.concatenate([ranks[w * model + m][f"{tag}:master:{path}"]
                                   for w in range(data)])
            local = SH.local_shard_shape(shape, dim, stacked, model)
            shards.append(rows[:int(np.prod(local))].reshape(local))
        ax = SH.axis_of(dim, stacked)
        out[path] = shards[0] if ax is None else np.concatenate(shards, ax)
    return out


@pytest.mark.parametrize("arch", EQUIV_ARCHS)
def test_model_axis_equals_more_workers(cp, arch):
    """The reference's cp_equiv claim in the port: dp_adam on (data=2,
    model=2) and on (data=4, model=1) from the same ``model.init``."""
    ranks = cp["ranks"]
    a, b = f"{arch}@2x2", f"{arch}@4x1"
    la, lb = ranks[0][f"{a}:losses"], ranks[0][f"{b}:losses"]
    rel = float(np.max(np.abs(la - lb) / np.abs(lb)))
    pa = _whole(ranks, a, (0, 2, 2), arch)
    pb = _whole(ranks, b, (0, 4, 1), arch)
    err = max(float(np.max(np.abs(pa[k] - pb[k]))) for k in pa)
    print(f"{arch}: loss rel {rel:.2e}, parameters max abs {err:.2e}")
    assert rel <= 2.3e-4 and err <= EQUIV_MAX_ABS


def test_checkpoints_cross_both_ways(cp):
    """The reference's store writes the (data=2, model=2) state; every
    rank restores its (worker, shard) row bitwise. The port writes after
    two steps; the reference's store reads every rank's row bitwise."""
    from repro.checkpoint import store as jstore
    ranks = cp["ranks"]
    for kind in ("master", "m", "v", "e"):
        for p, a in H._paths(cp["saved"][kind]):
            rows = np.asarray(a).reshape(4, -1)
            for r, rk in enumerate(ranks):
                np.testing.assert_array_equal(rk[f"restored:{kind}:{p}"],
                                              rows[r], err_msg=(kind, p))
    back = jstore.restore(str(cp["ckpt_out"]), cp["like"])
    assert int(back["count"]) == 2
    for kind in ("master", "m", "v", "e"):
        for p, a in H._paths(back[kind]):
            assert a.shape == np.asarray(
                dict(H._paths(cp["like"][kind]))[p]).shape
            rows = np.asarray(a).reshape(4, -1)
            for r, rk in enumerate(ranks):
                np.testing.assert_array_equal(rows[r],
                                              rk[f"written:{kind}:{p}"],
                                              err_msg=(kind, p))


def test_resume_is_an_unbroken_run(cp):
    for rk in cp["ranks"]:
        np.testing.assert_array_equal(rk["resumed:losses"],
                                      rk["unbroken:losses"])
        for k in rk:
            if k.startswith("unbroken:") and k != "unbroken:losses":
                np.testing.assert_array_equal(
                    rk["resumed:" + k[len("unbroken:"):]], rk[k], err_msg=k)
