"""The port's resumable training session (``repro_torch.train.session``):
checkpoints, resume, evals, scan chunks, the ``train()`` shim and the
launcher's flags, on the yi-6b smoke config on the CPU (the kernels'
plain versions; graphs are the card tests').

Tiers, all bitwise: a run resumed from a checkpoint equals the unbroken
run (losses, parameters or masters, m, v, e and the count) for Algorithm
1's ``qadam`` and for the distributed ``qadam`` and ``dp_adam`` at one
worker and at two gloo ranks; ``scan_chunk`` 2 and 3 equal the
step-by-step run, with tail chunks and repeated ``run()``s. The
cadences follow the reference's session (``repro/train/session.py``): a
tail-misaligned checkpoint labels the true post-dispatch step, and evals
get entries of their own.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import store
from repro_torch.configs import get_config as tget
from repro_torch.core.qadam import QAdamConfig, ef_sgdm, qadam, terngrad_sgd
from repro_torch.data.pipeline import batch_for_model as tbatches
from repro_torch.dist.step import TrainConfig as TTC
from repro_torch.dist.step import make_train_step as t_make_train_step
from repro_torch.launch import mesh as TM
from repro_torch.models.model import Model as TModel
from repro_torch.train.loop import LoopConfig, train
from repro_torch.train.session import (SessionConfig, TrainSession,
                                       _replaced, _tensor_leaves)
from repro_torch.tree import tree_flatten_with_path

HERE = Path(__file__).resolve().parent
SEQ, BATCH = 32, 4
OPT = dict(alpha=1e-3, grad_q="log:6", weight_q="uniform_amax:7",
           weight_q_min_numel=2 ** 14)
DIST = dict(alpha=1e-3, beta=0.99, theta=0.999, grad_k=6, weight_k=7,
            weight_absolute=True)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    return TModel(tget("yi-6b", smoke=True))


@pytest.fixture(scope="module")
def group():
    g = TM.make_process_group("cpu", store=torch.distributed.HashStore())
    yield g
    TM.close_process_group()


def _loss_fn(model):
    def loss_fn(p, b):
        s, n = model.loss(p, b)
        return s / n
    return loss_fn


def _alg1(model, **kw):
    kw.setdefault("log_every", 1)
    return TrainSession.from_optimizer(
        qadam(QAdamConfig(**OPT)), _loss_fn(model),
        model.init(seed=0, device="cpu"), tbatches(model.cfg, SEQ, BATCH),
        SessionConfig(**kw), log=lambda *_: None)


def _dist(model, group, mode="qadam", **kw):
    kw.setdefault("log_every", 1)
    art = t_make_train_step(model, group, TTC(**DIST, mode=mode))
    return TrainSession.from_artifacts(
        art, tbatches(model.cfg, SEQ, BATCH), SessionConfig(**kw),
        device="cpu", log=lambda *_: None)


def _flat_state(state):
    """A session's state as {key: tensor} plus its count."""
    if "params" in state:
        o = state["opt"]
        tree = {"params": state["params"], "m": o.m, "v": o.v, "e": o.e}
        count = o.count
    else:
        tree = {k: v for k, v in state.items() if k != "count"}
        count = state["count"]
    return dict(tree_flatten_with_path(tree)), count


def _assert_same_state(a, b):
    fa, ca = _flat_state(a)
    fb, cb = _flat_state(b)
    assert ca == cb and fa.keys() == fb.keys()
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k


def _losses(sess):
    return {h["step"]: h["loss"] for h in sess.history if "loss" in h}


def _every_loss(sess, *runs):
    """Every step's loss over ``sess.run(n) for n in runs``, from the
    session's own harvests."""
    got = {}
    harvest = sess.harvest_losses

    def keep():
        out = harvest()
        got.update(out)
        return out
    sess.harvest_losses = keep
    for n in runs:
        sess.run(n)
    got.update(harvest())
    return got


# ---------------------------------------------------------------------------
# resume is bitwise an unbroken run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("program", ["qadam", "dist-qadam", "dist-dp_adam"])
def test_resume_is_bitwise_an_unbroken_run(tmp_path, model, group, program):
    def make(**kw):
        if program == "qadam":
            return _alg1(model, **kw)
        return _dist(model, group, program.split("-")[1], **kw)
    with make() as a:
        a.run(6)
    d = str(tmp_path)
    with make(ckpt_dir=d, ckpt_every=2) as b:
        b.run(3)                          # checkpoints at 2
    assert store.latest_step(d) == 2
    assert store.read_extra(d) == {"batches_consumed": 2}
    c = make(ckpt_dir=d)
    assert c.resume() == 2 and c.step == 2
    with c:
        c.run(4)
    assert c.step == 6
    _assert_same_state(a.state, c.state)
    la, lc = _losses(a), _losses(c)
    assert sorted(lc) == [3, 4, 5, 6]
    assert all(lc[s] == la[s] for s in lc)


@pytest.mark.parametrize("program", ["qadam", "dist-qadam"])
def test_resume_writes_into_the_state_tensors(tmp_path, model, group,
                                              program):
    """resume() copies the stored leaves into the state's own tensors:
    their addresses stay (no second state; a captured graph stays
    valid), their values are the checkpoint's."""
    def make(**kw):
        if program == "qadam":
            return _alg1(model, **kw)
        return _dist(model, group, **kw)
    d = str(tmp_path)
    with make(ckpt_dir=d) as a:
        a.run(2)
        a.checkpoint()
    b = make(ckpt_dir=d)
    before = _tensor_leaves(b.state)
    assert b.resume() == 2
    assert _replaced(before, b.state) == []
    _assert_same_state(a.state, b.state)
    b.close()


def test_resume_without_a_checkpoint_is_a_no_op(tmp_path, model):
    sess = _alg1(model, ckpt_dir=str(tmp_path / "empty"))
    assert sess.resume() == 0 and sess.step == 0
    with sess:
        sess.run(2)
    with _alg1(model) as ref:
        ref.run(2)
    _assert_same_state(sess.state, ref.state)
    with pytest.raises(RuntimeError, match="precede"):
        sess.resume()
    with pytest.raises(ValueError, match="directory"):
        _alg1(model).resume()


def test_tail_misaligned_checkpoint_labels_the_true_step(tmp_path, model):
    """scan_chunk=2, ckpt_every=2: ``run(3)`` twice is dispatches of 2,
    1, 2, 1 steps; the boundary at step 4 falls inside the third
    dispatch, whose state is step 5's, so its checkpoint is labelled 5
    (the reference's rule), and resuming it is bitwise the unbroken run."""
    d = str(tmp_path)
    with _alg1(model, log_every=2, scan_chunk=2, ckpt_dir=d,
               ckpt_every=2) as sess:
        sess.run(3)
        sess.run(3)
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(d))
    assert steps == [2, 5, 6]
    assert store.read_extra(d, step=5) == {"batches_consumed": 5}
    with _alg1(model) as ref:
        ref.run(7)
    c = _alg1(model, ckpt_dir=d)
    assert c.resume(step=5) == 5
    with c:
        c.run(2)
    _assert_same_state(ref.state, c.state)


def test_async_writer_flushes_on_close(tmp_path, model):
    d = str(tmp_path)
    sess = _alg1(model, ckpt_dir=d, ckpt_async=True, ckpt_keep=2)
    sess.run(1)
    sess.checkpoint()
    sess.run(1)
    sess.checkpoint()
    sess.checkpoint(step=9)
    sess.close()                # joins the writer: every write on disk
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000009"]
    man = json.load(open(os.path.join(d, "step_00000009", "manifest.json")))
    assert man["step"] == 9 and man["extra"] == {"batches_consumed": 2}
    assert sess.stats["ckpts"] == 3
    with pytest.raises(ValueError, match="ckpt_dir"):
        _alg1(model).checkpoint()


def test_codec_checkpoint_restores_the_round_trip(tmp_path, model, group):
    """``ckpt_codec``: the moments restore as the codec's plain round
    trip, the masters and the count exact."""
    from repro_torch.comm.codec import get_codec
    d = str(tmp_path)
    with _dist(model, group, ckpt_dir=d, ckpt_codec="uniform_amax:7") as a:
        a.run(2)
        a.checkpoint()
    b = _dist(model, group, ckpt_dir=d)
    assert b.resume() == 2
    got, cb = _flat_state(b.state)
    want, ca = _flat_state(a.state)
    assert ca == cb == 2
    cd = get_codec("uniform_amax:7")
    for k, x in want.items():
        if k.split("/")[0] in ("m", "v", "e"):
            x = cd.encode(x, backend="torch").decode(backend="torch")
        assert torch.equal(got[k], x), k
    b.close()


# ---------------------------------------------------------------------------
# scan chunks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk,runs", [(2, (5, 4)), (3, (7, 1, 3))])
def test_scan_chunk_is_bitwise_step_by_step(model, chunk, runs):
    with _alg1(model) as ref:
        ref_losses = _every_loss(ref, sum(runs))
    sess = _alg1(model, scan_chunk=chunk, log_every=chunk)
    with sess:
        losses = _every_loss(sess, *runs)
    assert losses == ref_losses
    _assert_same_state(ref.state, sess.state)
    plan = sum(-(-n // chunk) for n in runs)
    assert sess.stats["dispatches"] == plan
    assert sess.stats["steps"] == sum(runs)
    assert sess.stats["graph_captures"] == sess.stats["graph_replays"] == 0


def test_scan_chunk_distributed_is_bitwise_step_by_step(model, group):
    with _dist(model, group) as ref:
        ref_losses = _every_loss(ref, 5)
    with _dist(model, group, scan_chunk=2, log_every=2) as sess:
        losses = _every_loss(sess, 5)
    assert losses == ref_losses
    _assert_same_state(ref.state, sess.state)


_GRAPHABLE = {
    "qadam": lambda: qadam(QAdamConfig(**OPT)),
    "qadam-blockwise": lambda: qadam(QAdamConfig(
        **dict(OPT, grad_q="blockwise:256"))),
    "qadam-no-ef": lambda: qadam(QAdamConfig(
        **dict(OPT, error_feedback=False))),
    "ef_sgdm": lambda: ef_sgdm(alpha=1e-3),
    "terngrad_sgd": lambda: terngrad_sgd(alpha=1e-3),
}
_DIST_MODES = {
    "qadam": DIST,
    "dp_adam": dict(alpha=1e-3, grad_k=None, weight_k=None),
    "efadam": dict(alpha=1e-3, grad_k=6, weight_k=7,
                   weight_absolute=False),
    "ef_sgd": dict(alpha=1e-3, beta=0.9, grad_k=None, weight_k=None),
    "terngrad": dict(alpha=1e-3, grad_k=None, weight_k=None),
}


@pytest.mark.parametrize("name", sorted(_GRAPHABLE))
def test_optimizer_steps_write_into_the_state(model, name):
    """Every single-machine optimizer's step updates the state's tensors
    in place, as a CUDA graph of it needs (the capture checks the same
    with ``_replaced`` and raises)."""
    sess = TrainSession.from_optimizer(
        _GRAPHABLE[name](), _loss_fn(model),
        model.init(seed=0, device="cpu"), tbatches(model.cfg, SEQ, BATCH),
        SessionConfig(log_every=0), log=lambda *_: None)
    before = _tensor_leaves(sess.state)
    with sess:
        sess.run(2)
    assert _replaced(before, sess.state) == []


@pytest.mark.parametrize("mode", sorted(_DIST_MODES))
def test_distributed_steps_write_into_the_state(model, group, mode):
    art = t_make_train_step(model, group, TTC(**_DIST_MODES[mode],
                                              mode=mode))
    sess = TrainSession.from_artifacts(
        art, tbatches(model.cfg, SEQ, BATCH), SessionConfig(log_every=0),
        device="cpu", log=lambda *_: None)
    before = _tensor_leaves(sess.state)
    with sess:
        sess.run(2)
    assert _replaced(before, sess.state) == []


def test_replaced_names_a_new_tensor():
    state = {"params": [torch.zeros(3)], "opt": {"m": torch.zeros(3)}}
    before = _tensor_leaves(state)
    assert _replaced(before, state) == []
    state["opt"]["m"] = state["opt"]["m"] + 1
    assert _replaced(before, state) == ["opt/m"]


@pytest.mark.parametrize("name", ["log_every", "eval_every", "ckpt_every"])
def test_cadences_must_be_chunk_multiples(model, name):
    kw = {"log_every": 4, name: 6}
    if name == "ckpt_every":
        kw["ckpt_dir"] = "unused"
    with pytest.raises(ValueError, match=f"{name}=6 must be a multiple of "
                                         f"scan_chunk=4"):
        _alg1(model, scan_chunk=4, **kw)


def test_chunked_builders_on_the_cpu(model):
    """``opt.multistep``'s builders (the session module's): K steps a call,
    bitwise the session's steps; ``donate=False`` leaves the caller's
    tensors as they were."""
    from repro_torch.opt.multistep import (make_chunked_train_step,
                                           make_chunked_update,
                                           stack_batches)
    from repro_torch.train.session import stage_batch
    from repro_torch.tree import tree_leaves, tree_map
    opt = qadam(QAdamConfig(**OPT))
    with _alg1(model) as ref:
        ref_losses = _every_loss(ref, 4)
    for donate in (True, False):
        fn = make_chunked_train_step(opt, _loss_fn(model), donate=donate)
        params = model.init(seed=0, device="cpu")
        state = opt.init(params)
        gen = tbatches(model.cfg, SEQ, BATCH)
        losses = []
        for _ in range(2):
            stacked = stack_batches([stage_batch(next(gen), "cpu")
                                     for _ in range(2)])
            keep = [t.clone() for t in tree_leaves(params)]
            p2, s2, ls = fn(params, state, stacked)
            losses += ls.tolist()
            if not donate:
                assert all(torch.equal(a, b) for a, b in
                           zip(keep, tree_leaves(params)))
            params, state = p2, s2
        assert losses == [ref_losses[s] for s in range(1, 5)]
        assert state.count == 4
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(params), tree_leaves(ref.state["params"])))
        assert fn.stats == {"graph_captures": 0, "graph_replays": 0}
    # K updates a call from stacked gradients
    params = model.init(seed=0, device="cpu")
    grads = [tree_map(lambda p, i=i: torch.full_like(p, 1e-3 * (i + 1)),
                      params) for i in range(3)]
    upd = make_chunked_update(opt)
    p1, s1 = upd(tree_map(torch.clone, params), opt.init(params),
                 stack_batches(grads))
    p2 = tree_map(torch.clone, params)
    s2 = opt.init(p2)
    from repro_torch.core.qadam import apply_updates
    for g in grads:
        u, s2 = opt.update(g, s2, p2)
        p2 = apply_updates(p2, u)
    assert s1.count == s2.count == 3
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p1),
                                                 tree_leaves(p2)))


# ---------------------------------------------------------------------------
# evals, the train() shim, the launcher
# ---------------------------------------------------------------------------

def test_evals_get_their_own_history_entries(model):
    seen = []

    def eval_fn(state):
        seen.append(state["opt"].count)
        return {"count": state["opt"].count}
    with _alg1(model, log_every=2, scan_chunk=2, eval_every=2,
               eval_fn=eval_fn) as sess:
        sess.run(5)
    evals = [h for h in sess.history if "eval" in h]
    assert evals == [{"step": 2, "eval": {"count": 2}},
                     {"step": 4, "eval": {"count": 4}}]
    assert seen == [2, 4]
    assert [h["step"] for h in sess.history if "loss" in h] == [2, 4, 5]


def test_train_shim(model, group, tmp_path):
    art = t_make_train_step(model, group, TTC(**DIST))
    lc = LoopConfig(steps=4, log_every=2, ckpt_every=2,
                    ckpt_dir=str(tmp_path), scan_chunk=2,
                    eval_every=4, eval_fn=lambda s: s["count"])
    state, history = train(art, art.config, tbatches(model.cfg, SEQ, BATCH),
                           lc, device="cpu", log=lambda *_: None)
    assert state["count"] == 4
    assert [h["step"] for h in history if "loss" in h] == [2, 4]
    assert {"step": 4, "eval": 4} in history
    assert store.latest_step(str(tmp_path)) == 4
    with _dist(model, group) as ref:
        ref.run(4)
    _assert_same_state(ref.state, state)


def _launch(*args):
    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"))
    env.pop("RANK", None)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "yi-6b",
         "--smoke", "--device", "cpu", "--seq", str(SEQ), "--global-batch",
         str(BATCH), "--weight-bits", "7", "--weight-absolute",
         "--log-every", "1", *args], env=env, capture_output=True,
        text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_launcher_checkpoints_and_resumes(tmp_path, model, group):
    """``--steps`` is the total budget: a run of 3 steps (two steps a
    dispatch) checkpoints at 2, the resumed run of ``--steps 5`` restores
    step 2 and runs 3 more, and its losses are those of one unbroken
    5-step session of the same configuration."""
    d = str(tmp_path / "ck")
    first = _launch("--steps", "3", "--ckpt-dir", d, "--ckpt-every", "2",
                    "--scan-chunk", "2", "--log-every", "2")
    assert "'dispatches': 2" in first and store.latest_step(d) == 2
    out = _launch("--steps", "5", "--ckpt-dir", d, "--ckpt-every", "2",
                  "--resume", "--history-out", str(tmp_path / "res.json"))
    assert f"resumed from step 2 ({d})" in out
    with _dist(model, group) as whole:
        whole.run(5)
    want = _losses(whole)
    got = {h["step"]: h["loss"] for h in json.load(
        open(tmp_path / "res.json"))["history"]}
    assert sorted(got) == [3, 4, 5]
    assert all(got[s] == want[s] for s in got)
    assert store.latest_step(d) == 4
    assert "nothing to do" in _launch("--steps", "4", "--ckpt-dir", d,
                                      "--resume")


def test_launcher_flags_still_refused():
    from repro_torch.launch import train as launch
    # the performance flags parse (the sweep and the artifacts run on
    # the card: tests/test_torch_perf.py)
    a = launch.parse_args(["--arch", "yi-6b", "--tune-buckets", "--aot-dir",
                           "x", "--compile-cache", "c", "--no-compile-cache"])
    assert (a.tune_buckets, a.aot_dir, a.compile_cache,
            a.no_compile_cache) == (True, "x", "c", True)
    with pytest.raises(SystemExit):
        launch.parse_args(["--arch", "yi-6b", "--resume"])
    a = launch.parse_args(["--arch", "yi-6b", "--ckpt-dir", "x", "--resume",
                           "--ckpt-every", "4", "--scan-chunk", "2",
                           "--ckpt-codec", "uniform_amax:7"])
    assert (a.ckpt_keep, a.scan_chunk, a.ckpt_codec) == (3, 2,
                                                         "uniform_amax:7")


# ---------------------------------------------------------------------------
# two gloo ranks
# ---------------------------------------------------------------------------

def _rank(rank, n_workers, store_path, out_dir, mode):
    """Spawned: one gloo rank runs 4 steps straight, then 2 steps with a
    checkpoint at 2 (rank 0 gathers and writes), then resumes in a new
    session and runs 2 more; saves both states and the losses."""
    torch.set_num_threads(1)
    TM.make_process_group(
        "cpu", store=torch.distributed.FileStore(store_path, n_workers),
        rank=rank, world_size=n_workers)
    try:
        model = TModel(tget("yi-6b", smoke=True))
        grp = torch.distributed.group.WORLD
        d = os.path.join(out_dir, "ck")
        with _dist(model, grp, mode) as a:
            a.run(4)
        with _dist(model, grp, mode, ckpt_dir=d, ckpt_every=2) as b:
            b.run(2)
        c = _dist(model, grp, mode, ckpt_dir=d)
        found = c.resume()
        with c:
            c.run(2)
        fa, ca = _flat_state(a.state)
        fc, cc = _flat_state(c.state)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), found=found,
                 counts=np.array([ca, cc]),
                 la=np.array([_losses(a)[s] for s in (3, 4)]),
                 lc=np.array([_losses(c)[s] for s in (3, 4)]),
                 **{f"a:{k}": v.numpy() for k, v in fa.items()},
                 **{f"c:{k}": v.numpy() for k, v in fc.items()})
    finally:
        TM.close_process_group()


@pytest.mark.parametrize("mode", ["qadam", "dp_adam"])
def test_two_ranks_resume_bitwise(tmp_path, mode):
    import torch.multiprocessing as mp
    ctx = mp.spawn(_rank, args=(2, str(tmp_path / "store"), str(tmp_path),
                                mode), nprocs=2, join=False)
    deadline = time.monotonic() + 240
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError("2 gloo ranks did not finish")
    man = json.load(open(tmp_path / "ck" / "step_00000002" /
                         "manifest.json"))
    master = [l for l in man["leaves"] if l["key"].startswith("master/")]
    assert master and all(l["shape"][:2] == [2, 1] for l in master)
    for r in range(2):
        z = np.load(tmp_path / f"rank{r}.npz")
        assert int(z["found"]) == 2
        assert list(z["counts"]) == [4, 4]
        np.testing.assert_array_equal(z["la"], z["lc"])
        keys = [k[2:] for k in z.files if k.startswith("a:")]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(z[f"a:{k}"], z[f"c:{k}"],
                                          err_msg=k)
