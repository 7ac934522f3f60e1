"""TernGrad's draws in the port's training paths against the JAX package,
with no replay: the port draws the reference's threefry uniforms itself
(``core.uniforms``), on the CPU.

  * Algorithm 1 (``terngrad_sgd``, ``qadam(grad_q="terngrad")``) on a
    loss linear in its parameters, whose gradients are the batch exactly
    in both packages: every draw (recorded) bitwise the reference's key
    chain, ``terngrad_sgd``'s quantized gradient Q(g) bitwise the
    reference quantizer's under the same key, the state key after four
    session steps bitwise the reference session's (also for ``qadam``
    and ``ef_sgdm``, which split it without drawing), and the parameters
    at the trajectory tier (rel L2 4e-6: XLA on the CPU contracts the
    update into the parameter with fused multiply-adds, a rounding apart
    on a few elements);
  * checkpoints in the reference's format: a reference checkpoint
    resumed in the port draws the reference's steps 3 and 4 (bitwise)
    and ends on the unbroken run's key; a port checkpoint resumed in
    the reference ends on the port's unbroken key; a port checkpoint
    resumed in the port is bitwise the unbroken run; parameters across
    the packages at the trajectory tier;
  * ``scan_chunk=4`` bitwise ``scan_chunk=1`` (the K steps a dispatch
    draw what the steps one by one draw): both Algorithm 1 optimizers
    and the distributed ``terngrad`` mode;
  * the distributed ``terngrad`` mode at one worker (one gloo rank in
    process) against the reference's ``(1, 1)`` mesh, from its initial
    state: the draws bitwise the reference's (step, leaf, worker) keys,
    the trajectory at the tier of ``tests/test_torch_dist.py`` (losses
    within rel 2.3e-4, the master within rel L2 4e-6); four workers are
    in ``tests/test_torch_threefry_workers.py``;
  * the paper protocol's TernGrad arm (``examples/paper_repro_torch.py``
    ``run`` against ``examples/paper_repro.py``) at four workers, each
    worker's key folded from the optimizer's: the tier of
    ``tests/test_torch_paper_repro.py``;
  * ``qadam(grad_q="terngrad")`` five smoke-model session steps against
    the reference's at the tier of ``tests/test_torch_baselines.py``.
"""
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from repro.core import qadam as JQA
from repro.data import pipeline as JD
from repro.train.session import SessionConfig as JSC
from repro.train.session import TrainSession as JSession
from repro_torch.convert import params_from_numpy
from repro_torch.core import qadam as TQA
from repro_torch.core import uniforms
from repro_torch.data import pipeline as TD
from repro_torch.train.session import SessionConfig as TSC
from repro_torch.train.session import TrainSession as TSession
from repro_torch.train.session import _tensor_leaves
from test_torch_baselines import (_gate, _port_session, _reference_session,
                                  models)  # noqa: F401
from test_torch_dist import (BASE, TERNGRAD, _paths, _port_run, _reference,
                             group)  # noqa: F401
from test_torch_dist import _gate as dist_gate

HERE = os.path.dirname(os.path.abspath(__file__))
# a flat tree, its insertion order not the reference's (sorted) order
SHAPES = {"w": (16, 8), "c": (4, 7), "a": (33,), "d": (5,)}
STEPS = 4
PARAM_REL_L2 = 4e-6

OPTS = {
    "terngrad_sgd": lambda M: M.terngrad_sgd(alpha=0.05, seed=3),
    "qadam-terngrad": lambda M: M.qadam(M.QAdamConfig(
        alpha=1e-2, grad_q="terngrad"), seed=3),
}
SPLIT_ONLY = {
    "qadam-log6": lambda M: M.qadam(M.QAdamConfig(alpha=1e-3), seed=4),
    "ef_sgdm": lambda M: M.ef_sgdm(alpha=1e-2, seed=5),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params():
    rng = np.random.default_rng(1)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}


def _batches(seed=2):
    rng = np.random.default_rng(seed)
    while True:
        yield {k: rng.standard_normal(s).astype(np.float32)
               for k, s in SHAPES.items()}


def _jloss(p, b):
    return sum((p[k] * b[k]).sum() for k in sorted(p))


def _tloss(p, b):
    return sum((p[k] * b[k]).sum() for k in sorted(p))


def _jsession(opt, steps, ckpt_dir=None, resume=False, **kw):
    sess = JSession.from_optimizer(
        opt, _jloss, jax.tree.map(np.asarray, _params()), _batches(),
        JSC(log_every=1, ckpt_dir=ckpt_dir, prefetch=0, **kw),
        log=lambda *_: None)
    if resume:
        sess.resume()
    sess.run(steps)
    sess.wait_for_checkpoints()
    out = ({k: np.asarray(v) for k, v in sess.state["params"].items()},
           np.asarray(sess.state["opt"].key))
    sess.close()
    return out


def _tsession(opt, steps, ckpt_dir=None, resume=False, **kw):
    kw.setdefault("log_every", 1)
    sess = _keep_losses(TSession.from_optimizer(
        opt, _tloss, params_from_numpy(_params(), "cpu"), _batches(),
        TSC(ckpt_dir=ckpt_dir, **kw), log=lambda *_: None))
    if resume:
        sess.resume()
    with sess:
        sess.run(steps)
        sess.wait_for_checkpoints()
    return ({k: v.numpy() for k, v in sess.state["params"].items()},
            sess.state["opt"].key.numpy().view(np.uint32)), sess


def _equal(a, b, bitwise=True):
    """Parameters bitwise (or within rel L2 4e-6) and keys bitwise."""
    (pa, ka), (pb, kb) = a, b
    assert pa.keys() == pb.keys()
    if bitwise:
        for k in pa:
            np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)
    else:
        num = sum(float(((pa[k] - pb[k]) ** 2).sum()) for k in pa)
        den = sum(float((pa[k] ** 2).sum()) for k in pa)
        print(f"params rel L2 {(num / den) ** 0.5:.2e}")
        assert (num / den) ** 0.5 <= PARAM_REL_L2
    np.testing.assert_array_equal(np.asarray(ka, np.uint32),
                                  np.asarray(kb, np.uint32))


def _chain_draws(seed, steps):
    """The reference's Algorithm 1 draws of ``steps`` steps: (step, leaf)
    -> the flat uniforms, leaves in sorted order."""
    names = sorted(SHAPES)
    key, out = jax.random.PRNGKey(seed), {}
    for t in range(1, steps + 1):
        key, sub = jax.random.split(key)
        for leaf, k in enumerate(jax.random.split(sub, len(names))):
            out[t, leaf] = np.asarray(jax.random.uniform(
                k, SHAPES[names[leaf]])).reshape(-1)
    return out


def _draws_equal(seen, want, first_step=1):
    n = len(SHAPES)
    assert len(seen) % n == 0 and len(seen) > 0
    for j, (leaf, u) in enumerate(seen):
        ref = want[first_step + j // n, leaf]
        np.testing.assert_array_equal(ref.view(np.int32),
                                      u.numpy().view(np.int32))


def _record(monkeypatch):
    """Record every ``uniforms.draw`` (leaf index, the uniforms)."""
    seen = []
    draw = uniforms.draw

    def rec(keys, leaf, n, backend=None):
        u = draw(keys, leaf, n, backend=backend)
        seen.append((leaf, u.clone()))
        return u
    monkeypatch.setattr(uniforms, "draw", rec)
    return seen


@pytest.mark.parametrize("name", list(OPTS))
def test_algorithm1_draws_are_the_reference(name, monkeypatch):
    """Every draw the reference's (its key split once a step, the subkey
    split over the sorted leaves, ``jax.random.uniform`` at the leaf's
    shape) and the state key after four steps bitwise; ``terngrad_sgd``'s
    Q(g) bitwise the reference quantizer's; the parameters at the
    trajectory tier."""
    from repro.core.quantizers import get_quantizer
    seen = _record(monkeypatch)
    quantized = []
    quantize = TQA._quantize

    def rec(gq, x, draw, backend):
        q = quantize(gq, x, draw, backend)
        quantized.append(q.clone())
        return q
    monkeypatch.setattr(TQA, "_quantize", rec)
    want = _jsession(OPTS[name](JQA), STEPS)
    got, _ = _tsession(OPTS[name](TQA), STEPS)
    _equal(want, got, bitwise=False)
    _draws_equal(seen, _chain_draws(3, STEPS))
    if name != "terngrad_sgd":
        return
    # Q(g) of the batch (the exact gradient), leaf by leaf in the port's
    # tree order, against the reference quantizer under the leaf's key
    names, order = sorted(SHAPES), list(SHAPES)
    jq, key, batches = get_quantizer("terngrad"), jax.random.PRNGKey(3), \
        _batches()
    for t in range(STEPS):
        key, sub = jax.random.split(key)
        subs, b = jax.random.split(sub, len(names)), next(batches)
        for j, k in enumerate(order):
            ref = np.asarray(jq(b[k], key=subs[names.index(k)]))
            np.testing.assert_array_equal(
                ref, quantized[t * len(order) + j].numpy(), err_msg=k)


@pytest.mark.parametrize("name", list(SPLIT_ONLY))
def test_state_key_splits_as_the_reference(name):
    """Optimizers that draw nothing split the key all the same: after
    four steps it is the reference's (so a checkpoint carries it)."""
    want = _jsession(SPLIT_ONLY[name](JQA), STEPS)
    got, _ = _tsession(SPLIT_ONLY[name](TQA), STEPS)
    np.testing.assert_array_equal(want[1], got[1])


@pytest.mark.parametrize("name", list(OPTS))
def test_checkpoints_cross_with_the_key(name, tmp_path):
    """Two steps, a checkpoint in the reference's format, two more after
    a resume: a reference checkpoint resumed in the port draws the
    reference's steps 3 and 4 and ends on the unbroken run's key; a port
    checkpoint resumed in the reference ends on the port's unbroken key,
    and resumed in the port is bitwise the unbroken run."""
    ref_whole = _jsession(OPTS[name](JQA), STEPS)
    port_whole = _tsession(OPTS[name](TQA), STEPS)[0]
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    _jsession(OPTS[name](JQA), 2, ref_dir, ckpt_every=2)
    with pytest.MonkeyPatch.context() as mp:
        seen = _record(mp)
        got, sess = _tsession(OPTS[name](TQA), 2, ref_dir, resume=True)
    assert sess.step == STEPS
    _draws_equal(seen, _chain_draws(3, STEPS), first_step=3)
    _equal(ref_whole, got, bitwise=False)
    _tsession(OPTS[name](TQA), 2, port_dir, ckpt_every=2)
    _equal(port_whole, _jsession(OPTS[name](JQA), 2, port_dir, resume=True),
           bitwise=False)
    _equal(port_whole, _tsession(OPTS[name](TQA), 2, port_dir,
                                 resume=True)[0])


@pytest.mark.parametrize("name", list(OPTS))
def test_scan_chunk_draws_as_step_by_step(name):
    one = _tsession(OPTS[name](TQA), 8, log_every=4)[1]
    four = _tsession(OPTS[name](TQA), 8, log_every=4, scan_chunk=4)[1]
    assert four.stats["dispatches"] == 2
    _states_equal(one, four)


def _keep_losses(sess):
    """Every harvested (step, loss) of ``sess``, in ``sess.losses``."""
    sess.losses, harvest = {}, sess.harvest_losses

    def keep():
        out = harvest()
        sess.losses.update(out)
        return out
    sess.harvest_losses = keep
    return sess


def _states_equal(a, b):
    """Every step's loss and every state tensor bitwise."""
    assert a.losses == b.losses and sorted(a.losses) == list(range(1, 9))
    x, y = _tensor_leaves(a.state), _tensor_leaves(b.state)
    assert [k for k, _ in x] == [k for k, _ in y]
    for (k, u), (_, v) in zip(x, y):
        assert torch.equal(u, v), k


# ---------------------------------------------------------------------------
# the distributed mode, one worker
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dist_models():
    from repro.configs import get_config as jget
    from repro.models.model import Model as JModel
    from repro_torch.configs import get_config as tget
    from repro_torch.models.model import Model as TModel
    return JModel(jget("yi-6b", smoke=True)), TModel(tget("yi-6b",
                                                          smoke=True))


def test_dist_terngrad_one_worker_against_reference(dist_models, group,
                                                    monkeypatch):
    """Five steps from the reference's initial state with the port's own
    draws: each leaf's uniforms bitwise ``jax.random.uniform(fold_in(
    fold_in(fold_in(PRNGKey(seed), t), leaf), worker))``, the trajectory
    at the distributed tier."""
    jm, tm = dist_models
    kw = dict(BASE, mode="terngrad", seed=2, **TERNGRAD)
    init, want_l, want_m = _reference(jm, kw, 5)
    seen = _record(monkeypatch)
    _, sess = _port_run(tm, group, init, kw, 5)
    losses = [h["loss"] for h in sess.history]
    master = {p: t.numpy() for p, t in _paths(sess.state["master"])}
    assert dist_gate(want_l, dict(_paths(want_m)), losses,
                     master) == (True, True)
    n_leaves = len(seen) // 5
    assert n_leaves * 5 == len(seen) and n_leaves > 1
    for j, (leaf, u) in enumerate(seen):
        key = jax.random.fold_in(jax.random.PRNGKey(2), j // n_leaves + 1)
        key = jax.random.fold_in(jax.random.fold_in(key, leaf), 0)
        ref = np.asarray(jax.random.uniform(key, (u.numel(),)))
        np.testing.assert_array_equal(ref.view(np.int32),
                                      u.numpy().view(np.int32))


def test_dist_terngrad_scan_chunk_draws_as_step_by_step(dist_models, group):
    """Eight steps at ``scan_chunk=4`` (each step's t from the session's
    step table) bitwise eight steps one by one."""
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.dist.step import TrainConfig, make_train_step
    _, tm = dist_models
    art = make_train_step(tm, group, TrainConfig(**dict(
        BASE, mode="terngrad", **TERNGRAD)))

    def run(k):
        sess = _keep_losses(TSession.from_artifacts(
            art, batch_for_model(tm.cfg, 32, 4),
            TSC(log_every=4, scan_chunk=k), device="cpu",
            log=lambda *_: None))
        with sess:
            sess.run(8)
        return sess
    one, four = run(1), run(4)
    assert four.stats["dispatches"] == 2
    _states_equal(one, four)


# ---------------------------------------------------------------------------
# the paper protocol's TernGrad arm, and qadam(terngrad) on the smoke model
# ---------------------------------------------------------------------------

def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "..", "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_paper_protocol_terngrad_against_reference():
    jex, tex = _load("paper_repro"), _load("paper_repro_torch")
    jdata = JD.classification_dataset(JD.ClsDataConfig(seed=1))
    tdata = TD.classification_dataset(TD.ClsDataConfig(seed=1), "cpu")
    kind, kw, _, _, _ = tex.methods("qadam")["TernGrad"]
    key = jax.random.PRNGKey(1)
    jp0 = jex.mlp_init(key, 32, tex.HIDDEN, 50)
    jp = jex.run(getattr(JQA, kind)(**kw), 3, jdata, key, seed=100,
                 n_workers=4)
    tp = tex.run(tex.build(kind, kw), 3, tdata,
                 params_from_numpy(jax.tree.map(np.asarray, jp0), "cpu"),
                 seed=100, n_workers=4)
    want = {k: np.asarray(v) for k, v in jp.items()}
    num = sum(float(((want[k] - tp[k].numpy()) ** 2).sum()) for k in tp)
    den = sum(float((want[k] ** 2).sum()) for k in tp)
    want_l = float(jex.loss_fn(jp, jdata[2], jdata[3]))
    got_l = float(tex.loss_fn(tp, tdata[2], tdata[3]))
    print(f"paper TernGrad: params rel L2 {(num / den) ** 0.5:.2e}, test "
          f"loss rel drift {abs(got_l - want_l) / want_l:.2e}")
    assert (num / den) ** 0.5 <= 4e-6
    assert abs(got_l - want_l) <= 2.3e-4 * abs(want_l)


def test_qadam_terngrad_smoke_session_against_reference(models):
    jm, tm, jp = models
    make = OPTS["qadam-terngrad"]
    want = _reference_session(jm, jp, make)
    got = _port_session(tm, jp, make(TQA))
    assert _gate(want, got, "qadam-terngrad") == (True, True)
