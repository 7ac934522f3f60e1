"""The Algorithm 1 baselines of the port (``core.qadam`` ``ef_sgdm``,
``terngrad_sgd`` and ``wquan``; ``qadam`` with the TernGrad and blockwise
gradient quantizers in ``test_torch_baselines_qadam.py``) against the
JAX package, on the CPU.

  * five steps of ``TrainSession.from_optimizer`` on the yi-6b smoke
    config (float32, parameters carried over as numpy) against the
    reference's session, and three steps of a single worker on the
    paper's classification MLP (``examples/paper_repro.py`` ``run``
    against ``examples/paper_repro_torch.py`` ``run``). Trajectory tier:
    losses within rtol 2.3e-4 and final parameters within rel L2 4e-6
    (the distributed baselines' tier, the reference's own drift between
    its equivalent programs, ROADMAP queue 3). The stochastic
    quantizer's uniforms are the reference's: ``draw_uniform`` (in
    ``core.uniforms``) is replaced by a replay of its per-step, per-leaf
    keys (and per-worker folds). The gate fails on planted faults (the
    port's own draws; a momentum off by 0.01);
  * ``wquan``: bitwise (codes and scales as the reference's Q_x);
  * ``classification_dataset``/``classification_batches``: bitwise.

The measured drifts are what these tests print (``pytest -s``).
"""
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import qadam as JQA
from repro.data import pipeline as JD
from repro.data.pipeline import batch_for_model as jbatches
from repro.models.model import Model as JModel
from repro.train.session import SessionConfig as JSC
from repro.train.session import TrainSession as JSession
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.core import qadam as TQA
from repro_torch.core import uniforms
from repro_torch.data import pipeline as TD
from repro_torch.data.pipeline import batch_for_model as tbatches
from repro_torch.models.model import Model as TModel
from repro_torch.train.session import SessionConfig as TSC
from repro_torch.train.session import TrainSession as TSession

LOSS_RTOL = 2.3e-4
PARAM_REL_L2 = 4e-6
STEPS, SEQ, BATCH = 5, 64, 4
HERE = os.path.dirname(os.path.abspath(__file__))

# name -> (the optimizer of a package's core.qadam); learning rates at
# which five smoke steps train
OPTS = {
    "ef_sgdm": lambda M: M.ef_sgdm(alpha=1e-2, beta=0.9,
                                   grad_q="blockwise:256"),
    "ef_sgdm_terngrad": lambda M: M.ef_sgdm(alpha=1e-2, beta=0.9,
                                            grad_q="terngrad", seed=3),
    "terngrad_sgd": lambda M: M.terngrad_sgd(alpha=1e-2),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The smoke model's tensors are small: one intra-op thread is faster,
    and the test processes of a parallel run share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "..", "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def replay_draws(n_leaves: int, fold_worker: bool):
    """``draw_uniform`` replaying the reference's uniforms: its state key
    PRNGKey(seed) (folded with the worker index by the paper protocol's
    ``run``), split once a step, the step's subkey split over the leaves,
    ``jax.random.uniform`` over the leaf."""
    subkeys = {}

    def draw(seed, t, leaf, worker, n, device):
        if (seed, t, worker) not in subkeys:
            key = jax.random.PRNGKey(seed)
            if fold_worker:
                key = jax.random.fold_in(key, worker)
            else:
                assert worker == 0
            for _ in range(t):
                key, sub = jax.random.split(key)
            subkeys[seed, t, worker] = jax.random.split(sub, n_leaves)
        u = jax.random.uniform(subkeys[seed, t, worker][leaf], (n,))
        return torch.from_numpy(np.array(u)).to(device)
    return draw


def _paths(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{path}['{k}']")
    else:
        yield path, tree


def _by_path(jtree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(jtree)[0]}


def rel_l2(want: dict, got) -> float:
    num = den = 0.0
    for path, t in _paths(got):
        num += float(((want[path] - t.numpy()) ** 2).sum())
        den += float((want[path] ** 2).sum())
    return (num / den) ** 0.5


@pytest.fixture(scope="module")
def models():
    jm = JModel(jget("yi-6b", smoke=True))
    tm = TModel(tget("yi-6b", smoke=True))
    return jm, tm, jm.init(jax.random.PRNGKey(0))


def _reference_session(jm, jp, make):
    def loss_fn(p, b):
        ls, nt = jm.loss(p, b)
        return ls / nt
    sess = JSession.from_optimizer(make(JQA), loss_fn, jp,
                                   jbatches(jm.cfg, SEQ, BATCH),
                                   JSC(log_every=1), log=lambda *_: 0)
    sess.run(STEPS)
    out = (np.array([h["loss"] for h in sess.history]),
           _by_path(sess.state["params"]))
    sess.close()
    return out


def _port_session(tm, jp, opt):
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")

    def loss_fn(p, b):
        ls, nt = tm.loss(p, b)
        return ls / nt
    sess = TSession.from_optimizer(opt, loss_fn, tp,
                                   tbatches(tm.cfg, SEQ, BATCH),
                                   TSC(log_every=1), log=lambda *_: 0)
    with sess:
        sess.run(STEPS)
    return (np.array([h["loss"] for h in sess.history]),
            sess.state["params"])


def _gate(reference, port, what):
    (want_l, want_p), (got_l, got_p) = reference, port
    loss_rel = float((np.abs(got_l - want_l) / np.abs(want_l)).max())
    param_rel = rel_l2(want_p, got_p)
    print(f"{what}: losses {np.round(got_l, 4).tolist()}, largest loss "
          f"rel drift {loss_rel:.2e}, params rel L2 {param_rel:.2e}")
    return loss_rel <= LOSS_RTOL, param_rel <= PARAM_REL_L2


@pytest.fixture(scope="module")
def references(models):
    jm, _, jp = models
    return {name: _reference_session(jm, jp, make)
            for name, make in OPTS.items()}


@pytest.mark.parametrize("name", list(OPTS))
def test_session_against_reference(models, references, name, monkeypatch):
    _, tm, jp = models
    monkeypatch.setattr(uniforms, "draw_uniform",
                        replay_draws(len(jax.tree.leaves(jp)), False))
    port = _port_session(tm, jp, OPTS[name](TQA))
    assert all(np.isfinite(port[0])) and port[0][-3:].mean() < port[0][0]
    assert _gate(references[name], port, name) == (True, True)


def test_gate_fails_on_planted_faults(models, references, monkeypatch):
    """Draws under another seed's key are not the reference's; a momentum
    of 0.89 is not 0.9."""
    _, tm, jp = models
    other = _port_session(tm, jp, TQA.terngrad_sgd(alpha=1e-2, seed=1))
    assert _gate(references["terngrad_sgd"], other, "seed 1's draws") != \
        (True, True)
    fault = _port_session(tm, jp, TQA.ef_sgdm(alpha=1e-2, beta=0.89))
    assert _gate(references["ef_sgdm"], fault, "beta 0.89") != (True, True)


def test_state_layout_and_in_place(models):
    """The baselines keep the reference's state (m, v, e for every leaf,
    v unused, and the PRNG key split once a step); m, e and the key are
    updated in place."""
    _, tm, jp = models
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    grads = jax.tree.map(lambda p: np.ones(p.shape, np.float32), jp)
    grads = params_from_numpy(grads, "cpu")
    opt = TQA.ef_sgdm(alpha=1e-2)
    s = opt.init(tp)
    m0, k0 = s.m["embed"], s.key
    _, s2 = opt.update(grads, s)
    assert s2.m["embed"] is m0 and s2.count == 1 and s2.key is k0
    np.testing.assert_array_equal(
        s2.key.numpy().view(np.uint32),
        np.asarray(jax.random.split(jax.random.PRNGKey(0))[0]))
    assert not any(t.any() for _, t in _paths(s2.v))
    assert any(t.any() for _, t in _paths(s2.e))
    assert opt.forward_params(tp) is tp


@pytest.mark.parametrize("k_x,absolute", [(7, False), (5, False), (7, True)])
def test_wquan_bitwise(models, k_x, absolute):
    _, _, jp = models
    jp = jax.tree.map(lambda p: p * 3.0, jp)   # past +/-0.5 too
    want = _by_path(JQA.wquan(jp, k_x=k_x, absolute=absolute))
    got = TQA.wquan(params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
                    k_x=k_x, absolute=absolute)
    for path, t in _paths(got):
        np.testing.assert_array_equal(want[path], t.numpy(), err_msg=path)


# ---------------------------------------------------------------------------
# the paper's classification task: data, and one worker on the MLP
# ---------------------------------------------------------------------------

def test_classification_data_bitwise():
    cfg = TD.ClsDataConfig(seed=1, n_train=600, n_test=300)
    want = JD.classification_dataset(JD.ClsDataConfig(seed=1, n_train=600,
                                                      n_test=300))
    got = TD.classification_dataset(cfg, device="cpu")
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert np.asarray(a).dtype == b.numpy().dtype
    jb = JD.classification_batches(want[0], want[1], 64, seed=5)
    tb = TD.classification_batches(got[0], got[1], 64, seed=5)
    for _ in range(3):
        (jx, jy), (tx, ty) = next(jb), next(tb)
        np.testing.assert_array_equal(np.asarray(jx), tx.numpy())
        np.testing.assert_array_equal(np.asarray(jy), ty.numpy())
    with pytest.warns(UserWarning, match="replacement"):
        next(TD.classification_batches(got[0], got[1], 601))


@pytest.fixture(scope="module")
def mlp():
    jex, tex = _load("paper_repro"), _load("paper_repro_torch")
    jdata = JD.classification_dataset(JD.ClsDataConfig(seed=1))
    tdata = TD.classification_dataset(TD.ClsDataConfig(seed=1), "cpu")
    return jex, tex, jdata, tdata


@pytest.mark.parametrize("name", list(OPTS))
def test_mlp_one_worker_against_reference(mlp, name, monkeypatch):
    jex, tex, jdata, tdata = mlp
    key = jax.random.PRNGKey(2)
    jp0 = jex.mlp_init(key, 32, tex.HIDDEN, 50)
    monkeypatch.setattr(uniforms, "draw_uniform",
                        replay_draws(len(jp0), True))
    jp = jex.run(OPTS[name](JQA), 3, jdata, key, seed=7, n_workers=1)
    tp = tex.run(OPTS[name](TQA), 3, tdata,
                 params_from_numpy(jax.tree.map(np.asarray, jp0), "cpu"),
                 seed=7, n_workers=1)
    want_l = float(jex.loss_fn(jp, jdata[2], jdata[3]))
    got_l = float(tex.loss_fn(tp, tdata[2], tdata[3]))
    param_rel = rel_l2(_by_path(jp), tp)
    print(f"{name} MLP: test loss {got_l:.6f} (rel drift "
          f"{abs(got_l - want_l) / want_l:.2e}), params rel L2 "
          f"{param_rel:.2e}")
    assert abs(got_l - want_l) <= LOSS_RTOL * abs(want_l)
    assert param_rel <= PARAM_REL_L2
