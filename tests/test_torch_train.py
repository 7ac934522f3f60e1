"""The port's single-machine training slice (Algorithm 1) against the JAX
package: data batches, ``Model.loss`` and its gradients, ``qadam``'s
forward params and update, and five steps of ``TrainSession``, on the
yi-6b smoke config in float32 from parameters carried over as numpy.

Tiers:
  * bitwise: batches, the Q_x forward params (per tensor, one amax per
    stacked leaf), alpha_t and theta_t, the carried-over state;
  * ``Model.loss`` rtol 1e-5 and per-leaf gradient rel L2 <= 1e-5
    (measured 2.3e-7 and <= 5.5e-7: float32 summation order and XLA's
    fma/rsqrt on the CPU);
  * ``qadam.update`` from identical state and gradients: an element's
    update differs only where XLA's ulps in Delta+e cross a log-grid
    decision point, and then by exactly one level (measured: 0 of
    1,230,720 elements over 3 steps of the 12 leaves);
  * five session steps: losses within rtol 2.3e-4 (the reference's own
    drift between its equivalent programs, ROADMAP queue 3; measured
    2.3e-7) and final parameters within rel L2 4e-6 (10x the measured
    4.0e-7). The gate fails on planted faults: error feedback off on the
    port side only (loss drift 6.9e-4 at step 5) and k_g off by one
    (parameter drift 3.1e-5).

The measured figures are what these tests print (``pytest -s``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import qadam as JQA
from repro.data.pipeline import batch_for_model as jbatches
from repro.models.model import Model as JModel
from repro.train.session import SessionConfig as JSC
from repro.train.session import TrainSession as JSession
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy, qadam_state_from_numpy
from repro_torch.core import qadam as TQA
from repro_torch.data.pipeline import batch_for_model as tbatches
from repro_torch.models.model import Model as TModel
from repro_torch.train.session import SessionConfig as TSC
from repro_torch.train.session import TrainSession as TSession
from repro_torch.tree import tree_leaves, tree_unflatten

OPT = dict(alpha=3e-3, grad_q="log:6", weight_q="uniform_amax:7",
           weight_q_min_numel=2 ** 14)       # examples/quickstart.py
LOSS_RTOL = 2.3e-4
PARAM_REL_L2 = 4e-6
STEPS, SEQ, BATCH = 5, 64, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The smoke model's tensors are small: one intra-op thread is faster,
    and the test processes of a parallel run share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    jm = JModel(jget("yi-6b", smoke=True))
    tm = TModel(tget("yi-6b", smoke=True))
    return jm, tm, jm.init(jax.random.PRNGKey(0))


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _paths(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{path}['{k}']")
    else:
        yield path, tree


def _by_path(jtree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(jtree)[0]}


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def test_batches_identical(models):
    jm, tm, _ = models
    jb, tb = jbatches(jm.cfg, 48, 3, seed=7), tbatches(tm.cfg, 48, 3, seed=7)
    for _ in range(3):
        a, b = next(jb), next(tb)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_loss_and_grads(models):
    jm, tm, jp = models
    batch = next(jbatches(jm.cfg, SEQ, BATCH))
    (jl, jn), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, batch)
    tp = params_from_numpy(_np_tree(jp), "cpu")
    leaves = [l.requires_grad_() for l in tree_leaves(tp)]
    tl, tn = tm.loss(tree_unflatten(tp, leaves), _torch_batch(batch))
    grads = tree_unflatten(tp, torch.autograd.grad(tl, leaves))
    tl = tl.detach()
    assert float(tn) == float(jn) == SEQ * BATCH
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = _by_path(jg)
    worst = 0.0
    for path, g in _paths(grads):
        a = want[path]
        rel = np.linalg.norm(a - g.numpy()) / np.linalg.norm(a)
        assert rel <= 1e-5, (path, rel)
        worst = max(worst, rel)
    print(f"loss rel {abs(float(tl) - float(jl)) / abs(float(jl)):.2e}, "
          f"largest gradient rel L2 {worst:.2e}")


@pytest.mark.parametrize("schedule", ["constant", "sqrt", "halving:3"])
def test_schedules_bitwise(schedule):
    jc = JQA.QAdamConfig(alpha=3e-3, schedule=schedule)
    tc = TQA.QAdamConfig(alpha=3e-3, schedule=schedule)
    for t in (1, 2, 3, 7, 100, 12345):
        tt = jnp.asarray(t, jnp.int32)
        assert np.float32(JQA._alpha_t(jc, tt)) == TQA._alpha_t(tc, t)
        assert np.float32(JQA._theta_t(jc, tt)) == TQA._theta_t(tc, t)


def test_forward_params_bitwise(models):
    jm, tm, jp = models
    jp = jax.tree.map(lambda p: p * 7.0, jp)     # values beyond +/-0.5
    jopt = JQA.qadam(JQA.QAdamConfig(**OPT))
    topt = TQA.qadam(TQA.QAdamConfig(**OPT))
    tp = params_from_numpy(_np_tree(jp), "cpu")
    want = _by_path(jopt.forward_params(jp))
    got = topt.forward_params(tp)
    for path, t in _paths(got):
        np.testing.assert_array_equal(want[path], t.numpy(), err_msg=path)
    assert got["blocks"]["ln1"]["w"] is tp["blocks"]["ln1"]["w"]
    assert got["blocks"]["attn"]["k"] is tp["blocks"]["attn"]["k"]


def test_config_backend_reaches_both_halves(models):
    """``QAdamConfig.backend`` picks the implementation in forward_params
    (the Q_x codecs) as in update: "cuda" on CPU tensors raises in both,
    "torch" gives the default's results."""
    _, _, jp = models
    tp = params_from_numpy(_np_tree(jp), "cpu")
    cuda = TQA.qadam(TQA.QAdamConfig(**OPT, backend="cuda"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda.forward_params(tp)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda.update(tp, cuda.init(tp))
    plain = TQA.qadam(TQA.QAdamConfig(**OPT, backend="torch"))
    want = TQA.qadam(TQA.QAdamConfig(**OPT)).forward_params(tp)
    for (path, a), (_, b) in zip(_paths(want), _paths(
            plain.forward_params(tp))):
        assert torch.equal(a, b), path


def test_update_from_identical_state(models):
    """Three updates from identical state and gradients. The scale (the
    top level) may differ by XLA's ulps in Delta+e; apart from it, an
    element's update may move one level where those ulps cross a
    decision point (measured: 0 of 1,230,720 elements moved)."""
    jm, tm, jp = models
    jopt = JQA.qadam(JQA.QAdamConfig(**OPT, backend="jnp"))
    topt = TQA.qadam(TQA.QAdamConfig(**OPT))
    js = jopt.init(jp)
    batches = jbatches(jm.cfg, SEQ, BATCH, seed=3)
    grad = jax.jit(jax.grad(lambda p, b: jm.loss(p, b)[0]))
    moved = total = 0
    for step in range(3):
        g = grad(jp, next(batches))
        ts = qadam_state_from_numpy(_np_tree(js), "cpu")
        assert ts.count == step
        ju, js = jopt.update(g, js, jp)
        tu, ts2 = topt.update(params_from_numpy(_np_tree(g), "cpu"), ts)
        assert ts2.count == step + 1
        want_u, want_m = _by_path(ju), _by_path(js.m)
        for (path, u), (_, mm) in zip(_paths(tu), _paths(ts2.m)):
            a, b = np.abs(want_u[path]), np.abs(u.numpy())
            # the scales are the top level, reached by the largest
            # element; they may differ by XLA's ulps in Delta+e
            r = b.max() / a.max()
            assert abs(r - 1) <= 1e-6, path
            same = np.isclose(b, r * a, rtol=1e-6, atol=0)
            one_level = (np.isclose(b, 2 * r * a, rtol=1e-6, atol=0)
                         | np.isclose(2 * b, r * a, rtol=1e-6, atol=0)
                         | ((a == 0) & (b <= 2.0 ** -6 * b.max() * 1.01))
                         | ((b == 0) & (a <= 2.0 ** -6 * a.max() * 1.01)))
            assert (same | one_level).all(), path
            assert (np.sign(want_u[path]) * np.sign(u.numpy()) >= 0).all()
            moved += int((~same).sum())
            total += a.size
            # m' differs by XLA's fma at cancellation (test_torch_adam_ef)
            np.testing.assert_allclose(
                want_m[path], mm.numpy(), rtol=1e-5,
                atol=1e-6 * float(np.abs(want_m[path]).max()))
        jp = JQA.apply_updates(jp, ju)
    print(f"moved a level: {moved} of {total} elements")
    assert moved <= 1e-3 * total, (moved, total)


def test_update_without_grad_quantizer(models):
    """grad_q=None: the update is -(Delta+e) and the residual stays 0, as
    in the reference; Delta+e to XLA's fma/rsqrt ulps (tier of
    test_torch_adam_ef), here rel 1e-5 with a floor of 1e-6 of the
    largest update."""
    jm, _, jp = models
    kw = dict(OPT, grad_q=None)
    jopt = JQA.qadam(JQA.QAdamConfig(**kw, backend="jnp"))
    topt = TQA.qadam(TQA.QAdamConfig(**kw))
    g = jax.jit(jax.grad(lambda p, b: jm.loss(p, b)[0]))(
        jp, next(jbatches(jm.cfg, SEQ, BATCH)))
    js = jopt.init(jp)
    ts = qadam_state_from_numpy(_np_tree(js), "cpu")
    ju, js = jopt.update(g, js, jp)
    tu, ts = topt.update(params_from_numpy(_np_tree(g), "cpu"), ts)
    want = _by_path(ju)
    for (path, u), (_, e) in zip(_paths(tu), _paths(ts.e)):
        np.testing.assert_allclose(
            want[path], u.numpy(), rtol=1e-5,
            atol=1e-6 * float(np.abs(want[path]).max()), err_msg=path)
        assert not e.any(), path


def _session_losses(opt_kw, jp, tm, cfg=None):
    tp = params_from_numpy(_np_tree(jp), "cpu")
    opt = TQA.qadam(TQA.QAdamConfig(**opt_kw))

    def loss_fn(p, b):
        ls, nt = tm.loss(p, b)
        return ls / nt
    sess = TSession.from_optimizer(opt, loss_fn, tp,
                                   tbatches(tm.cfg, SEQ, BATCH),
                                   cfg or TSC(log_every=1), log=lambda *_: 0)
    with sess:
        sess.run(STEPS)
    return sess


@pytest.fixture(scope="module")
def reference_run(models):
    jm, _, jp = models

    def loss_fn(p, b):
        ls, nt = jm.loss(p, b)
        return ls / nt
    sess = JSession.from_optimizer(
        JQA.qadam(JQA.QAdamConfig(**OPT, backend="jnp")), loss_fn, jp,
        jbatches(jm.cfg, SEQ, BATCH), JSC(log_every=1), log=lambda *_: 0)
    sess.run(STEPS)
    losses = np.array([h["loss"] for h in sess.history])
    params = _by_path(sess.state["params"])
    sess.close()
    return losses, params


def _gate(reference, sess):
    """(losses within LOSS_RTOL, params within PARAM_REL_L2) of the port
    session against the reference run; prints the drifts."""
    want_l, want_p = reference
    got_l = np.array([h["loss"] for h in sess.history])
    assert got_l.shape == want_l.shape
    loss_rel = float((np.abs(got_l - want_l) / np.abs(want_l)).max())
    num = den = 0.0
    for path, t in _paths(sess.state["params"]):
        num += float(((want_p[path] - t.numpy()) ** 2).sum())
        den += float((want_p[path] ** 2).sum())
    param_rel = (num / den) ** 0.5
    print(f"largest loss rel drift {loss_rel:.2e}, params rel L2 "
          f"{param_rel:.2e}")
    return loss_rel <= LOSS_RTOL, param_rel <= PARAM_REL_L2


def test_slice_five_steps_against_reference(models, reference_run):
    _, tm, jp = models
    sess = _session_losses(OPT, jp, tm)
    assert sess.step == STEPS and len(sess.history) == STEPS
    assert _gate(reference_run, sess) == (True, True)


@pytest.mark.parametrize("fault", [dict(error_feedback=False),
                                   dict(grad_q="log:5")])
def test_slice_gate_fails_on_planted_fault(models, reference_run, fault):
    _, tm, jp = models
    sess = _session_losses(dict(OPT, **fault), jp, tm)
    losses_ok, params_ok = _gate(reference_run, sess)
    assert not (losses_ok and params_ok)
    if "error_feedback" in fault:
        assert not losses_ok       # the loss gate alone catches EF off


def test_session_syncs_and_loss_ring(models):
    _, tm, jp = models
    per_step = _session_losses(OPT, jp, tm)            # reads every step
    assert per_step.stats["syncs"] == STEPS
    quiet = _session_losses(OPT, jp, tm, TSC(log_every=0))
    assert quiet.stats == {"dispatches": STEPS, "syncs": 0, "steps": STEPS,
                           "ckpts": 0, "graph_captures": 0,
                           "graph_replays": 0}
    ring = quiet.harvest_losses()   # one read; a 2-slot ring at log_every 0
    assert quiet.stats["syncs"] == 1
    assert ring == [(h["step"], h["loss"]) for h in per_step.history[-2:]]
    boundary = _session_losses(OPT, jp, tm, TSC(log_every=STEPS))
    # the first step and the boundary: none in steps 2..STEPS-1
    assert boundary.stats["syncs"] == 2
    assert [h["step"] for h in boundary.history] == [1, STEPS]


def test_state_carried_over(models):
    _, _, jp = models
    js = JQA.qadam(JQA.QAdamConfig(**OPT)).init(jp)
    js = js._replace(count=jnp.asarray(4, jnp.int32),
                     m=jax.tree.map(lambda p: p + 1.0, js.m))
    ts = qadam_state_from_numpy(_np_tree(js), "cpu")
    assert ts.count == 4
    for path, t in _paths(ts.m):
        np.testing.assert_array_equal(_by_path(js.m)[path], t.numpy())
