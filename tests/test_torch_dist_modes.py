"""The distributed baselines of the port (``dp_adam``, ``efadam``,
``terngrad``, ``ef_sgd``; ``repro_torch.dist.modes``) at one worker,
in process on one gloo rank, against the JAX package's
``make_train_step`` on its ``(1, 1)`` mesh, from the reference's own
initial state; the two- and four-worker runs are in
``tests/test_torch_dist_workers.py`` and the files it names.

Tiers (those of ``tests/test_torch_dist.py``): five steps, losses within
rel 2.3e-4 and the master within rel L2 4e-6, the reference's own drift
between its equivalent programs:

  * ``dp_adam`` (fp32 rows all-reduced, chunk-sharded moments), with the
    uniform:7 and the float32 broadcast; ``efadam`` (server-side EF on
    the broadcast) with the absolute and the amax grid; ``ef_sgd``
    (blockwise sign codes, EF) at the reference's own settings;
  * ``terngrad`` with ``draw_uniform`` replaying the reference's draws
    (its per-(step, leaf, worker) keys); with the port's own draws it
    trains, reruns bitwise, and its wire is unbiased (the mean of many
    decoded draws within 5 standard errors of x at every element);
  * bitwise: ``dp_adam`` at one worker is ``qadam`` with both channels
    in float32, and ``efadam`` with a float32 broadcast is ``qadam``.

The measured drifts are what these tests print (``pytest -s``).
"""
import jax
import numpy as np
import pytest
import torch

from test_torch_dist import (BASE, EF_SGD, TERNGRAD, _gate, _paths,  # noqa
                             _port_run, _reference, group, models)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kw", [
    dict(mode="dp_adam"),
    dict(mode="dp_adam", grad_k=None, weight_k=None),
    dict(mode="efadam"),
    dict(mode="efadam", weight_absolute=False, weight_k=3),
    dict(mode="ef_sgd", **EF_SGD)],
    ids=["dp_adam", "dp_adam-f32", "efadam", "efadam-amax3", "ef_sgd"])
def test_baseline_one_worker_against_reference(models, group, kw):
    jm, tm = models
    kw = dict(BASE, **kw)
    init, want_l, want_m = _reference(jm, kw, 5)
    art, sess = _port_run(tm, group, init, kw, 5)
    assert sess.step == 5
    losses = [h["loss"] for h in sess.history]
    master = {p: t.numpy() for p, t in _paths(sess.state["master"])}
    assert _gate(want_l, dict(_paths(want_m)), losses, master) == \
        (True, True)
    if kw["mode"] == "ef_sgd":     # the residual carries, as the reference
        assert any(bool(t.any()) for _, t in _paths(sess.state["e"]))


@pytest.mark.parametrize("mode,kw,ref_kw", [
    ("dp_adam", dict(grad_k=None, weight_k=None),
     dict(grad_k=None, weight_k=None)),
    ("efadam", dict(weight_k=None), dict(weight_k=None))],
    ids=["dp_adam=qadam-f32", "efadam-f32=qadam"])
def test_baseline_equals_qadam_at_one_worker(models, group, mode, kw,
                                             ref_kw):
    _, tm = models
    runs = {}
    for m, k in ((mode, kw), ("qadam", ref_kw)):
        _, sess = _port_run(tm, group, None, dict(BASE, mode=m, **k), 5)
        runs[m] = ([h["loss"] for h in sess.history],
                   dict(_paths(sess.state["master"])))
    assert runs[mode][0] == runs["qadam"][0]
    for p, x in runs["qadam"][1].items():
        assert torch.equal(runs[mode][1][p], x), p


# ---------------------------------------------------------------------------
# TernGrad: the reference's draws replayed, and the port's own
# ---------------------------------------------------------------------------

def _reference_draws(seed, t, leaf, worker, n, device):
    """The reference's uniforms for (step, leaf, worker): its key folds
    (``repro/dist/step.py``) and ``jax.random.uniform`` over the flat
    leaf (``Codec._draw``)."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), t)
    key = jax.random.fold_in(jax.random.fold_in(key, leaf), worker)
    return torch.from_numpy(np.array(jax.random.uniform(key, (n,)))).to(
        device)


def test_terngrad_replays_the_reference(models, group, monkeypatch):
    """With ``draw_uniform`` replaying the reference's draws, TernGrad at
    one worker follows the reference's trajectory at the tiers above."""
    from repro_torch.dist import step as TS
    jm, tm = models
    kw = dict(BASE, mode="terngrad", **TERNGRAD)
    init, want_l, want_m = _reference(jm, kw, 5)
    monkeypatch.setattr(TS, "draw_uniform", _reference_draws)
    _, sess = _port_run(tm, group, init, kw, 5)
    losses = [h["loss"] for h in sess.history]
    master = {p: t.numpy() for p, t in _paths(sess.state["master"])}
    assert _gate(want_l, dict(_paths(want_m)), losses, master) == \
        (True, True)


def test_terngrad_own_draws(models, group):
    """The port's own draws: one pure function of (seed, step, leaf,
    worker), so a rerun draws the same and each argument changes them;
    five steps train (finite, falling) and rerun bitwise."""
    from repro_torch.dist.step import draw_uniform
    a = draw_uniform(0, 3, 5, 1, 4099, "cpu")
    assert a.dtype == torch.float32 and a.shape == (4099,)
    assert torch.equal(a, draw_uniform(0, 3, 5, 1, 4099, "cpu"))
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
    for args in ((1, 3, 5, 1), (0, 4, 5, 1), (0, 3, 6, 1), (0, 3, 5, 0)):
        assert not torch.equal(a, draw_uniform(*args, 4099, "cpu"))
    _, tm = models
    kw = dict(BASE, mode="terngrad", **TERNGRAD)
    runs = []
    for _ in range(2):
        _, sess = _port_run(tm, group, None, kw, 5)
        runs.append([h["loss"] for h in sess.history])
    losses = runs[0]
    print(f"terngrad losses {losses}")
    assert all(np.isfinite(losses)) and np.mean(losses[-3:]) < losses[0]
    assert runs[0] == runs[1]


def test_terngrad_wire_is_unbiased():
    """E[K6(#5(x))] = x: the mean of R decoded draws (the plain
    versions, uniforms from ``draw_uniform``) lies within 5 standard
    errors of x at every element, the per-draw variance being
    s^2 p (1 - p), p = |x| / s."""
    from repro_torch.comm import codec as TCD
    from repro_torch.dist.step import draw_uniform
    n, R = 1000, 4000
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(n)
                         .astype(np.float32))
    codec = TCD.TernaryCodec()
    u = torch.cat([draw_uniform(0, t, 0, 0, n, "cpu") for t in range(R)])
    payload, scale = TCD.encode_rows(x.repeat(R), codec, R, u=u)
    vals = TCD.decode_rows(payload, scale.repeat(R), codec, n)
    mean = vals.double().mean(0)
    s = float(scale)
    assert s == float(x.abs().max())
    p = x.double().abs() / s
    se = s * (p * (1 - p) / R).sqrt()
    z = ((mean - x.double()).abs() / se.clamp_min(1e-12))
    print(f"largest |mean - x| in standard errors: {float(z.max()):.2f}")
    assert bool((z <= 5.0).all())
    # a biased wire (codes rounded to nearest instead of drawn) fails
    biased = torch.sign(x) * (p >= 0.5).float() * s
    assert not bool(((biased - x).abs() <= 5 * se.float()).all())
