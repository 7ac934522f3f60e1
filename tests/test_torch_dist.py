"""The port's distributed step (Algorithms 2+3 on ``torch.distributed``)
against the JAX package's ``repro.dist.step.make_train_step``, on the
yi-6b smoke config, started from the reference's own initial state
(``convert.dist_state_from_numpy``).

Tiers:
  * ``worker_mean``: bitwise (its pairwise tree is what makes identical
    workers bit-exact);
  * one worker, in process (gloo, one rank over a ``HashStore``, against
    the reference's ``(1, 1)`` mesh): five steps, losses within rel
    2.3e-4 and the master within rel L2 4e-6, the reference's own ulp
    drift between its equivalent programs (ROADMAP queue 3), over the
    quantized wire, the amax weight grid and both float32 branches;
  * two and four workers: ``tests/test_torch_dist_workers.py``;
  * the port's step at one worker is bitwise the port's Algorithm 1;
  * planted faults fail the gate: error feedback off, k_g off by one;
  * ``comm_bytes_per_step`` equals the bytes the collectives move, for
    every mode (the baselines' trajectories:
    ``tests/test_torch_dist_modes.py``).

The measured drifts are what these tests print (``pytest -s``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data.pipeline import batch_for_model as jbatches
from repro.dist.modes import worker_mean as j_worker_mean
from repro.dist.step import TrainConfig as JTC
from repro.dist.step import make_train_step as j_make_train_step
from repro.models.model import Model as JModel
from repro_torch.configs import get_config as tget
from repro_torch.convert import dist_state_from_numpy
from repro_torch.data.pipeline import batch_for_model as tbatches
from repro_torch.dist import collectives as TC
from repro_torch.dist.modes import worker_mean as t_worker_mean
from repro_torch.dist.step import TrainConfig as TTC
from repro_torch.dist.step import local_batch
from repro_torch.dist.step import make_train_step as t_make_train_step
from repro_torch.launch import mesh as TM
from repro_torch.models.model import Model as TModel
from repro_torch.train.loop import comm_bytes_per_step
from repro_torch.train.session import SessionConfig, TrainSession

LOSS_RTOL = 2.3e-4
MASTER_REL_L2 = 4e-6
SEQ = 32
# the slice's configuration (the launcher's defaults, the chip run's
# cell): at the reference test's alpha=1e-2, beta=theta=0.9 a level flip
# that XLA's fma in the reference's moments causes cascades past the
# gate within 5 steps (master rel L2 7e-5, losses 3e-6);
# test_one_worker_equals_algorithm1 holds the port's step exactly there
BASE = dict(alpha=1e-3, beta=0.99, theta=0.999, grad_k=6, weight_k=7,
            weight_absolute=True)
# the SGD baselines at the reference's own settings
# (tests/dist_scripts/opt_modes.py): the float32 broadcast
EF_SGD = dict(alpha=1e-2, beta=0.9, grad_k=None, weight_k=None)
TERNGRAD = dict(alpha=2e-2, grad_k=None, weight_k=None)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _paths(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{path}/{k}")
    else:
        yield path, tree


def _master_rel_l2(want, got):
    """Relative L2 distance of two masters, dicts of arrays by path."""
    assert want.keys() == got.keys()
    num = sum(float(((np.asarray(want[p]).reshape(-1) - got[p].reshape(-1))
                     ** 2).sum()) for p in want)
    den = sum(float((np.asarray(want[p]) ** 2).sum()) for p in want)
    return (num / den) ** 0.5


def _gate(want_losses, want_master, losses, master):
    """(losses within LOSS_RTOL, master within MASTER_REL_L2), printing
    the drifts."""
    want_losses, losses = np.asarray(want_losses), np.asarray(losses)
    assert want_losses.shape == losses.shape
    loss_rel = float((np.abs(losses - want_losses)
                      / np.abs(want_losses)).max())
    rel = _master_rel_l2(want_master, master)
    print(f"largest loss rel drift {loss_rel:.2e}, master rel L2 {rel:.2e}")
    return loss_rel <= LOSS_RTOL, rel <= MASTER_REL_L2


# ---------------------------------------------------------------------------
# worker_mean
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_rows", [1, 2, 4, 8])
@pytest.mark.parametrize("identical", [False, True])
def test_worker_mean_bitwise(n_rows, identical):
    rng = np.random.default_rng(n_rows)
    rows = rng.standard_normal((n_rows, 1001)).astype(np.float32)
    if identical:
        rows[:] = rows[0]
    want = np.asarray(jax.jit(j_worker_mean)(jnp.asarray(rows)))
    got = t_worker_mean(torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(want.view(np.int32), got.view(np.int32))
    if identical:
        np.testing.assert_array_equal(got, rows[0])


def test_worker_mean_three_rows():
    """At a width that is not a power of two the port divides by 3 (one
    rounding, emulated in numpy float32); XLA on the CPU multiplies by a
    rounded 1/3 instead, so the reference is within one ulp of it."""
    rows = np.random.default_rng(3).standard_normal((3, 1001)).astype(
        np.float32)
    got = t_worker_mean(torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(got, (rows[0] + (rows[1] + rows[2]))
                                  / np.float32(3))
    want = np.asarray(jax.jit(j_worker_mean)(jnp.asarray(rows)))
    assert (np.abs(want - got) <= np.spacing(np.abs(got))).all()


# ---------------------------------------------------------------------------
# one worker, in process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def group():
    g = TM.make_process_group("cpu", store=torch.distributed.HashStore())
    yield g
    TM.close_process_group()


@pytest.fixture(scope="module")
def models():
    return JModel(jget("yi-6b", smoke=True)), TModel(tget("yi-6b",
                                                          smoke=True))


_REFERENCE = {}


def _reference(jm, kw, steps, n_workers=1, batch=4):
    """The reference's distributed run: (initial state, losses, final
    master), numpy, cached per configuration."""
    key = (jm.cfg, tuple(sorted(kw.items())), steps, n_workers, batch)
    if key not in _REFERENCE:
        mesh = jax.make_mesh((n_workers, 1), ("data", "model"))
        art = j_make_train_step(jm, mesh, JTC(**kw, worker_axes=("data",)))
        state = art.init_state(jax.random.PRNGKey(0))
        init = _np(state)
        step = jax.jit(art.step_fn)
        batches = jbatches(jm.cfg, SEQ, batch)
        losses = []
        for _ in range(steps):
            state, metrics = step(state, next(batches))
            losses.append(float(metrics["loss"]))
        _REFERENCE[key] = (init, losses, _np(state["master"]))
    return _REFERENCE[key]


def _port_run(tm, group, init, kw, steps, batch=4):
    """The port's session from the reference's initial state ``init``, or
    from ``model.init(seed=0)`` when it is None."""
    tc = TTC(**kw)
    art = t_make_train_step(tm, group, tc)
    state = None if init is None else dist_state_from_numpy(
        init, art.rank, art.n_workers, "cpu")
    sess = TrainSession.from_artifacts(art, tbatches(tm.cfg, SEQ, batch),
                                       SessionConfig(log_every=1),
                                       state=state, device="cpu",
                                       log=lambda *_: None)
    with sess:
        sess.run(steps)
    return art, sess


@pytest.mark.parametrize("kw", [
    {},
    dict(weight_absolute=False),
    dict(grad_k=None, weight_k=None),
    dict(grad_k=4, weight_k=3, weight_absolute=False, schedule="sqrt")],
    ids=["log6-uniform7", "amax-weights", "f32-wire", "log4-amax3"])
def test_one_worker_against_reference(models, group, kw):
    jm, tm = models
    kw = dict(BASE, **kw)
    init, want_l, want_m = _reference(jm, kw, 5)
    art, sess = _port_run(tm, group, init, kw, 5)
    assert sess.step == 5 and sess.stats["syncs"] == 5
    losses = [h["loss"] for h in sess.history]
    master = {p: t.numpy() for p, t in _paths(sess.state["master"])}
    assert _gate(want_l, dict(_paths(want_m)), losses, master) == \
        (True, True)


@pytest.mark.parametrize("kw", [
    dict(alpha=1e-2, beta=0.9, theta=0.9, schedule="sqrt"),
    dict(alpha=1e-2, beta=0.9, theta=0.9, schedule="sqrt", grad_k=4)],
    ids=["log6", "log4"])
def test_one_worker_equals_algorithm1(models, group, kw):
    """The reference's own bar, in the port: Algorithms 2+3 at one worker
    (this step, uniform:7 on the weight wire) give bitwise the losses and
    parameters of Algorithm 1 (``qadam`` + ``TrainSession.from_optimizer``
    at ``weight_q="uniform:7"``) from the same initial parameters, here at
    the reference test's learning rate and moments. (The wire clips Q_x
    codes to +/-127 where the residency lane holds +/-128; no parameter
    of the smoke model comes near 0.5.)"""
    from repro_torch.core import qadam as TQA
    _, tm = models
    kw = dict(BASE, **kw)
    art, dist_sess = _port_run(tm, group, None, kw, 6)
    opt = TQA.qadam(TQA.QAdamConfig(
        alpha=kw["alpha"], beta=kw["beta"], theta=kw["theta"],
        schedule=kw["schedule"], grad_q=f"log:{kw['grad_k']}",
        weight_q="uniform:7", weight_q_min_numel=2 ** 14))

    def loss_fn(p, b):
        s, n = tm.loss(p, b)
        return s / n
    params = tm.init(seed=0, device="cpu")
    sess = TrainSession.from_optimizer(opt, loss_fn, params,
                                       tbatches(tm.cfg, SEQ, 4),
                                       SessionConfig(log_every=1),
                                       log=lambda *_: None)
    with sess:
        sess.run(6)
    assert [h["loss"] for h in dist_sess.history] == \
        [h["loss"] for h in sess.history]
    got = dict(_paths(dist_sess.state["master"]))
    for p, x in _paths(sess.state["params"]):
        assert torch.equal(got[p], x.reshape(-1)), p
    for k in ("m", "v", "e"):
        got = dict(_paths(dist_sess.state[k]))
        for p, x in _paths(getattr(sess.state["opt"], k)):
            assert torch.equal(got[p], x.reshape(-1)), (k, p)


@pytest.mark.parametrize("fault", [dict(error_feedback=False),
                                   dict(grad_k=5)], ids=["no-ef", "k_g-5"])
def test_one_worker_gate_fails_on_planted_fault(models, group, fault):
    jm, tm = models
    init, want_l, want_m = _reference(jm, BASE, 5)
    _, sess = _port_run(tm, group, init, dict(BASE, **fault), 5)
    losses = [h["loss"] for h in sess.history]
    master = {p: t.numpy() for p, t in _paths(sess.state["master"])}
    assert _gate(want_l, dict(_paths(want_m)), losses, master) != \
        (True, True)


def test_comm_bytes_match_the_collectives(models, group, monkeypatch):
    """Bytes through the all-to-all (dp_adam: the all-reduce) and the
    weight all-gathers of one step equal ``comm_bytes_per_step``, for the
    paper's mode and the four baselines; scale side channels (per tensor,
    per block) ride ``gather_side``, excluded."""
    _, tm = models
    moved = {"exchange": 0, "broadcast": 0}
    exchange, gather, reduce = TC.exchange_rows, TC.gather_rows, \
        TC.reduce_rows

    def count_exchange(rows, grp):
        moved["exchange"] += rows.nbytes
        return exchange(rows, grp)

    def count_reduce(rows, grp):
        moved["exchange"] += rows.nbytes
        return reduce(rows, grp)

    def count_gather(x, grp):
        out = gather(x, grp)
        moved["broadcast"] += out.nbytes
        return out
    monkeypatch.setattr(TC, "exchange_rows", count_exchange)
    monkeypatch.setattr(TC, "reduce_rows", count_reduce)
    monkeypatch.setattr(TC, "gather_rows", count_gather)
    for kw in ({}, dict(grad_k=None, weight_k=None), dict(mode="dp_adam"),
               dict(mode="efadam"), dict(mode="terngrad", **TERNGRAD),
               dict(mode="ef_sgd", **EF_SGD)):
        tc = TTC(**dict(BASE, **kw))
        art = t_make_train_step(tm, group, tc)
        state = art.init_state(seed=0, device="cpu")
        moved.update(exchange=0, broadcast=0)
        art.step_fn(state, {k: torch.from_numpy(v) for k, v in
                            next(tbatches(tm.cfg, SEQ, 2)).items()})
        comm = comm_bytes_per_step(art, tc)
        assert moved == {"exchange": comm["update_exchange_bytes"],
                         "broadcast": comm["weight_broadcast_bytes"]}


def test_batch_rows_and_state_carried_over(models, group):
    jm, tm = models
    b = {"tokens": torch.arange(12).reshape(6, 2)}
    assert local_batch(b, 0, 1) is b
    assert torch.equal(local_batch(b, 2, 3)["tokens"], b["tokens"][4:6])
    assert local_batch(b, 1, 4) is b           # 6 rows do not split in 4
    for kw, keys in ((BASE, ("master", "m", "v", "e")),
                     (dict(BASE, mode="efadam"),
                      ("master", "m", "v", "e", "es"))):
        init, _, _ = _reference(jm, kw, 5)
        st = dist_state_from_numpy(init, 0, 1, "cpu")
        assert st["count"] == 0 and set(st) == set(keys) | {"count"}
        fresh = t_make_train_step(tm, group, TTC(**kw)).init_state(
            seed=0, device="cpu")
        assert set(fresh) == set(st)
        for k in keys:
            want = dict(_paths(init[k]))
            shapes = dict(_paths(fresh[k]))
            for p, t in _paths(st[k]):
                np.testing.assert_array_equal(want[p].reshape(-1),
                                              t.numpy())
                assert t.shape == shapes[p].shape, (k, p)


def test_swap_between_flat_and_hierarchical_is_bitwise(models, group):
    """One rank: ``HierarchicalTopology(1, 1)`` on a (pod=1, data=1,
    model=1) grid is bitwise the flat step, and a session that swaps it
    in half way (``swap_artifacts``: the same workers, chunks and state
    layout) carries every state tensor as it is and is bitwise the
    unswapped run."""
    from repro_torch.dist import topology as T
    from repro_torch.tree import tree_leaves
    _, tm = models
    flat = t_make_train_step(tm, group, TTC(**BASE))
    hier = t_make_train_step(
        tm, TM.make_grid(pod=1, data=1, model=1, device="cpu"),
        TTC(**BASE, topology=T.HierarchicalTopology(1, 1)))
    assert hier.tiers.hierarchical and not flat.tiers.hierarchical

    def session(art):
        return TrainSession.from_artifacts(
            art, tbatches(tm.cfg, SEQ, 4), SessionConfig(log_every=1),
            device="cpu", log=lambda *_: None)
    runs = {}
    for name, art in (("flat", flat), ("hier", hier)):
        with session(art) as sess:
            sess.run(4)
        runs[name] = sess
    with session(flat) as sess:
        sess.run(2)
        before = {k: [(x.data_ptr(), x.clone()) for x in tree_leaves(v)]
                  for k, v in sess.state.items() if k != "count"}
        sess.swap_artifacts(hier)
        for k, xs in before.items():
            for (ptr, x), y in zip(xs, tree_leaves(sess.state[k])):
                assert ptr == y.data_ptr() and torch.equal(x, y), k
        sess.run(2)
    runs["swapped"] = sess
    want = runs["flat"]
    for name in ("hier", "swapped"):
        got = runs[name]
        assert [h["loss"] for h in got.history] == \
            [h["loss"] for h in want.history], name
        for k in ("master", "m", "v", "e"):
            for x, y in zip(tree_leaves(got.state[k]),
                            tree_leaves(want.state[k])):
                assert torch.equal(x, y), (name, k)


def test_out_of_scope_raises(models, group):
    """What the port still refuses: the reference's four multi-host flags,
    each by name (torchrun's environment stands in their place). The
    rest parses and builds: hierarchical topologies, the model axis, the
    int8 gather, the baselines and the adaptive mode (the trajectories:
    the tests above, ``test_torch_dist_hier_workers.py``,
    ``test_torch_model_axis_workers.py`` and
    ``test_torch_dist_adaptive.py``)."""
    from repro_torch.dist import topology as T
    from repro_torch.launch import train as launch
    _, tm = models
    for kw in (dict(topology=T.HierarchicalTopology(1, 1)),
               dict(topology=T.HierarchicalTopology(1, 1), mode="adaptive"),
               dict(topology=T.HierarchicalTopology(1, 1), mode="ef_sgd"),
               dict(model_gather_quant=8)):
        art = t_make_train_step(tm, group, TTC(**kw))
        assert art.n_workers == 1
        assert art.tiers.hierarchical == ("topology" in kw
                                          and kw.get("mode") != "dp_adam")
    # a plain group is one data axis: 2 nodes do not split it
    with pytest.raises(ValueError, match="needs 4 workers"):
        t_make_train_step(tm, group, TTC(topology=T.HierarchicalTopology(
            2, 2)))
    # the performance flags parse (the sweep and the artifacts run on
    # the card: tests/test_torch_perf.py)
    a = launch.parse_args(["--arch", "yi-6b", "--tune-buckets", "--aot-dir",
                           "x", "--compile-cache", "c", "--no-compile-cache"])
    assert (a.tune_buckets, a.aot_dir, a.compile_cache,
            a.no_compile_cache) == (True, "x", "c", True)
    for flag in (["--multihost"], ["--coordinator", "h:1"],
                 ["--num-processes", "2"], ["--process-id", "0"]):
        with pytest.raises(NotImplementedError,
                           match=f"{flag[0]}: the port runs one process "
                                 "per card under torchrun"):
            launch.parse_args(["--arch", "yi-6b"] + flag)
    for flag, want in ((["--model", "2"], dict(model=2)),
                       (["--topology", "2x2"], dict(pod=2, data=2)),
                       (["--topology", "2x2", "--pod", "2", "--data", "2"],
                        dict(pod=2, data=2)),
                       (["--pod", "2", "--data", "1"], dict(pod=2, data=1)),
                       (["--model-gather-quant", "8"],
                        dict(model_gather_quant=8)),
                       (["--adaptive", "--model", "2"],
                        dict(model=2, adaptive=True))):
        args = launch.parse_args(["--arch", "yi-6b"] + flag)
        for k, v in want.items():
            assert getattr(args, k) == v, (flag, k)
    assert launch.parse_args(["--arch", "yi-6b", "--topology", "2x2"]) \
        .topology_spec == T.HierarchicalTopology(2, 2)
    with pytest.raises(SystemExit):      # 2x2 needs 4 workers, not 3
        launch.parse_args(["--arch", "yi-6b", "--topology", "2x2",
                           "--pod", "3", "--data", "1"])
    for mode in ("dp_adam", "efadam", "terngrad", "ef_sgd", "adaptive"):
        assert launch.parse_args(["--arch", "yi-6b", "--mode",
                                  mode]).mode == mode
        assert t_make_train_step(tm, group, TTC(mode=mode)).n_workers == 1
    assert launch.parse_args(["--arch", "yi-6b", "--adaptive"]).adaptive
