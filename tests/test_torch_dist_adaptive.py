"""The port's ``adaptive`` mode (Algorithms 2+3 with a per-leaf wire plan)
against the JAX package's, on the yi-6b smoke config, from the
reference's initial state; its launcher, its resume and its checkpoints.

Tiers:
  * bitwise: each lane's payload rows and decoded values from the same
    Delta+e and scale (log:2, log:6, log:30, log:126, uniform_amax:14 on
    16-bit lanes; blockwise:256's sign-code rows and block scales), and
    the byte accounting of a plan covering every lane;
  * trajectories (one worker in process against the reference's
    ``(1, 1)`` mesh, five steps; two gloo ranks in
    ``test_torch_dist_adaptive_workers.py``): losses
    within rel 2.3e-4 and the master within rel L2 4e-6, the reference's
    own drift (ROADMAP queue 3). XLA contracts the residual
    Delta+e - level * scale into one fma where the level is not a power
    of two (the deep grids, the 14-bit uniform lane), the port rounds
    twice; both forms are held bitwise below. The stats rows (gstats):
    amax within 4 ulps, the powers within rtol 1e-5, after a step from
    the same state;
  * the launcher in a subprocess (``--adaptive --adapt-verify``); a
    resumed adaptive run bitwise an unbroken one (state, losses, plans);
    the plan and EMA crossing to and from the reference's store.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comm as JC
from repro.checkpoint import store as jstore
from repro.configs import get_config as jget
from repro.dist.step import TrainConfig as JTC
from repro.dist.step import make_train_step as j_make_train_step
from repro.models.model import Model as JModel
from repro.opt import engine as JE
from repro_torch.adapt import stats as TS
from repro_torch.comm import bits as TB
from repro_torch.comm import codec as TCD
from repro_torch.configs import get_config as tget
from repro_torch.convert import dist_state_from_numpy
from repro_torch.data.pipeline import batch_for_model as tbatches
from repro_torch.dist.step import TrainConfig as TTC
from repro_torch.dist.step import make_train_step as t_make_train_step
from repro_torch.launch import mesh as TM
from repro_torch.models.model import Model as TModel
from repro_torch.opt import engine as TE
from repro_torch.opt import grids as TG
from repro_torch.train.loop import comm_bytes_per_step
from repro_torch.train.session import SessionConfig, TrainSession

import test_torch_dist_workers as W
from test_torch_dist import SEQ, _gate, _paths

KW = W.RUNS["adaptive"][0]
PLAN = KW["bit_plan"]
LANES = ("log:2", "log:6", "log:30", "log:126", "uniform_amax:14:w16")
HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def group():
    g = TM.make_process_group("cpu", store=torch.distributed.HashStore())
    yield g
    TM.close_process_group()


@pytest.fixture(scope="module")
def models():
    return JModel(jget("yi-6b", smoke=True)), TModel(tget("yi-6b",
                                                          smoke=True))


# ---------------------------------------------------------------------------
# the lanes, bitwise
# ---------------------------------------------------------------------------

def _de(n, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    x[::17] = 0.0
    x[5::23] *= np.float32(1e-5)
    return x


@pytest.mark.parametrize("spec", LANES)
@pytest.mark.parametrize("n_rows", [1, 2, 4])
def test_lane_payloads_bitwise(spec, n_rows):
    """Each scalar-scale lane: the payload rows of the reference's
    ``encode_rows_ef`` and the port's K7 (plain version) from the same
    Delta+e and amax scale, the decoded rows, and the residual in each
    program's own rounding."""
    x = _de(4099, n_rows)
    jc, tc = JC.get_codec(spec), TCD.get_codec(spec)
    js = jc.compute_scale(jnp.asarray(x))
    ts = tc.compute_scale(torch.from_numpy(x))
    assert float(js) == float(ts)
    jp, je = JC.encode_rows_ef(jnp.asarray(x), js, jc, n_rows)
    tp, te = TCD.encode_rows_ef(torch.from_numpy(x), ts, tc, n_rows)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    c = -(-x.size // n_rows)
    scales = np.linspace(0.5, 1.5, n_rows).astype(np.float32) * float(js)
    jd = JC.decode_rows(jp, jnp.asarray(scales), jc, c)
    td = TCD.decode_rows(tp, torch.from_numpy(scales), tc, c)
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    codes = TB.unpack_rows(tp, tc.bits, c).reshape(-1)[:x.size].numpy()
    if tc.kind == "log":        # the levels: the lane table, c / 2^k
        lv = TG.log_dequant_table(tc.k, tc.bits)[
            codes.astype(np.int64) + (1 << (tc.bits - 1))]
    else:
        lv = codes.astype(np.float32) / np.float32(2 ** tc.k)
    s = np.float32(float(ts))
    np.testing.assert_array_equal(te.numpy().view(np.uint32),
                                  (x - lv * s).view(np.uint32))
    fma = (x.astype(np.float64) - lv.astype(np.float64) * np.float64(s))
    np.testing.assert_array_equal(np.asarray(je).view(np.uint32),
                                  fma.astype(np.float32).view(np.uint32))


@pytest.mark.parametrize("n_rows", [1, 2, 4])
def test_blockwise_lane_bitwise(n_rows):
    """blockwise:256: the sign codes' packed worker rows and the block
    scales of the reference's ``quantize_blockwise`` (jnp) and the
    port's #14 / #9 plain versions, within the scales' summation-order
    ulps (ROADMAP queue 3: 3 ulps at blocks of 256)."""
    x = _de(5000, 7 + n_rows)
    jcodes, jsc = JE.quantize_blockwise(jnp.asarray(x), 256, backend="jnp")
    tcodes, tsc = TE.quantize_blockwise(torch.from_numpy(x), 256)
    np.testing.assert_array_equal(np.asarray(jcodes), tcodes.numpy())
    jsc, tsc = np.asarray(jsc), tsc.numpy()
    assert (np.abs(jsc - tsc) <= 3 * np.spacing(np.abs(jsc))).all()
    jrows = JC.pack_rows(JC.pad_rows(jnp.asarray(jcodes).reshape(-1)[
        :x.size], n_rows), 2)
    trows = TB.pack_rows(TB.pad_rows(tcodes.reshape(-1)[:x.size], n_rows),
                         2)
    np.testing.assert_array_equal(np.asarray(jrows), trows.numpy())


def test_plan_accounting_is_the_references(models, group):
    jm, tm = models
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jart = j_make_train_step(jm, mesh, JTC(**KW, worker_axes=("data",)))
    from repro.train.loop import comm_bytes_per_step as j_comm
    tart = t_make_train_step(tm, group, TTC(**KW))
    want = j_comm(jart, JTC(**KW, worker_axes=("data",)))
    got = comm_bytes_per_step(tart, TTC(**KW))
    for k in ("update_exchange_bytes", "weight_broadcast_bytes",
              "total_bytes", "tiers"):
        assert got[k] == want[k], k
    from repro_torch.adapt.controller import verify_accounting
    assert verify_accounting(tart, TTC(**KW))["measured"] == \
        want["update_exchange_bytes"]
    with pytest.raises(ValueError, match="bit_plan has 3 specs"):
        t_make_train_step(tm, group, TTC(**dict(KW, bit_plan=PLAN[:3])))


# ---------------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------------

def test_one_worker_against_reference(models, group):
    """Five steps of the plan covering every lane, against the
    reference's adaptive mode on the (1, 1) mesh; the stats rows after
    the first step."""
    jm, tm = models
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jart = j_make_train_step(jm, mesh, JTC(**KW, worker_axes=("data",)))
    state = jart.init_state(jax.random.PRNGKey(0))
    init = jax.tree.map(np.asarray, state)
    step = jax.jit(jart.step_fn)
    from repro.data.pipeline import batch_for_model as jbatches
    jb = jbatches(jm.cfg, SEQ, 4)
    want_l, want_g = [], []
    for _ in range(5):
        state, m = step(state, next(jb))
        want_l.append(float(m["loss"]))
        want_g.append(np.asarray(m["gstats"]))
    want_m = dict(_paths(jax.tree.map(np.asarray, state["master"])))
    art = t_make_train_step(tm, group, TTC(**KW))
    sess = TrainSession.from_artifacts(
        art, tbatches(tm.cfg, SEQ, 4), SessionConfig(log_every=1,
                                                     stats_ring=5),
        state=dist_state_from_numpy(init, 0, 1, "cpu"), device="cpu",
        log=lambda *_: None)
    with sess:
        sess.run(5)
        rows = sess.harvest_stats()
    assert [s for s, _ in rows] == [1, 2, 3, 4, 5]
    assert rows[0][1].shape == (12, 3)
    got_g = dict(rows)[1]
    assert (np.abs(got_g[:, 0] - want_g[0][:, 0])
            <= 4 * np.spacing(want_g[0][:, 0])).all()
    np.testing.assert_allclose(got_g[:, 1:], want_g[0][:, 1:], rtol=1e-5)
    losses = [h["loss"] for h in sess.history]
    master = {p: t.numpy() for p, t in _paths(sess.state["master"])}
    assert _gate(want_l, want_m, losses, master) == (True, True)


# ---------------------------------------------------------------------------
# the launcher, resume, checkpoints
# ---------------------------------------------------------------------------

def _launch(*argv, cwd):
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "yi-6b",
         "--smoke", "--device", "cpu", "--seq", "32", "--global-batch", "4",
         *argv], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def test_launcher_adaptive_verify_and_resume(tmp_path):
    """``--adaptive --adapt-verify`` for 4 steps with checkpoints, then
    ``--resume`` to 6: each plan's accounting exact, one host sync a
    window, and the resumed run starting from the checkpoint's plan."""
    ck, hist = tmp_path / "ck", tmp_path / "h.json"
    common = ("--adaptive", "--replan-every", "2", "--adapt-verify",
              "--log-every", "0", "--ckpt-dir", str(ck), "--ckpt-every",
              "2")
    out = _launch(*common, "--steps", "4", "--history-out", str(hist),
                  cwd=tmp_path)
    assert "adapt-verify OK" in out and "2 syncs / 2 windows" in out
    h = json.loads(hist.read_text())
    assert len(h["plan_log"]) >= 2 and h["plan_log"][0]["bit_plan"] is None
    assert h["plan_log"][-1]["comm"]["update_exchange_bytes"] < \
        h["plan_log"][0]["comm"]["update_exchange_bytes"]
    assert "plan @2" in out and "final loss" in out
    plan = h["plan_log"][-1]["bit_plan"]
    assert jstore.read_extra(str(ck))["bit_plan"] == plan
    out = _launch(*common, "--steps", "6", "--resume", cwd=tmp_path)
    assert "resumed from step 4" in out and "plan restored" in out
    assert "1 syncs / 1 windows" in out
    assert "initial log grid" not in out.split("resumed from")[1].split(
        "\n")[0]


def _controller(tm, group, d=None, every=2, **kw):
    from repro_torch.adapt.controller import AdaptConfig, AdaptiveController
    return AdaptiveController(
        tm, group, TTC(**BASE_TC), tbatches(tm.cfg, SEQ, 4),
        AdaptConfig(replan_every=2), SessionConfig(
            log_every=0, ckpt_dir=d, ckpt_every=every if d else 0,
            ckpt_async=False, **kw), device="cpu", log=lambda *_: None)


BASE_TC = {k: v for k, v in KW.items() if k not in ("bit_plan", "mode")}


def _tensors(state):
    from repro_torch.tree import tree_flatten_with_path
    return {k: v.clone() for k, v in tree_flatten_with_path(state)
            if isinstance(v, torch.Tensor)}


@pytest.mark.parametrize("stop,ckpt_every", [(4, 2), (3, 3)])
def test_resume_is_an_unbroken_run(models, group, tmp_path, stop,
                                   ckpt_every):
    """Stopped at a replan boundary (4) or inside a window (3): the
    resumed controller restores the plan and the EMA, and its state,
    losses and plans equal an unbroken run's bitwise."""
    _, tm = models
    full = _controller(tm, group)
    with full:
        full.run(6)
        want_l = full.session.harvest_losses()
    d = str(tmp_path / "ck")
    first = _controller(tm, group, d, every=ckpt_every)
    with first:
        first.run(stop)
        plan_at_stop = first.tc.bit_plan
    again = _controller(tm, group, d, every=ckpt_every)
    with again:
        assert again.resume() == stop
        # the checkpoint's plan is restored first; at a window's end the
        # resume then replans from the restored EMA, as the unbroken run
        # did there
        assert again.plan_log[1]["bit_plan"] == plan_at_stop
        assert again.plan_log[1]["step"] == stop
        again.run(6 - stop)
        got_l = again.session.harvest_losses()
    assert got_l == [(s, v) for s, v in want_l if s > stop]
    assert again.tc.bit_plan == full.tc.bit_plan
    np.testing.assert_array_equal(again.ema.snapshot(), full.ema.snapshot())
    want, got = _tensors(full.state), _tensors(again.state)
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(want[k], got[k]), k
    assert [e["step"] for e in again.plan_log][-1] >= stop


def test_checkpoint_extra_crosses_both_ways(models, group, tmp_path):
    """The port's checkpoint: the reference's store reads its plan and
    EMA, and the reference's controller resumes from it on that plan.
    The reference's checkpoint: the port's controller restores its plan
    and EMA."""
    jm, tm = models
    d = str(tmp_path / "port")
    ctl = _controller(tm, group, d)
    with ctl:
        ctl.run(4)
    extra = jstore.read_extra(d)
    assert extra["bit_plan"] == list(ctl.tc.bit_plan)
    from repro.adapt import stats as JS
    np.testing.assert_array_equal(
        JS.StatsEMA.from_state(extra["adapt_ema"]).snapshot(),
        ctl.ema.snapshot())
    from repro.adapt.controller import AdaptConfig as JAC
    from repro.adapt.controller import AdaptiveController as JCtl
    from repro.train.session import SessionConfig as JSC
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    from repro.data.pipeline import batch_for_model as jbatches
    jctl = JCtl(jm, mesh, JTC(**BASE_TC, worker_axes=("data",)),
                jbatches(jm.cfg, SEQ, 4), JAC(replan_every=2),
                JSC(log_every=0, ckpt_dir=d), key=jax.random.PRNGKey(0),
                log=lambda *_: None)
    try:
        assert jctl.resume(d) == 4
        assert jctl.plan_log[1]["bit_plan"] == ctl.tc.bit_plan
        got = dict(_paths(jax.tree.map(np.asarray, jctl.state["master"])))
        for p, t in _paths(ctl.state["master"]):
            np.testing.assert_array_equal(got[p].reshape(-1), t.numpy())
    finally:
        jctl.close()
    # the other way: the reference's store, the port's controller
    d2 = str(tmp_path / "ref")
    ema = JS.StatsEMA(12, 0.8)
    rng = np.random.default_rng(4)
    for _ in range(3):
        ema.update(np.abs(rng.standard_normal((12, 3))) * 1e-4)
    jart = j_make_train_step(jm, mesh, JTC(**KW, worker_axes=("data",)))
    jstate = jax.tree.map(np.asarray, jart.init_state(
        jax.random.PRNGKey(0)))
    jstate["count"] = np.int32(2)
    jstore.save(d2, jstate, step=2, extra={
        "batches_consumed": 2, "bit_plan": list(PLAN),
        "adapt_ema": ema.state_dict()})
    port = _controller(tm, group, d2)
    with port:
        assert port.resume() == 2
        assert port.plan_log[1]["step"] == 2
        assert port.plan_log[1]["bit_plan"] == PLAN
        np.testing.assert_array_equal(port.ema.snapshot(), ema.snapshot())
        assert port.state["count"] == 2
        assert isinstance(TS.StatsEMA.from_state(
            port.session.ckpt_extra["adapt_ema"]), TS.StatsEMA)
