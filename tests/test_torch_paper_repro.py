"""The port's paper protocol (``examples/paper_repro_torch.py``) against
the reference's (``examples/paper_repro.py``), on the CPU: a few steps of
every method of the default comparison and of ``--mode efadam``, from
the reference's MLP parameters carried across as numpy, the same data
and batches, the workers' TernGrad uniforms replayed from the reference's
keys (each worker's key folded from the optimizer's, split once a step).

Trajectory tier (the distributed baselines', the reference's own drift,
ROADMAP queue 3): final parameters within rel L2 4e-6 and the test loss
within rtol 2.3e-4. WQuan's post-training quantization is bitwise on
identical parameters. The measured drifts are printed (``pytest -s``).
"""
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.core import qadam as JQA
from repro.data import pipeline as JD
from repro_torch.convert import params_from_numpy
from repro_torch.core import qadam as TQA
from repro_torch.core import uniforms
from repro_torch.data import pipeline as TD

LOSS_RTOL = 2.3e-4
PARAM_REL_L2 = 4e-6
STEPS, WORKERS = 3, 4
HERE = os.path.dirname(os.path.abspath(__file__))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "..", "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jex, tex = _load("paper_repro"), _load("paper_repro_torch")
    jdata = JD.classification_dataset(JD.ClsDataConfig(seed=1))
    tdata = TD.classification_dataset(TD.ClsDataConfig(seed=1), "cpu")
    return jex, tex, jdata, tdata


def _replay(n_leaves):
    """The reference protocol's uniforms for (seed, step, leaf, worker)."""
    subkeys = {}

    def draw(seed, t, leaf, worker, n, device):
        if (seed, t, worker) not in subkeys:
            key = jax.random.fold_in(jax.random.PRNGKey(seed), worker)
            for _ in range(t):
                key, sub = jax.random.split(key)
            subkeys[seed, t, worker] = jax.random.split(sub, n_leaves)
        u = jax.random.uniform(subkeys[seed, t, worker][leaf], (n,))
        return torch.from_numpy(np.array(u)).to(device)
    return draw


def _case_ids():
    tex = _load("paper_repro_torch")
    return ([("qadam", n) for n in tex.methods("qadam")]
            + [("efadam", n) for n in tex.methods("efadam")])


@pytest.mark.parametrize("mode,name", _case_ids(), ids=lambda v: str(v))
def test_method_against_reference(setup, mode, name, monkeypatch):
    jex, tex, jdata, tdata = setup
    kind, kw, wq_after, srv_q, srv_ef = tex.methods(mode)[name]
    jopt = (JQA.qadam(JQA.QAdamConfig(**kw)) if kind == "qadam"
            else getattr(JQA, kind)(**kw))
    seed = 1
    key = jax.random.PRNGKey(seed)
    jp0 = jex.mlp_init(key, 32, tex.HIDDEN, 50)
    monkeypatch.setattr(uniforms, "draw_uniform", _replay(len(jp0)))
    jp = jex.run(jopt, STEPS, jdata, key, seed=seed * 100,
                 n_workers=WORKERS, server_q=srv_q, server_ef=srv_ef)
    tp = tex.run(tex.build(kind, kw), STEPS, tdata,
                 params_from_numpy(jax.tree.map(np.asarray, jp0), "cpu"),
                 seed=seed * 100, n_workers=WORKERS, server_q=srv_q,
                 server_ef=srv_ef)
    want_p = {k: np.asarray(v) for k, v in jp.items()}
    num = sum(float(((want_p[k] - tp[k].numpy()) ** 2).sum()) for k in tp)
    den = sum(float((want_p[k] ** 2).sum()) for k in tp)
    param_rel = (num / den) ** 0.5
    want_l = float(jex.loss_fn(jp, jdata[2], jdata[3]))
    got_l = float(tex.loss_fn(tp, tdata[2], tdata[3]))
    print(f"{mode} {name} ({kind}): test loss {got_l:.6f} (rel drift "
          f"{abs(got_l - want_l) / want_l:.2e}), params rel L2 "
          f"{param_rel:.2e}")
    assert abs(got_l - want_l) <= LOSS_RTOL * abs(want_l)
    assert param_rel <= PARAM_REL_L2
    if wq_after is not None:
        # WQuan after training, on identical (the reference's) parameters
        same = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        want = JQA.wquan(jp, k_x=wq_after, absolute=False)
        got = TQA.wquan(same, k_x=wq_after, absolute=False)
        for k in got:
            np.testing.assert_array_equal(np.asarray(want[k]),
                                          got[k].numpy())
        assert tex.accuracy(got, tdata[2], tdata[3]) == \
            jex.accuracy(want, jdata[2], jdata[3])


def test_adaptive_raises_naming_the_roadmap(monkeypatch, tmp_path, capsys):
    """``--adaptive`` on the command line: both arms run on the CPU and
    the --out table holds them, the adaptive arm's plan log first on the
    fixed log:6 lanes."""
    tex = _load("paper_repro_torch")
    out = tmp_path / "adaptive.json"
    monkeypatch.setattr("sys.argv", [
        "paper_repro_torch.py", "--adaptive", "--device", "cpu", "--steps",
        "4", "--seeds", "1", "--workers", "2", "--replan-every", "2",
        "--out", str(out)])
    tex.main()
    got = json.loads(out.read_text())
    assert set(got["results"]) == {"fixed k_g=6 (log:6)", "adaptive"}
    log = got["results"]["adaptive"]["plan_log"]
    assert log[0]["plan"] == ["log:6"] * 6 and log[0]["step"] == 0
    assert got["summary"]["bytes_ratio"] <= 1.0
    assert "adaptive/fixed bytes" in capsys.readouterr().out


ADAPT_STEPS, ADAPT_EVERY = 4, 2


def test_adaptive_arm_against_reference(setup):
    """``run_quantized`` (both arms) from the reference's parameters: the
    plan log (steps, per-leaf specs, measured bytes a step) and the
    bytes are identical to the reference's; the final test loss and the
    loss curve within the trajectory tier."""
    jex, tex, jdata, tdata = setup
    key = jax.random.PRNGKey(2)
    jp0 = jex.mlp_init(key, 32, tex.HIDDEN, 50)
    for adaptive in (False, True):
        jp, ji = jex.run_quantized(ADAPT_STEPS, jdata, key, seed=200,
                                   n_workers=WORKERS, adaptive=adaptive,
                                   replan_every=ADAPT_EVERY)
        tp, ti = tex.run_quantized(
            ADAPT_STEPS, tdata,
            params_from_numpy(jax.tree.map(np.asarray, jp0), "cpu"),
            seed=200, n_workers=WORKERS, adaptive=adaptive,
            replan_every=ADAPT_EVERY)
        assert ti["plan_log"] == ji["plan_log"]
        assert ti["total_bytes"] == ji["total_bytes"]
        assert [b for b, _ in ti["curve"]] == [b for b, _ in ji["curve"]]
        if adaptive:
            assert len(ji["plan_log"]) >= 2     # the plan did move
        want = ji["final_test_loss"]
        print(f"adaptive={adaptive}: test loss {ti['final_test_loss']:.6f} "
              f"(rel drift {abs(ti['final_test_loss'] - want) / want:.2e}),"
              f" plans {[e['step'] for e in ti['plan_log']]}")
        assert abs(ti["final_test_loss"] - want) <= LOSS_RTOL * abs(want)
        for (_, a), (_, b) in zip(ti["curve"], ji["curve"]):
            assert abs(a - b) <= LOSS_RTOL * abs(b)


def test_cli_on_the_cpu(monkeypatch, tmp_path, capsys):
    """The command line with --device cpu: every method prints its
    accuracy and the --out table holds them."""
    tex = _load("paper_repro_torch")
    out = tmp_path / "acc.json"
    monkeypatch.setattr("sys.argv", [
        "paper_repro_torch.py", "--device", "cpu", "--steps", "2",
        "--seeds", "1", "--workers", "2", "--mode", "efadam",
        "--out", str(out)])
    tex.main()
    rows = json.loads(out.read_text())
    assert [r["method"] for r in rows] == list(tex.methods("efadam"))
    assert all(0.0 <= r["acc"] <= 1.0 for r in rows)
    assert "EFADAM 2way log:2" in capsys.readouterr().out
