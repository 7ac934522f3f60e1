"""``qadam`` with the baselines' gradient quantizers (TernGrad, with the
reference's draws replayed; blockwise sign) against the JAX package, on
the CPU, at the tiers of ``test_torch_baselines.py``: five steps of
``TrainSession.from_optimizer`` on the yi-6b smoke config against the
reference's session, and three steps of one worker on the paper's
classification MLP. The measured drifts are printed (``pytest -s``)."""
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
from test_torch_baselines import (LOSS_RTOL, PARAM_REL_L2, _by_path, _gate,
                                  _load, _port_session, _reference_session,
                                  rel_l2, replay_draws)
from test_torch_baselines import models  # noqa: F401 (fixture)

OPTS = {
    "qadam_terngrad": lambda M: M.qadam(M.QAdamConfig(
        alpha=1e-3, grad_q="terngrad"), seed=1),
    "qadam_blockwise": lambda M: M.qadam(M.QAdamConfig(
        alpha=1e-3, grad_q="blockwise:256", weight_q="uniform_amax:7",
        weight_q_min_numel=2 ** 14)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def references(models):  # noqa: F811
    jm, _, jp = models
    return {name: _reference_session(jm, jp, make)
            for name, make in OPTS.items()}


@pytest.mark.parametrize("name", list(OPTS))
def test_session_against_reference(models, references, name,  # noqa: F811
                                   monkeypatch):
    _, tm, jp = models
    monkeypatch.setattr(uniforms, "draw_uniform",
                        replay_draws(len(jax.tree.leaves(jp)), False))
    port = _port_session(tm, jp, OPTS[name](TQA))
    assert all(np.isfinite(port[0])) and port[0][-3:].mean() < port[0][0]
    assert _gate(references[name], port, name) == (True, True)


@pytest.mark.parametrize("name", list(OPTS))
def test_mlp_one_worker_against_reference(name, monkeypatch):
    jex, tex = _load("paper_repro"), _load("paper_repro_torch")
    jdata = JD.classification_dataset(JD.ClsDataConfig(seed=1))
    tdata = TD.classification_dataset(TD.ClsDataConfig(seed=1), "cpu")
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
