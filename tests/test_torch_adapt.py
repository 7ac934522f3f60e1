"""The port's ``repro_torch.adapt`` (allocator, stats, controller) against
the JAX package's ``repro.adapt`` on the same numpy inputs.

Tiers:
  * bitwise / identical: the allocator's widths, specs, hull chains,
    upgrade ladders, costs and expected distortions on seeded groups (it
    is the same host arithmetic in both); the reference's allocator
    properties (budget respected, legal lanes, monotone in the budget)
    on the port, as a seeded sweep and a hypothesis fuzz; ``StatsEMA``
    in float64 after the same row sequence, and its state crossing both
    ways; ``plan_for_model`` under the uniform prior (specs, leaf names,
    numels, chunks, bytes);
  * ``local_stats``: amax bitwise; the two power columns within rtol
    1e-6 (float32 sums in the library's order against XLA's);
  * the controller on one gloo rank: replans, one host sync a window,
    exact accounting at every plan, and a swap that leaves the state
    bitwise as it was.
"""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.adapt import allocate as JA
from repro.adapt import stats as JS
from repro_torch.adapt import allocate as TA
from repro_torch.adapt import stats as TS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _groups(mod, seed, n):
    rng = np.random.default_rng(seed)
    return [mod.Group(name=f"g{i}", numel=int(rng.integers(1, 5000)),
                      c=int(rng.integers(1, 5000)),
                      amax=float(rng.uniform(1e-6, 10.0)),
                      meansq=float(rng.uniform(1e-12, 1.0)))
            for i in range(n)]


def _check_alloc(groups, budget, n_workers):
    widths = TA.allocate(groups, budget, n_workers)
    assert len(widths) == len(groups)
    assert all(w in TA.WIDTHS for w in widths)
    cost = TA.plan_cost(groups, widths, n_workers)
    floor = sum(TA._hull_chain(g, n_workers)[0][0] for g in groups)
    assert cost <= max(budget, floor)
    return widths, cost


def test_lanes_and_specs_are_the_references():
    assert TA.WIDTHS == JA.WIDTHS
    assert TA.WIDTH_SPECS == JA.WIDTH_SPECS
    assert TA._LOG_K == JA._LOG_K and TA.LOG_REL2 == JA.LOG_REL2


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("n_workers", [1, 2, 8])
def test_allocator_identical_on_seeded_groups(seed, n_workers):
    tg, jg = _groups(TA, seed, 1 + seed), _groups(JA, seed, 1 + seed)
    for t, j in zip(tg, jg):
        assert TA._hull_chain(t, n_workers) == JA._hull_chain(j, n_workers)
        for w in TA.WIDTHS:
            assert TA.expected_distortion(w, t.amax, t.meansq) == \
                JA.expected_distortion(w, j.amax, j.meansq)
            assert TA.group_cost(t, w, n_workers) == \
                JA.group_cost(j, w, n_workers)
    assert TA.upgrade_sequence(tg, n_workers) == \
        JA.upgrade_sequence(jg, n_workers)
    base = JA.baseline_cost(jg, n_workers)
    assert TA.baseline_cost(tg, n_workers) == base
    for ratio in (0.0, 0.3, 0.6, 1.0, 3.0):
        budget = int(ratio * base)
        assert TA.allocate(tg, budget, n_workers) == \
            JA.allocate(jg, budget, n_workers)
        specs = TA.allocate_specs(tg, budget, n_workers)
        assert specs == JA.allocate_specs(jg, budget, n_workers)
        widths, cost = _check_alloc(tg, budget, n_workers)
        assert cost == JA.plan_cost(jg, widths, n_workers)


def test_seeded_sweep_budget_and_monotone():
    """The reference's always-on stand-in for its fuzz, on the port."""
    rng = np.random.default_rng(0)
    for trial in range(40):
        groups = _groups(TA, 100 + trial, int(rng.integers(1, 9)))
        nw = int(rng.integers(1, 9))
        b1 = int(rng.integers(0, 200_000))
        w1, _ = _check_alloc(groups, b1, nw)
        w2, _ = _check_alloc(groups, b1 + int(rng.integers(0, 200_000)),
                             nw)
        assert all(a <= b for a, b in zip(w1, w2))
    assert TA.allocate([], 100, 1) == ()


try:
    from hypothesis import given, settings, strategies as st
except ImportError:      # the seeded sweep above always runs
    st = None

if st is not None:
    def _group_st(mod):
        return st.builds(
            mod.Group, name=st.just("g"), numel=st.integers(1, 100_000),
            c=st.integers(1, 100_000),
            amax=st.floats(1e-9, 100.0, allow_nan=False,
                           allow_infinity=False),
            meansq=st.floats(1e-15, 10.0, allow_nan=False,
                             allow_infinity=False))

    @settings(max_examples=60, deadline=None)
    @given(groups=st.lists(_group_st(TA), min_size=1, max_size=8),
           budget=st.integers(0, 10 ** 7), n_workers=st.integers(1, 16))
    def test_fuzz_budget_respected_legal_and_the_references(
            groups, budget, n_workers):
        widths, _ = _check_alloc(groups, budget, n_workers)
        jg = [JA.Group(**dataclasses.asdict(g)) for g in groups]
        assert widths == JA.allocate(jg, budget, n_workers)

    @settings(max_examples=60, deadline=None)
    @given(groups=st.lists(_group_st(TA), min_size=1, max_size=6),
           b1=st.integers(0, 10 ** 6), extra=st.integers(0, 10 ** 6),
           n_workers=st.integers(1, 8))
    def test_fuzz_monotone_in_budget(groups, b1, extra, n_workers):
        w1 = TA.allocate(groups, b1, n_workers)
        w2 = TA.allocate(groups, b1 + extra, n_workers)
        assert all(a <= b for a, b in zip(w1, w2))


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------

def _rows(seed, n_steps, n_leaves):
    rng = np.random.default_rng(seed)
    return [np.abs(rng.standard_normal((n_leaves, 3))).astype(np.float32)
            * np.float32(10.0 ** rng.uniform(-6, 1)) for _ in range(n_steps)]


@pytest.mark.parametrize("decay", [0.0, 0.5, 0.8, 0.99])
def test_stats_ema_bitwise(decay):
    t, j = TS.StatsEMA(12, decay), JS.StatsEMA(12, decay)
    assert t.snapshot() is None and j.snapshot() is None
    for r in _rows(int(decay * 100), 9, 12):
        t.update(r)
        j.update(r)
        for f in ("amax", "meansq", "gsq"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
        np.testing.assert_array_equal(t.snapshot(), j.snapshot())
    assert t.count == j.count


def test_stats_ema_state_crosses_both_ways():
    """The checkpoint manifest's JSON: the port reads the reference's
    state and the reference reads the port's, each then going on bitwise
    with the other."""
    t, j = TS.StatsEMA(5, 0.7), JS.StatsEMA(5, 0.7)
    rows = _rows(3, 6, 5)
    for r in rows[:3]:
        t.update(r)
        j.update(r)
    assert json.dumps(t.state_dict()) == json.dumps(j.state_dict())
    t2 = TS.StatsEMA.from_state(json.loads(json.dumps(j.state_dict())))
    j2 = JS.StatsEMA.from_state(json.loads(json.dumps(t.state_dict())))
    for r in rows[3:]:
        for e in (t, j, t2, j2):
            e.update(r)
    for e in (t2, j2, j):
        np.testing.assert_array_equal(e.snapshot(), t.snapshot())
    with pytest.raises(ValueError):
        TS.StatsEMA.from_state({"decay": 0.5, "ema": [[1.0, 2.0]],
                                "amax_peak": [1.0], "weight": 1.0})
    with pytest.raises(ValueError):
        TS.StatsEMA(3).update(np.zeros((2, TS.N_FIELDS)))
    with pytest.raises(ValueError):
        TS.StatsEMA(3, decay=1.0)


@pytest.mark.parametrize("n", [1, 3, 1000, 65537])
def test_local_stats_against_reference(n):
    rng = np.random.default_rng(n)
    de = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    g = (rng.standard_normal(n) * 0.1).astype(np.float32)
    want = np.asarray(JS.local_stats(jnp.asarray(de), jnp.asarray(g)))
    got = TS.local_stats(torch.from_numpy(de), torch.from_numpy(g)).numpy()
    assert got.dtype == np.float32 and got.shape == (TS.N_FIELDS,)
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-6)
    # K15's folded amax, passed in, is used as it is
    amax = torch.tensor(float(np.abs(de).max()))
    np.testing.assert_array_equal(
        TS.local_stats(torch.from_numpy(de), torch.from_numpy(g),
                       amax=amax).numpy(), got)
    # one worker: the reduction is the identity
    rows = torch.from_numpy(np.stack([got, got]))
    assert TS.reduce_stats(rows.clone()).equal(rows)


# ---------------------------------------------------------------------------
# the controller on one gloo rank
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    from repro_torch.configs import get_config
    from repro_torch.dist.step import TrainConfig
    from repro_torch.launch import mesh as TM
    from repro_torch.models.model import Model
    group = TM.make_process_group("cpu", store=torch.distributed.HashStore())
    model = Model(get_config("yi-6b", smoke=True))
    yield model, group, TrainConfig(mode="adaptive")
    TM.close_process_group()


def _batches(model, seed=0):
    g = torch.Generator().manual_seed(seed)
    v = model.cfg.vocab_size
    while True:
        tok = torch.randint(0, v, (2, 16), generator=g).numpy()
        yield {"tokens": tok, "targets": tok}


def test_controller_replans_and_accounts(setup):
    from repro_torch.adapt.controller import AdaptConfig, AdaptiveController
    model, group, tc = setup
    ctl = AdaptiveController(model, group, tc, _batches(model),
                             AdaptConfig(replan_every=2), device="cpu",
                             log=lambda *_: None, verify=True)
    try:
        ctl.run(6)
        # one harvest sync a replan window, nothing a step
        assert ctl.stats["syncs"] == math.ceil(6 / 2)
        assert ctl.replans >= 1
        assert all("verify" in e for e in ctl.plan_log)
        for e in ctl.plan_log:
            assert e["verify"]["measured"] == \
                e["comm"]["update_exchange_bytes"]
        first = ctl.plan_log[0]["comm"]["update_exchange_bytes"]
        last = ctl.plan_log[-1]["comm"]["update_exchange_bytes"]
        assert last < first
        assert ctl.session.ckpt_extra["bit_plan"] == \
            list(ctl.tc.bit_plan)
        assert ctl.session.ckpt_extra["adapt_ema"]["weight"] == \
            ctl.ema.count
        losses = ctl.session.harvest_losses()
        assert losses and all(np.isfinite(v) for _, v in losses)
    finally:
        ctl.close()


def test_swap_preserves_state_bitwise(setup):
    """A replan changes only the wire: the state's tensors are the same
    objects holding the same bits after the swap."""
    from repro_torch.adapt.controller import AdaptConfig, AdaptiveController
    from repro_torch.tree import tree_flatten_with_path
    model, group, tc = setup
    ctl = AdaptiveController(model, group, tc, _batches(model, 1),
                             AdaptConfig(replan_every=2), device="cpu",
                             log=lambda *_: None)
    try:
        ctl.session.run(2)
        for _, rows in ctl.session.harvest_stats():
            ctl.ema.update(rows)
        before = [(k, x, x.clone()) for k, x in
                  tree_flatten_with_path(ctl.state)
                  if isinstance(x, torch.Tensor)]
        assert ctl.replan()
        after = dict(tree_flatten_with_path(ctl.state))
        for k, x, copy in before:
            assert after[k] is x and torch.equal(x, copy)
        # a step of another geometry is refused
        from repro_torch.dist.step import make_train_step
        from repro_torch.configs import get_config
        from repro_torch.models.model import Model
        other = make_train_step(Model(dataclasses.replace(
            get_config("yi-6b", smoke=True), n_layers=1)), group, ctl.tc)
        with pytest.raises(ValueError, match="layout"):
            ctl.session.swap_artifacts(other)
    finally:
        ctl.close()


def test_plan_for_model_uniform_prior_is_the_references(setup):
    from repro.adapt.controller import plan_for_model as j_plan
    from repro.configs import get_config as jget
    from repro.dist.step import TrainConfig as JTC
    from repro.models.model import Model as JModel
    from repro_torch.adapt.controller import plan_for_model
    from repro_torch.train.loop import comm_bytes_per_step
    model, group, tc = setup
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    for ratio in (0.3, 0.6, 1.0):
        jtc2, _, jrep = j_plan(JModel(jget("yi-6b", smoke=True)), mesh,
                               JTC(worker_axes=("data",), mode="adaptive"),
                               budget_ratio=ratio)
        tc2, art2, rep = plan_for_model(model, group, tc, budget_ratio=ratio)
        assert tc2.bit_plan == jtc2.bit_plan
        assert rep == jrep
        assert comm_bytes_per_step(art2, tc2)["update_exchange_bytes"] \
            == rep["plan_bytes"]
        if ratio >= 0.6:     # 0.3 lies below the cheapest plan
            assert rep["plan_bytes"] <= rep["budget_bytes"]
