"""Exchange buckets (``TrainConfig.exchange_bucket_bytes``) in the port's
distributed step, against the reference's ``_exchange_buckets``.

  * the bucket lists: the port's ``_exchange_buckets`` over its leaves in
    the reference's order, and the buckets ``make_train_step`` runs
    (layout indices mapped to the reference's), equal to the reference's
    lists for the same layout, mode, topology and worker count: yi-6b
    and deepseek-moe-16b at smoke size, every mode, the flat topology
    over 4 workers, ``2x2`` hierarchical tiers, and a model axis;
  * the step bitwise for buckets {0, 1, 1 KiB, 4 MiB} over 3 steps in
    every mode at one worker (a gloo rank in process): losses, master,
    m, v, e and the mode's extra state; the bucket hooks ran inside the
    backward. Four gloo ranks: ``tests/test_torch_buckets_workers.py``.
"""
import jax
import pytest
import torch

from repro.configs import get_config as jget
from repro.dist import sharding as JSH
from repro.dist import topology as JT
from repro.dist.modes import get_mode as j_get_mode
from repro.dist.step import TrainConfig as JTC
from repro.dist.step import _exchange_buckets as j_buckets
from repro.dist.step import _leaf_meta as j_leaf_meta
from repro.models.model import Model as JModel
from repro_torch.configs import get_config as tget
from repro_torch.data.pipeline import batch_for_model
from repro_torch.dist import topology as T
from repro_torch.dist.modes import get_mode
from repro_torch.dist.step import TrainConfig as TTC
from repro_torch.dist.step import _exchange_buckets, _leaf_meta
from repro_torch.dist.step import make_train_step
from repro_torch.launch.dryrun import RecordingDist, recording_grid
from repro_torch.models.model import Model as TModel
from repro_torch.tree import sorted_leaf_index, tree_leaves
from test_torch_dist import group  # noqa: F401

# every mode, at the reference's wire settings for it
MODES = {
    "qadam": dict(weight_k=7),
    "dp_adam": dict(weight_k=7),
    "efadam": dict(weight_k=7, weight_absolute=False),
    "terngrad": dict(alpha=2e-2, grad_k=None, weight_k=None),
    "ef_sgd": dict(alpha=1e-2, beta=0.9, grad_k=None, weight_k=None),
    "adaptive": dict(weight_k=7),
}
SIZES = (0, 1, 1 << 10, 64 << 10, 4 << 20)
# (grid sizes, axes, topology (port, reference))
GRIDS = {
    "flat4": ((4, 1), ("data", "model"), None),
    "2x2": ((2, 2, 1), ("pod", "data", "model"), (2, 2)),
    "data2-model2": ((2, 2), ("data", "model"), None),
}
ADAPTIVE_PLAN = ("blockwise:256", "log:2", "log:6", "log:30", "log:126",
                 "uniform_amax:14:w16")


def _plan(n):
    return tuple(ADAPTIVE_PLAN[i % len(ADAPTIVE_PLAN)] for i in range(n))


def _reference_buckets(arch, mode, kw, size, sizes, axes, topo):
    cfg = jget(arch, smoke=True)
    ms = dict(zip(axes, sizes))
    worker_axes = tuple(a for a in axes if a != "model")
    wsizes = tuple(ms[a] for a in worker_axes)
    n_workers = 1
    for s in wsizes:
        n_workers *= s
    pshapes = jax.eval_shape(JModel(cfg).init, jax.random.PRNGKey(0))
    layout = JSH.build_layout(pshapes, ms["model"])
    metas = j_leaf_meta(layout, n_workers)
    metas_flat = jax.tree_util.tree_structure(
        layout._leaves).flatten_up_to(metas)
    jmode = j_get_mode(mode)
    jtopo = JT.HierarchicalTopology(*topo) if topo else JT.FlatTopology()
    tiers = jtopo.tiers(worker_axes, wsizes) if jmode.tiered else \
        JT.flat_tiers(worker_axes, wsizes)
    extra = {"bit_plan": _plan(len(metas_flat))} if mode == "adaptive" \
        else {}
    jtc = JTC(mode=mode, exchange_bucket_bytes=size, worker_axes=worker_axes,
              topology=jtopo, **kw, **extra)
    return j_buckets(metas_flat, jmode, jtc, n_workers, tiers), \
        len(metas_flat)


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ["yi-6b", "deepseek-moe-16b"])
def test_bucket_lists_equal_the_reference(arch, mode, grid):
    sizes, axes, topo = GRIDS[grid]
    kw = MODES[mode]
    model = TModel(tget(arch, smoke=True))
    g = recording_grid(sizes, axes, RecordingDist(0))
    for size in SIZES:
        want, n_leaves = _reference_buckets(arch, mode, kw, size, sizes,
                                            axes, topo)
        extra = {"bit_plan": _plan(n_leaves)} if mode == "adaptive" else {}
        ttopo = T.HierarchicalTopology(*topo) if topo else T.FlatTopology()
        tc = TTC(mode=mode, exchange_bucket_bytes=size, topology=ttopo,
                 **kw, **extra)
        art = make_train_step(model, g, tc)
        index = sorted_leaf_index(art.layout.shapes)
        got = [[index[i] for i in b] for b in art.buckets]
        assert got == want, (size, got, want)
        # the function itself, over the leaves in the reference's order
        metas = tree_leaves(_leaf_meta(art.layout, art.n_workers))
        ref_order = sorted(range(len(metas)), key=index.__getitem__)
        assert _exchange_buckets([metas[i] for i in ref_order],
                                 get_mode(mode), tc, art.n_workers,
                                 art.tiers) == want


def _run(model, group, tc, steps=3):
    art = make_train_step(model, group, tc)
    state = art.init_state(seed=0, device="cpu")
    batches = batch_for_model(model.cfg, 32, 4, seed=0)
    losses = []
    for _ in range(steps):
        batch = {k: torch.as_tensor(v) for k, v in next(batches).items()}
        state, m = art.step_fn(state, batch)
        losses.append(float(m["loss"]))
    return art, losses, state


@pytest.mark.parametrize("mode", list(MODES))
def test_step_bitwise_for_every_bucket_size(group, mode):  # noqa: F811
    torch.set_num_threads(1)
    model = TModel(tget("yi-6b", smoke=True))
    extra = {}
    if mode == "adaptive":
        n = len(tree_leaves(model.init(torch.Generator(), device="meta")))
        extra = {"bit_plan": _plan(n)}
    runs = {}
    for size in (0, 1, 1 << 10, 4 << 20):
        tc = TTC(mode=mode, exchange_bucket_bytes=size, **MODES[mode],
                 **extra)
        art, losses, state = _run(model, group, tc)
        if size in (1, 1 << 10):
            assert len(art.buckets) > 1
            assert art.overlap["in_backward"] == len(art.buckets)
        runs[size] = (losses, state)
    base_losses, base = runs[0]
    for size, (losses, state) in runs.items():
        assert losses == base_losses, size
        for k in base:
            if k == "count":
                assert state[k] == base[k]
                continue
            for a, b in zip(tree_leaves(state[k]), tree_leaves(base[k])):
                assert torch.equal(a, b), (size, k)


@pytest.mark.parametrize("size", [0, 1 << 10])
def test_phase_marks_stay_on_the_single_pass(group, size):  # noqa: F811
    """The per-leaf update marks come from the single pass alone: with
    buckets the updates run inside the backward (on the card on a side
    stream, where a mark's event would book the backward as update), so
    the step marks "broadcast" and then "forward_backward" once."""
    torch.set_num_threads(1)
    model = TModel(tget("yi-6b", smoke=True))
    art = make_train_step(model, group, TTC(exchange_bucket_bytes=size,
                                            **MODES["qadam"]))
    state = art.init_state(seed=0, device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in
             next(batch_for_model(model.cfg, 32, 4, seed=0)).items()}
    names = []
    art.step_fn(state, batch, mark=names.append)
    assert names[:2] == ["broadcast", "forward_backward"]
    if size:
        assert len(art.buckets) > 1 and names == names[:2]
    else:
        n = len(tree_leaves(art.layout.shapes))
        assert names[2:] == ["update_exchange", "master_update"] * n
