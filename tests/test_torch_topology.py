"""The port's topology layer (``repro_torch.dist.topology``, the tier
accounting of ``dist.modes`` and ``train.loop.comm_bytes_per_step``)
against the JAX package's own functions, imported here as the oracle.
Pure functions, no process group; every tier exact.

  * tier resolution: every case of the reference's
    ``TestTiersResolution`` (``tests/test_topology.py``), the 1x1
    degeneracy and both ``ValueError``s, field for field;
  * ``parse_topology``;
  * ``leaf_tier_nbytes`` at every lane width of ``comm/bits.py``, exact
    integers against the reference's at 2x2 and 2x4 (flat and
    hierarchical), and ``comm_bytes_per_step`` over whole smoke models;
  * a mode that is not tiered (``dp_adam``) ignores the hierarchy;
  * the inter tier's exchange bytes are exactly 1/devices_per_node of
    the flat wire's.
"""
import dataclasses
import types

import jax
import pytest
import torch

from repro.adapt.allocate import WIDTH_SPECS as J_WIDTH_SPECS
from repro.configs import get_config as jget
from repro.dist import sharding as JSH
from repro.dist import topology as JT
from repro.dist.modes import get_mode as j_get_mode
from repro.dist.step import TrainConfig as JTC
from repro.models.model import Model as JModel
from repro.train.loop import comm_bytes_per_step as j_comm_bytes
from repro_torch.adapt import WIDTH_SPECS
from repro_torch.comm import bits as B
from repro_torch.configs import get_config as tget
from repro_torch.dist import sharding as SH
from repro_torch.dist import topology as T
from repro_torch.dist.modes import get_mode
from repro_torch.dist.step import TrainConfig as TTC
from repro_torch.models.model import Model as TModel
from repro_torch.train.loop import comm_bytes_per_step

TIER_CASES = [
    # (topology or None for flat, worker axes, sizes)
    (None, ("pod", "data"), (2, 4)),
    ((2, 4), ("pod", "data"), (2, 4)),
    ((8, 2), ("a", "b", "c"), (2, 4, 2)),
    ((1, 1), ("data",), (1,)),
    ((1, 1), ("pod", "data"), (1, 1)),
    ((2, 1), ("pod", "data"), (2, 1)),
    ((1, 4), ("data",), (4,)),
    ((4, 1), ("data",), (4,)),
    ((2, 2), ("pod", "data"), (2, 2)),
]
BAD_CASES = [
    ((2, 4), ("data",), (8,), "axis boundary"),      # splits one axis
    ((2, 4), ("pod", "data"), (2, 2), "needs 8 workers"),
]


def _fields(t):
    return (t.inter_axes, t.inter_sizes, t.intra_axes, t.intra_sizes,
            t.n_inter, t.n_intra, t.hierarchical)


@pytest.mark.parametrize("topo,axes,sizes", TIER_CASES)
def test_tiers_resolution(topo, axes, sizes):
    if topo is None:
        want, got = JT.FlatTopology().tiers(axes, sizes), \
            T.FlatTopology().tiers(axes, sizes)
        assert got == T.flat_tiers(axes, sizes)
    else:
        want = JT.HierarchicalTopology(*topo).tiers(axes, sizes)
        got = T.HierarchicalTopology(*topo).tiers(axes, sizes)
    assert _fields(got) == _fields(want)
    if topo == (1, 1):
        assert got.n_inter == got.n_intra == 1


@pytest.mark.parametrize("topo,axes,sizes,msg", BAD_CASES)
def test_tiers_refusals(topo, axes, sizes, msg):
    with pytest.raises(ValueError, match=msg) as want:
        JT.HierarchicalTopology(*topo).tiers(axes, sizes)
    with pytest.raises(ValueError, match=msg) as got:
        T.HierarchicalTopology(*topo).tiers(axes, sizes)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as split:
        SH.split_worker_axes(axes, sizes, *topo)
    assert str(split.value) == str(want.value)


@pytest.mark.parametrize("spec", [None, "flat", "", "2x4", " 2X2 ", "1x1",
                                  "2x4x2", "fast", "x2"])
def test_parse_topology(spec):
    try:
        want = JT.parse_topology(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            T.parse_topology(spec)
        assert str(got.value) == str(e)
        return
    got = T.parse_topology(spec)
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    topo = T.HierarchicalTopology(3, 2)
    assert T.parse_topology(topo) is topo


# ---------------------------------------------------------------------------
# per-tier bytes
# ---------------------------------------------------------------------------

GEOMETRIES = {"2x2": (("pod", "data"), (2, 2), (2, 2)),
              "2x4": (("pod", "data"), (2, 4), (2, 4))}
# every lane width of comm/bits.py (the adaptive lanes), and the fixed
# modes' wires: log:6 (qadam), ternary, blockwise (ef_sgd), float32
LANE_SPECS = sorted(WIDTH_SPECS.values())
MODES = [("qadam", dict(grad_k=6)), ("qadam", dict(grad_k=None)),
         ("efadam", dict(grad_k=4)), ("terngrad", {}), ("ef_sgd", {}),
         ("dp_adam", {})]


def test_lane_specs_cover_every_width():
    assert sorted(WIDTH_SPECS) == list(B.SUPPORTED_BITS)
    assert WIDTH_SPECS == J_WIDTH_SPECS


def _both_tiers(geo):
    axes, sizes, topo = GEOMETRIES[geo]
    return ((T.flat_tiers(axes, sizes), JT.flat_tiers(axes, sizes)),
            (T.HierarchicalTopology(*topo).tiers(axes, sizes),
             JT.HierarchicalTopology(*topo).tiers(axes, sizes)))


@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
@pytest.mark.parametrize("spec", LANE_SPECS)
def test_leaf_tier_nbytes_every_lane(geo, spec):
    tm, jm = get_mode("adaptive"), j_get_mode("adaptive")
    tc, jc = TTC(mode="adaptive", bit_plan=(spec,)), \
        JTC(mode="adaptive", bit_plan=(spec,))
    n = 1
    for s in GEOMETRIES[geo][1]:
        n *= s
    for numel in (n * 97, n * 97 - 3, 1000, 5):
        c = SH.chunk_size(numel, n)
        for tiers, jtiers in _both_tiers(geo) + ((None, None),):
            got = tm.leaf_tier_nbytes(tc, 0, c, numel, n, tiers)
            want = jm.leaf_tier_nbytes(jc, 0, c, numel, n, jtiers)
            assert got == want, (spec, numel, tiers)
            assert all(type(v) is int for v in got.values())


@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
@pytest.mark.parametrize("mode,kw", MODES,
                         ids=[f"{m}-{i}" for i, (m, _) in enumerate(MODES)])
def test_leaf_tier_nbytes_modes(geo, mode, kw):
    tm, jm = get_mode(mode), j_get_mode(mode)
    tc, jc = TTC(mode=mode, **kw), JTC(mode=mode, **kw)
    n = 4 if geo == "2x2" else 8
    numel = 1000 * n + 7
    c = SH.chunk_size(numel, n)
    for tiers, jtiers in _both_tiers(geo):
        assert tm.leaf_tier_nbytes(tc, 0, c, numel, n, tiers) == \
            jm.leaf_tier_nbytes(jc, 0, c, numel, n, jtiers)


def test_untiered_mode_ignores_hierarchy():
    mode = get_mode("dp_adam")
    assert not mode.tiered
    tc = TTC(mode="dp_adam")
    hier = T.HierarchicalTopology(2, 4).tiers(("pod", "data"), (2, 4))
    d = mode.leaf_tier_nbytes(tc, 0, 128, 1024, 8, hier)
    assert d == {"inter": mode.leaf_wire_nbytes(tc, 0, 128, 8), "intra": 0}


@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
def test_hier_inter_is_an_exact_fraction(geo):
    mode = get_mode("qadam")
    tc = TTC(grad_k=6)
    axes, sizes, topo = GEOMETRIES[geo]
    n = sizes[0] * sizes[1]
    flat_t, hier_t = (t for t, _ in _both_tiers(geo))
    for numel in (1024 * n, 1000 * n + 3):
        c = SH.chunk_size(numel, n)
        flat = mode.leaf_tier_nbytes(tc, 0, c, numel, n, flat_t)
        hier = mode.leaf_tier_nbytes(tc, 0, c, numel, n, hier_t)
        assert flat["inter"] == topo[1] * hier["inter"]
        assert hier["intra"] == topo[1] * numel * 4


def _arts(arch, geo, n_shards, mode, kw):
    """Minimal artifacts of both packages (layout, workers, tiers) for
    ``comm_bytes_per_step``."""
    axes, sizes, topo = GEOMETRIES[geo]
    n = sizes[0] * sizes[1]
    tshapes = TModel(tget(arch, smoke=True)).init(device="meta")
    jm = JModel(jget(arch, smoke=True))
    jshapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    tiered = get_mode(mode).tiered
    t_t = (T.HierarchicalTopology(*topo).tiers(axes, sizes) if tiered
           else T.flat_tiers(axes, sizes))
    j_t = (JT.HierarchicalTopology(*topo).tiers(axes, sizes) if tiered
           else JT.flat_tiers(axes, sizes))
    tart = types.SimpleNamespace(layout=SH.build_layout(tshapes, n_shards),
                                 n_workers=n, tiers=t_t)
    jart = types.SimpleNamespace(layout=JSH.build_layout(jshapes, n_shards),
                                 n_workers=n, tiers=j_t)
    return tart, jart, TTC(mode=mode, **kw), JTC(mode=mode, **kw)


@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("mode,kw", [
    ("qadam", dict(grad_k=6, weight_k=7)), ("efadam", dict(weight_k=3)),
    ("dp_adam", dict(weight_k=7))], ids=["qadam", "efadam", "dp_adam"])
def test_comm_bytes_per_step(geo, n_shards, mode, kw):
    """Every figure of ``comm_bytes_per_step`` (per tier, per channel)
    over the yi-6b smoke model's leaves, at one and two model shards."""
    tart, jart, tc, jc = _arts("yi-6b", geo, n_shards, mode, kw)
    got, want = comm_bytes_per_step(tart, tc), j_comm_bytes(jart, jc)
    assert got == {k: (int(v) if not isinstance(v, dict) else v)
                   for k, v in want.items()}
