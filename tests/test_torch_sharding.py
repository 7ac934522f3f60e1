"""The port's model-axis layout and weight gathers
(``repro_torch.dist.sharding``, ``dist.collectives``) against the JAX
package's.

  * ``shard_dim_for``, ``local_shard_shape`` and ``shard_of`` on every
    leaf of every ported configuration's smoke model at 1, 2 and 4
    shards: shard dims and shapes equal, shards bitwise; the
    ``EXPERT_MARKER`` rule on made-up MoE paths; ``Layout.shard_axes``;
  * ``split_worker_axes`` and ``worker_info``;
  * ``quantized_gather_shard`` at one shard (the plain versions on the
    CPU) bitwise against the reference's: codes, scales and dequantized
    values; its gradient against ``jax.grad`` of the reference's: the
    same nonzero elements, each value a float32 sum of the same N terms
    in another order, so within the recursive-summation bound
    N * 2^-24 * sum|terms| of it;
  * ``gather_shard``'s identity at one shard, and ``make_grid``'s layout
    and groups on one rank;
  * ``convert.params_from_numpy``'s model shards of the reference's
    parameters, bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.dist import collectives as JC
from repro.dist import sharding as JSH
from repro.models.model import Model as JModel
from repro_torch.configs import ARCH_IDS
from repro_torch.configs import get_config as tget
from repro_torch.dist import collectives as C
from repro_torch.dist import sharding as SH
from repro_torch.launch import mesh as TM
from repro_torch.models.model import Model as TModel


def _leaves(arch):
    """[(path, shape)] of the smoke model, in the port's tree order."""
    shapes = TModel(tget(arch, smoke=True)).init(device="meta")
    out = []

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        else:
            out.append((path, tuple(t.shape)))
    walk(shapes, ())
    return shapes, out


def _jdims(arch, n):
    jm = JModel(jget(arch, smoke=True))
    lay = JSH.build_layout(jax.eval_shape(jm.init, jax.random.PRNGKey(0)),
                           n)
    flat = jax.tree_util.tree_flatten_with_path(lay.dims)[0]
    st = jax.tree_util.tree_flatten_with_path(lay.stacked)[0]
    return ({JSH._path_keys(p): d for p, d in flat},
            {JSH._path_keys(p): s for p, s in st})


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_layout_every_leaf(arch, n_shards):
    shapes, leaves = _leaves(arch)
    layout = SH.build_layout(shapes, n_shards)
    jdims, jstacked = _jdims(arch, n_shards)
    dims = SH.dims_by_path(layout)
    axes = dict(SH.dims_by_path(SH.Layout(
        shapes=layout.shapes, dims=layout.shard_axes(),
        stacked=layout.stacked, n_shards=n_shards)))
    rng = np.random.default_rng(n_shards)
    assert set(dims) == set(jdims)
    for path, shape in leaves:
        dim, stacked = dims[path]
        assert (dim, stacked) == (jdims[path], jstacked[path]), path
        assert dim == SH.shard_dim_for(path, shape, n_shards, stacked) == \
            JSH.shard_dim_for(path, shape, n_shards, stacked)
        assert SH.axis_of(dim, stacked) == JSH.axis_of(dim, stacked)
        local = SH.local_shard_shape(shape, dim, stacked, n_shards)
        assert local == JSH.local_shard_shape(shape, dim, stacked, n_shards)
        ax = SH.axis_of(dim, stacked)
        assert axes[path][0] == (ax, n_shards if ax is not None else 1)
        x = rng.standard_normal(shape).astype(np.float32)
        for i in range(n_shards):
            got = SH.shard_of(torch.from_numpy(x), dim, stacked, n_shards,
                              i).numpy()
            want = np.asarray(JSH.shard_of(jnp.asarray(x), dim, stacked,
                                           n_shards, i))
            assert got.shape == local
            np.testing.assert_array_equal(got, want)
    if n_shards > 1:
        assert any(d != SH.REPLICATED for d, _ in dims.values())


@pytest.mark.parametrize("path,shape,stacked", [
    (("blocks", "moe", "w_gate"), (4, 8, 16, 32), True),
    (("blocks", "moe", "w_down"), (4, 6, 32, 16), True),
    (("blocks", "moe", "shared", "w_up"), (4, 16, 32), True),
    (("moe", "w_up"), (8, 16, 32), False),
    (("blocks", "moe", "router"), (4, 16, 8), True),
    (("blocks", "mlp", "w_gate"), (4, 16, 32), True),
    (("blocks", "moe", "w_gate"), (4, 3, 16, 32), True),
    (("norm",), (), False),
    (("blocks", "attn", "bq"), (4, 6), True),
])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_shard_dim_rules(path, shape, stacked, n_shards):
    """``EXPERT_MARKER`` on MoE expert leaves (not the shared expert, not
    the router, not where the expert count does not divide), the
    ``_STACKED_KEYS`` offset, scalars and leaves with no divisible
    axis."""
    want = JSH.shard_dim_for(path, shape, n_shards, stacked)
    assert SH.shard_dim_for(path, shape, n_shards, stacked) == want
    if path[-1] == "w_gate" and path[1] == "moe" and shape[1] % n_shards \
            == 0:
        assert want == SH.EXPERT_MARKER
    layout = SH.build_layout(_nest(path, torch.empty(shape, device="meta")),
                             n_shards)
    assert SH.dims_by_path(layout)[path] == (want, path[0] in
                                             ("blocks", "enc_blocks"))


def _nest(path, leaf):
    for k in reversed(path):
        leaf = {k: leaf}
    return leaf


@pytest.mark.parametrize("axes,sizes,outer,inner", [
    (("pod", "data"), (2, 4), 2, 4), (("a", "b", "c"), (2, 4, 2), 8, 2),
    (("data",), (1,), 1, 1), (("pod", "data"), (1, 1), 1, 1),
    (("data",), (4,), 1, 4), (("data",), (4,), 4, 1),
    (("data",), (8,), 2, 4), (("pod", "data"), (2, 2), 2, 4)])
def test_split_worker_axes(axes, sizes, outer, inner):
    try:
        want = JSH.split_worker_axes(axes, sizes, outer, inner)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            SH.split_worker_axes(axes, sizes, outer, inner)
        assert str(got.value) == str(e)
        return
    got = SH.split_worker_axes(axes, sizes, outer, inner)
    assert tuple(map(tuple, got)) == tuple(map(tuple, want))


def test_worker_info():
    grid = TM.Grid(axes=("pod", "data", "model"), sizes=(2, 3, 2),
                   coords=(1, 2, 0), groups={}, world=None)
    assert SH.worker_info(grid) == (("pod", "data"), (2, 3), 6)
    assert SH.worker_info(grid, ("data",)) == (("data",), (3,), 3)
    assert (grid.worker_axes, grid.wsizes, grid.n_workers) == \
        (("pod", "data"), (2, 3), 6)
    assert (grid.worker_index, grid.model_index, grid.rank) == (5, 0, 10)
    assert grid.index_over(("pod",)) == 1


# ---------------------------------------------------------------------------
# the weight gathers at one shard
# ---------------------------------------------------------------------------

LEAVES = [((64, 48), 0), ((8, 300), 1), ((2, 16, 33), 2)]


@pytest.mark.parametrize("absolute", [False, True])
@pytest.mark.parametrize("k_x", [7, 8, 3])
@pytest.mark.parametrize("shape,ax", LEAVES)
def test_quantized_gather_one_shard_bitwise(shape, ax, k_x, absolute):
    rng = np.random.default_rng(k_x)
    x = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    codec = JC.comm.UniformCodec(k_x=k_x, absolute=absolute, wire_bits=8)
    jx = jnp.asarray(x)
    jscale = codec.compute_scale(jx)
    jcodes = np.asarray(codec.quantize(jx, jscale).astype(jnp.int8))
    want = np.asarray(JC.quantized_gather_shard(jx, ax, 1, k_x, absolute))
    codes, scale = C.quantize_shard(torch.from_numpy(x), k_x, absolute)
    assert codes.dtype == torch.int8
    np.testing.assert_array_equal(codes.numpy(), jcodes)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    got = C.quantized_gather_shard(torch.from_numpy(x), ax, 1, k_x,
                                   absolute).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("absolute", [False, True])
@pytest.mark.parametrize("shape,ax", LEAVES)
def test_quantized_gather_gradient_is_jax_grad(shape, ax, absolute, ties):
    """The int8 gather's gradient against ``jax.grad`` through the
    reference's: only the scale carries one, onto the elements at the
    max (split between ties, signed); none with an absolute grid."""
    rng = np.random.default_rng(len(shape))
    x = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    w = rng.standard_normal(shape).astype(np.float32)
    if ties:
        flat = x.reshape(-1)
        i = int(np.argmax(np.abs(flat)))
        flat[(i + 5) % flat.size] = -flat[i]
    want = np.asarray(jax.grad(lambda v: jnp.sum(
        JC.quantized_gather_shard(v, ax, 1, 8, absolute) * w))(
            jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    out = C.quantized_gather_shard(xt, ax, 1, 8, absolute)
    (got,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), xt)
    got = got.numpy()
    assert np.count_nonzero(want) == (0 if absolute else 1 + ties)
    np.testing.assert_array_equal(got != 0, want != 0)
    codes, _ = C.quantize_shard(torch.from_numpy(x), 8, absolute)
    terms = np.abs(w.astype(np.float64) * codes.numpy() / 2.0 ** 8)
    bound = x.size * 2.0 ** -24 * terms.sum()
    assert np.abs(got.astype(np.float64) - want).max() <= bound


def test_gather_shard_one_shard_is_the_leaf():
    x = torch.randn(4, 6, requires_grad=True)
    assert C.gather_shard(x, 1, 1) is x


@pytest.fixture
def one_rank():
    g = TM.make_process_group("cpu", store=torch.distributed.HashStore())
    yield g
    TM.close_process_group()


def test_make_grid_one_rank(one_rank):
    """On one rank every group is the world (its collectives still run),
    the coordinates are 0 and the grid's figures are those of one
    worker and one shard; a plain group is the flat grid."""
    grid = TM.make_grid(pod=1, data=1, model=1, device="cpu")
    assert grid.axes == ("pod", "data", "model")
    assert (grid.sizes, grid.coords) == ((1, 1, 1), (0, 0, 0))
    assert all(g is torch.distributed.group.WORLD
               for g in grid.groups.values())
    assert len(grid.groups) == 8
    plain = TM.Grid.of_group(one_rank)
    assert (plain.worker_axes, plain.n_workers, plain.n_shards) == \
        (("data",), 1, 1)
    assert plain.workers is one_rank and plain.model is None
    with pytest.raises(ValueError, match="needs 2 ranks"):
        TM.make_grid(pod=0, data=2, model=1, device="cpu")


def test_params_from_numpy_model_shards():
    """``convert.params_from_numpy`` with a layout: each rank's model
    shard of the reference's initial parameters, bitwise the reference's
    ``shard_of``."""
    from repro_torch.convert import params_from_numpy
    jm = JModel(jget("gemma3-4b", smoke=True))
    ref = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    shapes, leaves = _leaves("gemma3-4b")
    layout = SH.build_layout(shapes, 2)
    jdims, jstacked = _jdims("gemma3-4b", 2)
    flat = {JSH._path_keys(p): a for p, a in
            jax.tree_util.tree_flatten_with_path(ref)[0]}
    for index in range(2):
        got = _flat_paths(params_from_numpy(ref, "cpu", layout=layout,
                                            index=index))
        for path, _ in leaves:
            want = np.asarray(JSH.shard_of(jnp.asarray(flat[path]),
                                           jdims[path], jstacked[path], 2,
                                           index))
            np.testing.assert_array_equal(got[path].numpy(), want)


def _flat_paths(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_paths(v, path + (k,)))
        return out
    return {path: tree}
