"""The wire's row codecs (K7 ``encode_rows_ef``, K6 ``decode_rows``) and
the byte accounting of the distributed step, against the JAX package.

Tier: bitwise. Inputs come from numpy seeds; the reference runs its
``backend="jnp"`` branch (``repro/comm/codec.py`` ``_encode_rows_ef_jit``
and ``_decode_rows_jit``), the port its plain versions (the CPU side of
K7 and K6; ``tests/test_torch_cuda_kernels.py`` holds the kernels
against these on the card). Payload bytes, residuals and decoded rows
must be identical over n_rows in {1, 2, 4}, chunk lengths c in
{1, 7, 1000003} (the last row short by n_rows - 1 elements), the log
grid at k_g in {2, 4, 6, 8} (3-, 4- and 6-bit lanes) and the uniform
wire at k_x in {3, 6, 7} (4- and 8-bit lanes, the +/-2^k_x clip), and an
all-zero input. One exception, stated where it is tested: with an amax
scale the uniform wire's residual is within one rounding of the product
of the reference's (XLA's fma). ``payload_nbytes`` and
``comm_bytes_per_step`` equal the reference's integers for full-width
yi-6b at 1, 2, 4 and 8 workers, for the paper's mode and the four
baselines.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comm as J
from repro.configs import get_config as jget
from repro.dist import sharding as JSH
from repro.dist.step import TrainConfig as JTC
from repro.dist.step import _leaf_meta as j_leaf_meta
from repro.models.model import Model as JModel
from repro.train.loop import comm_bytes_per_step as j_comm_bytes
from repro_torch.comm import codec as T
from repro_torch.configs import get_config as tget
from repro_torch.dist import sharding as TSH
from repro_torch.dist.step import TrainConfig as TTC
from repro_torch.models.model import Model as TModel
from repro_torch.train.loop import comm_bytes_per_step as t_comm_bytes

CODECS = [("log", 2), ("log", 4), ("log", 6), ("log", 8),
          ("uniform", 3), ("uniform", 6), ("uniform", 7)]


def _codecs(kind, k, absolute=True):
    if kind == "log":
        return J.LogCodec(k_g=k), T.LogCodec(k_g=k)
    return (J.uniform_wire_codec(k, absolute),
            T.uniform_wire_codec(k, absolute))


def _inputs(kind, n, seed, zero=False):
    """x and its scale: the amax scale (guarded) for the log grid, 0.5 for
    the absolute uniform grid with values reaching past it (the clip)."""
    rng = np.random.default_rng(seed)
    if zero:
        x = np.zeros(n, np.float32)
    elif kind == "log":
        x = (rng.standard_normal(n) * rng.choice([1e-3, 1.0, 30.0])
             ).astype(np.float32)
    else:
        x = (rng.standard_normal(n) * 0.3).astype(np.float32)
    if kind == "log":
        amax = np.float32(np.abs(x).max())
        scale = amax if amax > 0 else np.float32(1.0)
    else:
        scale = np.float32(0.5)
    return x, np.float32(scale)


@pytest.mark.parametrize("kind,k", CODECS, ids=lambda v: str(v))
@pytest.mark.parametrize("c", [1, 7, 1000003])
@pytest.mark.parametrize("n_rows", [1, 2, 4])
def test_encode_decode_rows_bitwise(kind, k, c, n_rows):
    jc, tc = _codecs(kind, k)
    assert tc.bits == jc.bits and tc.clip_abs == jc.clip_abs
    n = n_rows * c - (n_rows - 1)
    x, scale = _inputs(kind, n, seed=n_rows * 1000 + c + k)
    jp, je = J.encode_rows_ef(jnp.asarray(x), jnp.float32(scale), jc, n_rows,
                              backend="jnp")
    tp, te = T.encode_rows_ef(torch.from_numpy(x), torch.tensor(scale), tc,
                              n_rows)
    assert tuple(tp.shape) == (n_rows, tc.payload_nbytes(c))
    assert tp.dtype == torch.uint8
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    np.testing.assert_array_equal(np.asarray(je).view(np.int32),
                                  te.numpy().view(np.int32))
    # decode with a distinct scale per source row
    scales = (np.random.default_rng(c).uniform(0.5, 2.0, n_rows)
              * scale).astype(np.float32)
    jd = J.decode_rows(jp, jnp.asarray(scales), jc, c, backend="jnp")
    td = T.decode_rows(tp, torch.from_numpy(scales), tc, c)
    assert tuple(td.shape) == (n_rows, c) and td.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(jd).view(np.int32),
                                  td.numpy().view(np.int32))
    # straight into a leaf of n elements, the rows' padding dropped
    out = torch.full((n,), float("nan"))
    assert T.decode_rows(tp, torch.from_numpy(scales), tc, c, out=out) is out
    assert torch.equal(out, td.reshape(-1)[:n])


@pytest.mark.parametrize("kind,k", CODECS, ids=lambda v: str(v))
def test_all_zero_input(kind, k):
    jc, tc = _codecs(kind, k)
    x, scale = _inputs(kind, 1001, seed=0, zero=True)
    jp, je = J.encode_rows_ef(jnp.asarray(x), jnp.float32(scale), jc, 2,
                              backend="jnp")
    tp, te = T.encode_rows_ef(torch.from_numpy(x), torch.tensor(scale), tc, 2)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    assert not te.any()
    np.testing.assert_array_equal(
        np.asarray(J.decode_rows(jp, jnp.ones(2), jc, 501, backend="jnp")),
        T.decode_rows(tp, torch.ones(2), tc, 501).numpy())


def test_amax_uniform_wire_and_residual_out():
    """The amax-scaled weight wire, and K7's residual written over its
    own input (what the distributed updater does with e). Payload
    bitwise. The residual x - (c / 2^k) * s: the port rounds the product
    once and then the difference (K7's definition, emulated here in
    numpy float32 op by op, bitwise); XLA on the CPU contracts the pair
    into an fma, so the reference's differs by at most one rounding of
    the product (with the absolute scale 0.5, or on the log grid, the
    product is exact and both are bitwise, above)."""
    jc, tc = J.uniform_wire_codec(7, False), T.uniform_wire_codec(7, False)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(4099).astype(np.float32)
    scale = np.float32(np.abs(x).max())
    jp, je = J.encode_rows_ef(jnp.asarray(x), jnp.float32(scale), jc, 3,
                              backend="jnp")
    t = torch.from_numpy(x.copy())
    tp, te = T.encode_rows_ef(t, torch.tensor(scale), tc, 3, out=t)
    assert te is t
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    codes = np.clip(np.round(np.clip(x / scale, -1, 1) * np.float32(128)),
                    -127, 127).astype(np.float32)
    level = (codes / np.float32(128)) * scale
    np.testing.assert_array_equal(x - level, te.numpy())
    ulp = np.spacing(np.abs(level)).astype(np.float32)
    diff = np.abs(np.asarray(je) - te.numpy())
    assert (diff <= ulp).all()
    print(f"reference residual off by XLA's fma at {(diff > 0).mean():.1%} "
          f"of elements, at most {(diff / ulp).max():.2f} ulp of the product")


@pytest.mark.parametrize("spec", ["none", "log:6", "log:2", "uniform:7",
                                  "uniform_amax:3", "uniform:7:wire",
                                  "uniform:6:w4", "uniform_amax:7:w8"])
def test_registry_and_nbytes(spec):
    jc, tc = J.get_codec(spec), T.get_codec(spec)
    assert (tc.spec, tc.bits, tc.kind, tc.clip_abs) == \
        (jc.spec, jc.bits, jc.kind, jc.clip_abs)
    for numel in (1, 7, 1000003, 360710144):
        assert tc.payload_nbytes(numel) == jc.payload_nbytes(numel)
        assert tc.wire_nbytes(numel) == jc.wire_nbytes(numel)
    lut = jc.dequant_lut()
    if lut is None:
        assert tc.dequant_lut() is None
    else:
        np.testing.assert_array_equal(np.asarray(lut), tc.dequant_lut())


def test_unported_codec_paths_raise():
    """What the port's codecs still refuse. The baselines' codecs are
    ported ('terngrad', 'blockwise:b', ``Codec.encode`` and
    ``encode_rows``: tests/test_torch_encode_rows.py); the blockwise codec
    stays outside the one-scale-per-row contract of encode_rows, as in
    the reference, and a spec the registry does not know raises."""
    assert isinstance(T.get_codec("terngrad"), T.TernaryCodec)
    assert T.get_codec("blockwise:256").block == 256
    with pytest.raises(NotImplementedError, match="blockwise_exchange"):
        T.encode_rows(torch.ones(4), T.BlockwiseCodec(), 2)
    with pytest.raises(NotImplementedError, match="blockwise_exchange"):
        T.decode_rows(torch.zeros(2, 1, dtype=torch.uint8), torch.ones(2),
                      T.BlockwiseCodec(), 2)
    with pytest.raises(ValueError, match="unknown codec"):
        T.get_codec("topk:8")


@pytest.fixture(scope="module")
def yi_layouts():
    jshapes = jax.eval_shape(JModel(jget("yi-6b")).init,
                             jax.random.PRNGKey(0))
    tshapes = TModel(tget("yi-6b")).init(device="meta")
    return JSH.build_layout(jshapes, 1), TSH.build_layout(tshapes)


@pytest.mark.parametrize("n_workers", [1, 2, 4, 8])
@pytest.mark.parametrize("grad_k,weight_k,absolute,mode", [
    (6, 7, True, "qadam"), (4, 3, False, "qadam"), (None, 7, True, "qadam"),
    (6, None, True, "qadam"), (8, 6, True, "qadam"),
    (None, None, True, "dp_adam"), (None, 7, True, "dp_adam"),
    (6, 7, False, "efadam"), (4, 3, True, "efadam"),
    (None, None, True, "terngrad"), (None, 6, True, "terngrad"),
    (None, None, True, "ef_sgd"), (6, 7, True, "ef_sgd")])
def test_comm_bytes_per_step_full_width(yi_layouts, n_workers, grad_k,
                                        weight_k, absolute, mode):
    jl, tl = yi_layouts
    kw = dict(grad_k=grad_k, weight_k=weight_k, weight_absolute=absolute,
              mode=mode)
    want = j_comm_bytes(types.SimpleNamespace(layout=jl, n_workers=n_workers,
                                              tiers=None), JTC(**kw))
    got = t_comm_bytes(types.SimpleNamespace(layout=tl, n_workers=n_workers,
                                             tiers=None), TTC(**kw))
    assert got == want
    metas = jax.tree.leaves(j_leaf_meta(jl, n_workers),
                            is_leaf=lambda x: type(x).__name__ == "LeafMeta")
    assert got["shard_params"] == sum(m.numel for m in metas) == 6061035520
    if (grad_k, weight_k, n_workers, mode) == (6, 7, 1, "qadam"):
        print(f"yi-6b, one worker: exchange {got['update_exchange_bytes']} B,"
              f" broadcast {got['weight_broadcast_bytes']} B a step")


# ---------------------------------------------------------------------------
# K7 at the card kernel's chunk geometry: every lane width, views of x at
# float offsets 0-3, in place, rows whose payload bytes are no multiple of
# 16 (the card kernel's chunks hold 512 codes; tests/test_torch_cuda_kernels
# holds the kernel against these plain versions at the same cases)
# ---------------------------------------------------------------------------

CHUNK = 512
CHUNK_CS = [1, CHUNK - 1, CHUNK, CHUNK + 1, 1100]
# (kind, k, lane bits): the absolute uniform grid on every lane width, the
# log grid at k_g 1, 2 (3-bit lanes), 30 (6-bit) and 126 (8-bit)
EF_GEOMETRY = ([("uniform", k, b) for b, k in ((2, 1), (3, 2), (4, 3), (6, 5),
                                               (8, 7), (16, 15))]
               + [("log", k, None) for k in (1, 2, 30, 126)])


def _geometry_codecs(kind, k, bits):
    if kind == "log":
        return J.LogCodec(k_g=k), T.LogCodec(k_g=k)
    return (J.UniformCodec(k_x=k, absolute=True, wire_bits=bits),
            T.UniformCodec(k_x=k, absolute=True, wire_bits=bits))


def _view(x, off):
    """x copied into a buffer at ``off`` floats past its start."""
    buf = torch.full((x.size + 4,), float("nan"))
    view = buf[off:off + x.size]
    view.copy_(torch.from_numpy(x))
    return view


def _residual_gate(kind, k, x, je, te, level):
    """K7's residual x - level, the level rounded once (lut * s or
    (c / 2^k) * s) and then the difference: bitwise the reference's where
    the level is a power of two times s (the uniform grid, the log grid
    at k_g <= 8); at k_g 30 and 126 the reference's levels come from XLA's
    exp2 (``tests/test_torch_log_grid_deep.py``), so the product rounds
    and XLA on the CPU contracts x - level * s into an fma: there its
    residual is within one rounding of the product of the port's, and
    the port's is x - level bit for bit."""
    np.testing.assert_array_equal((x - level).view(np.int32),
                                  te.view(np.int32))
    if kind == "uniform" or k <= 8:
        np.testing.assert_array_equal(je.view(np.int32), te.view(np.int32))
    else:
        assert (np.abs(je - te) <= np.spacing(np.abs(level))).all()


@pytest.mark.parametrize("kind,k,bits", EF_GEOMETRY, ids=str)
@pytest.mark.parametrize("c", CHUNK_CS)
@pytest.mark.parametrize("n_rows", [1, 2, 3, 4, 5])
def test_encode_rows_ef_chunk_geometry(kind, k, bits, c, n_rows):
    """Payload rows bitwise the reference's and residuals as
    ``_residual_gate`` says, from x as a view at float offsets 0-3 of a
    larger buffer and with the residual written over that view
    (``out=x``)."""
    jc, tc = _geometry_codecs(kind, k, bits)
    assert tc.bits == jc.bits and tc.clip_abs == jc.clip_abs
    n = n_rows * c - (n_rows - 1 if c > 1 else 0)
    x, scale = _inputs(kind, n, seed=n_rows * 7000 + c + k)
    jp, je = J.encode_rows_ef(jnp.asarray(x), jnp.float32(scale), jc, n_rows,
                              backend="jnp")
    jp, je = np.asarray(jp), np.asarray(je)
    rows_c = -(-n // n_rows)
    assert jp.shape == (n_rows, tc.payload_nbytes(rows_c))
    level = T.decode_rows(torch.from_numpy(jp), torch.full((n_rows,), scale),
                          tc, rows_c).reshape(-1)[:n].numpy()
    for off in range(4):
        view = _view(x, off)
        tp, te = T.encode_rows_ef(view, torch.tensor(scale), tc, n_rows)
        np.testing.assert_array_equal(jp, tp.numpy())
        _residual_gate(kind, k, x, je, te.numpy(), level)
        tp, te = T.encode_rows_ef(view, torch.tensor(scale), tc, n_rows,
                                  out=view)
        assert te is view
        np.testing.assert_array_equal(jp, tp.numpy())
        _residual_gate(kind, k, x, je, view.numpy(), level)


@pytest.mark.parametrize("kind,k,bits", EF_GEOMETRY, ids=str)
def test_encode_rows_ef_zero_chunks(kind, k, bits):
    """All-zero input over a chunk and a half, three rows."""
    jc, tc = _geometry_codecs(kind, k, bits)
    x, scale = _inputs(kind, 3 * (CHUNK + CHUNK // 2), seed=0, zero=True)
    jp, je = J.encode_rows_ef(jnp.asarray(x), jnp.float32(scale), jc, 3,
                              backend="jnp")
    tp, te = T.encode_rows_ef(_view(x, 3), torch.tensor(scale), tc, 3)
    np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
    assert not te.any() and not np.asarray(je).any()
