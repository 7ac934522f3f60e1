"""#9 lane pack/unpack, #10 log quantize and #13 ternary quantize: the
port's plain versions (what its wrappers run on the CPU, and what the
card's kernels are held against, bitwise, in ``chip_smoke.py`` and
``tests/test_torch_cuda_kernels.py``) against the JAX package.

Tiers, all bitwise:
  * #9 ``pack_rows``/``unpack_rows`` against ``pack_pallas``/
    ``unpack_pallas`` in interpret mode on the reference's tile shapes
    ((enc_rows, lanes_in) tiles), and against ``comm.bits.pack_rows``/
    ``unpack_rows`` at ragged (R, c); ``core.packing``'s flat
    ``pack_codes``/``unpack_codes`` and ``kernels.pack``'s
    ``pack4``/``unpack4`` against the reference's;
  * ``engine.quantize_log`` (K3 amax under the max(amax, 1e-30) floor,
    then #10) against the reference's ``backend="jnp"``, zero input
    included (the jnp path, not Pallas-interpret: XLA contracts the two
    differently, ROADMAP queue 3); ``log_quantize`` against
    ``log_quantize_pallas`` where XLA agrees;
  * ``engine.quantize_ternary`` (K3 amax under the where(amax > 0, amax,
    1) guard, then #13) with the reference's own ``jax.random.uniform``
    draws passed in as ``u``; ``ternary_quantize`` against
    ``ternary_quantize_pallas`` in interpret mode; u exactly at p, x = 0
    and a zero scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import bits as JB
from repro.comm import kernels as JK
from repro.core import packing as JP
from repro.kernels import pack as JKP
from repro.opt import engine as JE
from repro_torch.comm import kernels as K
from repro_torch.core import packing as TP
from repro_torch.kernels import pack as TKP
from repro_torch.opt import engine as TE

f32 = np.float32
BITS = (2, 3, 4, 6, 8, 16)


def _codes(rng, shape, bits):
    lo = -(2 ** (bits - 1)) if bits < 16 else -(2 ** 15)
    dt = np.int16 if bits == 16 else np.int8
    return rng.integers(lo, -lo, size=shape).astype(dt)


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                      a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bits", BITS)
def test_pack_rows_against_pallas_tiles(bits):
    rng = np.random.default_rng(bits)
    rows = 2 * JK.enc_rows()
    codes = _codes(rng, (rows, JK.lanes_in(bits)), bits)
    want = JK.pack_pallas(jnp.asarray(codes), bits, interpret=True)
    got = K.pack_rows(torch.from_numpy(codes), bits)
    _eq(want, got.numpy())
    back = JK.unpack_pallas(want, bits, interpret=True)
    _eq(back, K.unpack_rows(got, bits, codes.shape[1]).numpy())
    _eq(codes, back)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("R,c", [(1, 1), (2, 7), (4, 129), (3, 1001)])
def test_pack_rows_ragged_against_bits(bits, R, c):
    rng = np.random.default_rng(R * c + bits)
    codes = _codes(rng, (R, c), bits)
    want = JB.pack_rows(jnp.asarray(codes), bits)
    got = K.pack_rows(torch.from_numpy(codes), bits)
    _eq(want, got.numpy())
    _eq(JB.unpack_rows(want, bits, c),
        K.unpack_rows(got, bits, c).numpy())
    # int16 codes pack the same bytes
    _eq(want, K.pack_rows(torch.from_numpy(codes.astype(np.int16)),
                          bits).numpy())


@pytest.mark.parametrize("bits", BITS)
def test_pack_codes_flat(bits):
    rng = np.random.default_rng(100 + bits)
    codes = _codes(rng, (5, 13, 7), bits)
    want = JP.pack_codes(jnp.asarray(codes), bits)
    got = TP.pack_codes(torch.from_numpy(codes), bits)
    assert got.shape == (TP.packed_nbytes(codes.size, bits),)
    _eq(want, got.numpy())
    _eq(JP.unpack_codes(want, bits, codes.size),
        TP.unpack_codes(got, bits, codes.size).numpy())
    assert TP.SUPPORTED_BITS == JP.SUPPORTED_BITS


def test_pack4_against_pallas():
    rng = np.random.default_rng(4)
    codes = _codes(rng, (JKP.BLOCK_ROWS, 256), 4)
    want = JKP.pack4_pallas(jnp.asarray(codes), interpret=True)
    got = TKP.pack4(torch.from_numpy(codes))
    _eq(want, got.numpy())
    _eq(JKP.unpack4_pallas(want, interpret=True), TKP.unpack4(got).numpy())
    # an odd row length: the tail nibble is a zero code
    odd = TKP.pack4(torch.from_numpy(codes[:, :255]))
    _eq(JB.pack_rows(jnp.asarray(codes[:, :255]), 4), odd.numpy())
    _eq(np.pad(codes[:, :255], ((0, 0), (0, 1))), TKP.unpack4(odd).numpy())


def test_pack_wrappers_validate():
    with pytest.raises(ValueError, match="lane width"):
        K.pack_rows(torch.zeros((1, 4), dtype=torch.int8), 5)
    with pytest.raises(ValueError, match="int8/int16"):
        K.pack_rows(torch.zeros((1, 4)), 2)
    with pytest.raises(ValueError, match="int8/int16"):
        K.pack_rows(torch.zeros((1, 4), dtype=torch.int32), 2)
    with pytest.raises(ValueError, match="do not hold"):
        K.unpack_rows(torch.zeros((1, 3), dtype=torch.uint8), 2, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.pack_rows(torch.zeros((1, 4), dtype=torch.int8), 2,
                    backend="cuda")


# ---------------------------------------------------------------------------
# #10 log quantize
# ---------------------------------------------------------------------------

def _log_inputs():
    rng = np.random.default_rng(10)
    x = (rng.standard_normal((7, 301)) * 1e-3).astype(f32)
    x[0, :9] = 0.0
    yield "normal", x
    yield "zero", np.zeros((3, 130), f32)
    yield "tiny", np.full((2, 65), 1e-38, f32)


@pytest.mark.parametrize("k_g", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("case", ["normal", "zero", "tiny"])
def test_quantize_log_against_jnp(k_g, case):
    x = next(v for c, v in _log_inputs() if c == case)
    jc, js = JE.quantize_log(jnp.asarray(x), k_g, backend="jnp")
    tc, ts = TE.quantize_log(torch.from_numpy(x), k_g)
    _eq(np.float32(js), ts.numpy())
    _eq(jc, tc.numpy())
    if case == "zero":
        # the 1e-30 floor, not the zero guard 1 of amax_scale
        assert float(ts) == np.float32(1e-30)


@pytest.mark.parametrize("k_g", [2, 6])
def test_log_quantize_against_pallas(k_g):
    """#10's plain version against the TPU kernel in interpret mode on its
    (256, 128) tiles, at a scale where XLA's two evaluations agree."""
    rng = np.random.default_rng(k_g)
    x = (rng.standard_normal((JK.BLOCK_ROWS, JK.LANES)) * 0.5).astype(f32)
    s = f32(2.0)
    want = JK.log_quantize_pallas(jnp.asarray(x), jnp.float32(s), k_g,
                                  interpret=True)
    got = K.log_quantize(torch.from_numpy(x), torch.tensor(s), k_g)
    _eq(want, got.numpy())


# ---------------------------------------------------------------------------
# #13 ternary quantize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(513,), (4, 64, 33)])
@pytest.mark.parametrize("zero", [False, True])
def test_quantize_ternary_with_reference_draws(shape, zero):
    rng = np.random.default_rng(len(shape))
    x = np.zeros(shape, f32) if zero else rng.standard_normal(shape).astype(
        f32)
    key = jax.random.PRNGKey(3)
    jc, js = JE.quantize_ternary(jnp.asarray(x), key, backend="jnp")
    u = np.array(jax.random.uniform(key, shape))
    tc, ts = TE.quantize_ternary(torch.from_numpy(x), torch.from_numpy(u))
    _eq(np.float32(js), ts.numpy())
    _eq(jc, tc.numpy())
    if zero:
        assert float(ts) == 1.0 and not tc.any()


def test_ternary_quantize_against_pallas_and_edges():
    rng = np.random.default_rng(13)
    x = rng.standard_normal((JK.BLOCK_ROWS, JK.LANES)).astype(f32)
    s = f32(np.abs(x).max())
    p = np.abs(x) / s
    u = rng.random(x.shape, dtype=f32)
    u[0] = p[0]                    # u == p: code 0 (strict <)
    u[1] = np.nextafter(p[1], 0)   # just below p: sign(x)
    x[2, :7] = 0.0                 # x = 0: code 0 for any u
    u[2, :7] = 0.0
    want = JK.ternary_quantize_pallas(jnp.asarray(x), jnp.asarray(u),
                                      jnp.float32(s), interpret=True)
    got = K.ternary_quantize(torch.from_numpy(x), torch.from_numpy(u),
                             torch.tensor(s))
    _eq(want, got.numpy())
    assert not got[0].any() and not got[2, :7].any()
    np.testing.assert_array_equal(got[1].numpy(), np.sign(x[1]))
    # a zero scale divides by the 1e-30 floor: every nonzero x is sent
    z = K.ternary_quantize(torch.from_numpy(x), torch.from_numpy(u),
                           torch.tensor(0.0))
    _eq(JK.ternary_quantize_pallas(jnp.asarray(x), jnp.asarray(u),
                                   jnp.float32(0.0), interpret=True),
        z.numpy())
    np.testing.assert_array_equal(z.numpy(), np.sign(x).astype(np.int8))


def test_kernel_surfaces():
    """The reference's thin re-export modules have their counterparts,
    under PyTorch names (backend= for use_pallas= / interpret=)."""
    from repro_torch.kernels import ops, quantize, ref
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(1000).astype(f32))
    c, s = ops.quantize_log(x, 6)
    c2, s2 = TE.quantize_log(x, 6)
    assert torch.equal(c, c2) and torch.equal(s, s2)
    assert torch.equal(ops.dequantize_log(c, s, 6),
                       TE.dequantize_log(c, s, 6))
    c, s = ops.quantize_uniform(x, 7, absolute=False)
    assert torch.equal(ops.dequantize_uniform(c, s, 7),
                       TE.dequantize_uniform(c, s, 7))
    for name in ("amax_rows", "uniform_quantize_rows", "log_quantize",
                 "log_dequantize", "ternary_quantize", "blockwise_quantize",
                 "uniform_dequantize_rows"):
        assert getattr(quantize, name) is getattr(K, name)
    for name in ("adam_ef_moments", "adam_ef_quantize", "block_amax",
                 "log_quantize", "log_dequantize", "uniform_quantize",
                 "uniform_dequantize"):
        assert callable(getattr(ref, name))
    g, m, v, e = (torch.from_numpy(rng.standard_normal(64).astype(f32))
                  for _ in range(4))
    v = v * v
    out = ops.adam_ef_step(g, m.clone(), v.clone(), e.clone(), 1e-3, 0.99,
                           0.5, 1e-5, k_g=6)
    hp = TE.hyperparams(1e-3, 0.99, 0.5, 1e-5, "cpu")
    want = TE.adam_ef_step(g, m.clone(), v.clone(), e.clone(), hp, k_g=6)
    for a, b in zip(out, want):
        assert torch.equal(a, b)
