"""The port's Q_x grid, lane packing and K3/K4 wrappers against the JAX
package on the same inputs.

Tier: bitwise (codes, scales, payload bytes, unpacked codes, dequantized
values). Inputs come from numpy seeds; the JAX
side runs as its own tests do (``backend="jnp"`` and ``"pallas"``,
interpret mode off-TPU).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import bits as JB
from repro.comm import codec as JC
from repro.opt import engine as JE
from repro.opt import grids as JG
from repro_torch.comm import bits as TB
from repro_torch.comm import codec as TC
from repro_torch.comm import kernels as TK
from repro_torch.opt import engine as TE
from repro_torch.opt import grids as TG


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _eq(a_jax, b_torch):
    a = np.asarray(a_jax)
    b = b_torch.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k_x", [1, 2, 4, 6, 7, 12])
def test_uniform_quantize_and_dequantize_bitwise(k_x):
    x = _x((64, 33), seed=k_x)
    x[0, :4] = [0.0, -0.0, 1e-38, -1e-38]
    s = np.float32(np.abs(x).max() * 0.7)      # some values clip
    _eq(JG.uniform_quantize(jnp.asarray(x), s, k_x),
        TG.uniform_quantize(torch.from_numpy(x), torch.tensor(s), k_x))
    codes = np.asarray(JG.uniform_quantize(jnp.asarray(x), s, k_x))
    _eq(JG.uniform_dequantize(jnp.asarray(codes), s, k_x),
        TG.uniform_dequantize(torch.from_numpy(codes.copy()),
                              torch.tensor(s), k_x))


@pytest.mark.parametrize("k_x,bits", [(2, 4), (3, 6), (1, 3), (6, 8)])
def test_uniform_dequant_table(k_x, bits):
    np.testing.assert_array_equal(JG.uniform_dequant_table(k_x, bits),
                                  TG.uniform_dequant_table(k_x, bits))


def test_block_amax_and_scale():
    x = _x((5, 7), 3)
    _eq(JG.block_amax(jnp.asarray(x)), TG.block_amax(torch.from_numpy(x)))
    _eq(JG.amax_scale(jnp.zeros((3,))), TG.amax_scale(torch.zeros(3)))


@pytest.mark.parametrize("bits", [2, 3, 4, 6, 8, 16])
@pytest.mark.parametrize("cols", [24, 37])
def test_pack_rows_bitwise(bits, cols):
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    codes = np.random.default_rng(bits).integers(lo, hi + 1, size=(5, cols))
    dt = np.int16 if bits == 16 else np.int8
    codes = codes.astype(dt)
    jp = JB.pack_rows(jnp.asarray(codes), bits)
    tp = TB.pack_rows(torch.from_numpy(codes), bits)
    _eq(jp, tp)
    assert tp.shape[1] == TB.payload_nbytes(cols, bits)
    _eq(JB.unpack_rows(jp, bits, cols), TB.unpack_rows(tp, bits, cols))
    flat = codes.reshape(-1)
    _eq(JB.pack_flat(jnp.asarray(flat), bits),
        TB.pack_flat(torch.from_numpy(flat), bits))


def test_pad_rows_and_accounting():
    x = _x((7, 5), 1)
    _eq(JB.pad_rows(jnp.asarray(x), 3), TB.pad_rows(torch.from_numpy(x), 3))
    for bits in (1, 2, 3, 4, 6, 8, 16, 32):
        for n in (0, 1, 7, 8, 1000):
            assert TB.payload_nbytes(n, bits) == JB.payload_nbytes(n, bits)
    for m in range(0, 32768, 997):
        assert TB.lane_bits_for(m) == JB.lane_bits_for(m)


@pytest.mark.parametrize("k_x", range(0, 15))
def test_uniform_codec_lane(k_x):
    for absolute in (True, False):
        a = JC.UniformCodec(k_x=k_x, absolute=absolute)
        b = TC.UniformCodec(k_x=k_x, absolute=absolute)
        assert (a.bits, a.clip_abs) == (b.bits, b.clip_abs)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("k_x", [2, 6, 7])
def test_quantize_uniform_bitwise(backend, k_x):
    """K3/K4 wrappers (plain versions here) vs the reference engine."""
    x = _x((3, 40, 24), seed=k_x, scale=0.02)
    jc, js = jax.vmap(lambda xl: JE.quantize_uniform(
        xl, k_x, absolute=False, backend=backend))(jnp.asarray(x))
    tc, ts = TE.quantize_uniform(torch.from_numpy(x), k_x, absolute=False,
                                 per_layer=True)
    _eq(jc, tc)
    _eq(js, ts)
    jc1, js1 = JE.quantize_uniform(jnp.asarray(x), k_x, absolute=False,
                                   backend=backend)
    tc1, ts1 = TE.quantize_uniform(torch.from_numpy(x), k_x, absolute=False)
    _eq(jc1, tc1)
    _eq(js1, ts1)
    ja, _ = JE.quantize_uniform(jnp.asarray(x), k_x, backend=backend)
    ta, _ = TE.quantize_uniform(torch.from_numpy(x), k_x)
    _eq(ja, ta)


def test_kernel_wrappers_rows():
    x = torch.from_numpy(_x((4, 50), 9))
    np.testing.assert_array_equal(TK.amax_rows(x).numpy(),
                                  np.abs(x.numpy()).max(axis=1))
    with pytest.raises(ValueError):
        TK.amax_rows(x.to(torch.float64))
    with pytest.raises(ValueError):
        TK.uniform_quantize_rows(x, torch.ones(3), 6)
