"""The codecs' code-level primitives (``compute_scale``, ``quantize``,
``dequantize``) of the port against the JAX package's, on the same numpy
input, and the names ``repro_torch.comm`` exports.

Tier: bitwise (scales, codes, dequantized values), every codec of the
registry: log (K3 amax, #10 codes, K11 decode on the card), uniform and
its wire lanes (K3, K4, K12), TernGrad (K3, #13 on the same uniforms),
blockwise sign and identity. The reference's primitives run its jnp
path, eagerly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comm as JC
from repro_torch import comm as TC

f32 = np.float32
SPECS = ("log:1", "log:2", "log:6", "log:8", "uniform:3", "uniform:7",
         "uniform_amax:5", "uniform:7:wire", "uniform_amax:7:wire",
         "terngrad", "identity")


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                  b.reshape(-1).view(np.uint8))


def _inputs():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((3, 50, 17)) * 0.3).astype(f32)
    x[0, :5] = 0.0
    u = rng.random(x.shape, dtype=f32)
    yield "normal", x, u
    yield "zero", np.zeros((4, 33), f32), rng.random((4, 33), dtype=f32)


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("case", ["normal", "zero"])
def test_scale_quantize_dequantize_bitwise(spec, case):
    x, u = next((x, u) for c, x, u in _inputs() if c == case)
    jc, tc = JC.get_codec(spec), TC.get_codec(spec)
    assert tc.spec == jc.spec and tc.bits == jc.bits
    js = jc.compute_scale(jnp.asarray(x))
    ts = tc.compute_scale(torch.from_numpy(x))
    _eq(np.float32(js), ts.numpy())
    kw = dict(u=jnp.asarray(u)) if jc.stochastic else {}
    jcodes = jc.quantize(jnp.asarray(x), js, **kw)
    kw = dict(u=torch.from_numpy(u)) if tc.stochastic else {}
    tcodes = tc.quantize(torch.from_numpy(x), ts, **kw)
    _eq(jcodes, tcodes.numpy())
    _eq(jc.dequantize(jcodes, js), tc.dequantize(tcodes, ts).numpy())
    if spec != "identity":
        # a scale given as a number, as the reference's callers may
        _eq(jc.quantize(jnp.asarray(x), 0.25, **({} if not jc.stochastic
                                                 else dict(u=u))),
            tc.quantize(torch.from_numpy(x), 0.25, **kw).numpy())


@pytest.mark.parametrize("case", ["normal", "zero"])
def test_blockwise_primitives_bitwise(case):
    x, _ = next((x, u) for c, x, u in _inputs() if c == case)
    jc, tc = JC.BlockwiseCodec(block=64), TC.BlockwiseCodec(block=64)
    with pytest.raises(NotImplementedError):
        jc.compute_scale(jnp.asarray(x))
    with pytest.raises(NotImplementedError, match="encode"):
        tc.compute_scale(torch.from_numpy(x))
    flat = x.reshape(-1)
    nb = -(-flat.size // 64)
    x2d = np.pad(flat, (0, nb * 64 - flat.size)).reshape(nb, 64)
    scale = np.abs(x2d).mean(-1).astype(f32)[:, None]
    jcodes = jc.quantize(jnp.asarray(x2d), None)
    tcodes = tc.quantize(torch.from_numpy(x2d), None)
    _eq(jcodes, tcodes.numpy())
    _eq(jc.dequantize(jcodes, jnp.asarray(scale)),
        tc.dequantize(tcodes, torch.from_numpy(scale)).numpy())


def test_ternary_needs_uniforms():
    with pytest.raises(ValueError, match="u="):
        TC.TernaryCodec().quantize(torch.ones(3), torch.tensor(1.0))


def test_log_quantize_decision_points():
    """y exactly at the zero threshold and at every midpoint goes up a
    level, in both packages (the scale a power of two: exact inputs)."""
    from repro.opt import grids as JG
    from repro_torch.opt import grids as TG
    for k_g in range(1, 9):
        t = np.asarray(TG.log_thresholds(k_g), f32)
        x = np.concatenate([t, -t, np.nextafter(t, 0), [0.0, 1.0, -1.0]])
        x = (x * f32(0.5)).astype(f32)
        jc, tc = JC.LogCodec(k_g=k_g), TC.LogCodec(k_g=k_g)
        _eq(jc.quantize(jnp.asarray(x), f32(0.5)),
            tc.quantize(torch.from_numpy(x), 0.5).numpy())
        _eq(JG.log_quantize(jnp.asarray(x), f32(0.5), k_g),
            tc.quantize(torch.from_numpy(x), 0.5).numpy())


def test_exports():
    from repro_torch.comm import (BACKENDS, CODEC_NAMES, SUPPORTED_BITS,
                                  Codec, get_codec)
    assert CODEC_NAMES == JC.CODEC_NAMES
    assert SUPPORTED_BITS == JC.SUPPORTED_BITS
    assert BACKENDS == ("torch", "cuda")
    for name in CODEC_NAMES:
        spec = {"log": "log:6", "uniform": "uniform:7",
                "uniform_amax": "uniform_amax:7",
                "blockwise": "blockwise:256"}.get(name, name)
        cd = get_codec(spec)
        assert isinstance(cd, Codec)
        assert cd.spec == JC.get_codec(spec).spec
        assert cd.name == JC.get_codec(spec).name
    for name in ("pack_rows", "unpack_rows", "packed_nbytes",
                 "payload_nbytes", "encode_rows", "encode_rows_ef",
                 "decode_rows", "WireBuffer", "uniform_wire_codec",
                 "resolve_backend"):
        assert hasattr(TC, name), name
    assert TC.packed_nbytes(1001, 3) == JC.packed_nbytes(1001, 3)
