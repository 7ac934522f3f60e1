"""The quantization operators of ``repro_torch.core.quantizers`` against
the JAX package's ``repro.core.quantizers``: every operator, every
functional encode/decode, ``log_bits``, ``wire_bits``, ``codec``,
``QTensor.nbytes_wire`` and ``get_quantizer``'s grammar.

Tiers: bitwise for codes, scales and decoded values (TernGrad with the
reference's own ``jax.random.uniform(key, shape)`` draws passed in as
``u``), except the blockwise per-block scale, which the port sums in one
fixed halving tree (#14's order): within 4 ulps of XLA's mean (the
reference's own sum order, ROADMAP queue 3), and its decoded values with
it; byte counts exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantizers as JQ
from repro_torch.core import quantizers as TQ

f32 = np.float32
KEY = jax.random.PRNGKey(11)
SPECS = ("none", "log:1", "log:2", "log:6", "uniform:3", "uniform:7",
         "uniform_amax:5", "uniform_amax:7", "terngrad", "blockwise:256",
         "blockwise:64")


def _x(shape=(6, 40, 33), seed=0):
    x = (np.random.default_rng(seed).standard_normal(shape) * 0.05).astype(
        f32)
    x.reshape(-1)[:11] = 0.0
    return x


def _u(shape):
    return torch.from_numpy(np.array(jax.random.uniform(KEY, shape)))


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                      a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def _ulps(a, b):
    a, b = np.asarray(a, f32), np.asarray(b, f32)
    return float((np.abs(a - b) / np.spacing(np.maximum(np.abs(a),
                                                        np.abs(b)))).max())


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("zero", [False, True])
def test_operators(spec, zero):
    x = np.zeros((5, 77), f32) if zero else _x()
    jq, tq = JQ.get_quantizer(spec), TQ.get_quantizer(spec)
    assert type(tq).__name__ == type(jq).__name__
    assert tq.wire_bits == jq.wire_bits
    assert tq.codec.spec == jq.codec.spec and tq.codec.bits == jq.codec.bits
    stochastic = spec == "terngrad"
    jqt = jq.encode(jnp.asarray(x), key=KEY if stochastic else None)
    tqt = tq.encode(torch.from_numpy(x),
                    u=_u(x.shape) if stochastic else None)
    assert (tqt.kind, tqt.bits, tqt.shape) == (jqt.kind, jqt.bits,
                                               jqt.shape)
    assert tqt.nbytes_wire == jqt.nbytes_wire
    _eq(jqt.codes, tqt.codes.numpy())
    want = np.asarray(jq(jnp.asarray(x), key=KEY if stochastic else None))
    got = tq(torch.from_numpy(x), u=_u(x.shape) if stochastic else None)
    if spec.startswith("blockwise"):
        assert _ulps(jqt.scale, tqt.scale.numpy()) <= 4
        assert _ulps(want, got.numpy()) <= 4
        assert got.shape == x.shape
    else:
        _eq(np.float32(jqt.scale), tqt.scale.numpy())
        _eq(want, got.numpy())


@pytest.mark.parametrize("k_g", [1, 2, 6])
def test_log_encode_decode(k_g):
    x = _x(seed=k_g)
    jq, tq = JQ.log_encode(jnp.asarray(x), k_g), TQ.log_encode(
        torch.from_numpy(x), k_g)
    _eq(jq.codes, tq.codes.numpy())
    _eq(np.float32(jq.scale), tq.scale.numpy())
    assert (tq.kind, tq.bits) == (jq.kind, jq.bits) == ("log",
                                                         JQ.log_bits(k_g))
    _eq(JQ.log_decode(jq, k_g), TQ.log_decode(tq, k_g).numpy())


@pytest.mark.parametrize("k_x,absolute", [(3, True), (7, True), (5, False),
                                          (7, False)])
def test_uniform_encode_decode(k_x, absolute):
    x = _x(seed=k_x) * 8.0      # past the absolute grid's +/-0.5 too
    jq = JQ.uniform_encode(jnp.asarray(x), k_x, absolute)
    tq = TQ.uniform_encode(torch.from_numpy(x), k_x, absolute)
    _eq(jq.codes, tq.codes.numpy())
    _eq(np.float32(jq.scale), tq.scale.numpy())
    assert (tq.kind, tq.bits, tq.nbytes_wire) == (jq.kind, jq.bits,
                                                  jq.nbytes_wire)
    _eq(JQ.uniform_decode(jq, k_x), TQ.uniform_decode(tq, k_x).numpy())


def test_ternary_encode_decode():
    x = _x(seed=3)
    jq = JQ.ternary_encode(jnp.asarray(x), KEY)
    tq = TQ.ternary_encode(torch.from_numpy(x), u=_u(x.shape))
    _eq(jq.codes, tq.codes.numpy())
    _eq(np.float32(jq.scale), tq.scale.numpy())
    assert (tq.kind, tq.bits, tq.nbytes_wire) == (jq.kind, jq.bits,
                                                  jq.nbytes_wire)
    _eq(JQ.ternary_decode(jq), TQ.ternary_decode(tq).numpy())
    # from a generator: codes in {-1, 0, 1}, reproducible by its seed
    a = TQ.TernGradQuantizer().encode(
        torch.from_numpy(x), generator=torch.Generator().manual_seed(5))
    b = TQ.TernGradQuantizer().encode(
        torch.from_numpy(x), generator=torch.Generator().manual_seed(5))
    assert torch.equal(a.codes, b.codes)
    assert set(a.codes.unique().tolist()) <= {-1, 0, 1}


def test_terngrad_needs_uniforms():
    """As the reference asserts on its key, the port's stochastic operator
    refuses to run without uniforms or a generator."""
    with pytest.raises(AssertionError):
        JQ.TernGradQuantizer().encode(jnp.ones(4))
    for call in (lambda q: q.encode(torch.ones(4)),
                 lambda q: q(torch.ones(4))):
        with pytest.raises(ValueError, match="u= or generator="):
            call(TQ.TernGradQuantizer())


@pytest.mark.parametrize("n,block", [(1, 256), (255, 256), (257, 256),
                                     (4099, 256), (1000, 64)])
def test_blockwise_encode_decode(n, block):
    x = _x((n,), seed=n)
    jq = JQ.blockwise_encode(jnp.asarray(x), block)
    tq = TQ.blockwise_encode(torch.from_numpy(x), block)
    _eq(jq.codes, tq.codes.numpy())
    assert _ulps(jq.scale, tq.scale.numpy()) <= 4
    assert (tq.kind, tq.bits, tq.shape, tq.nbytes_wire) == (
        jq.kind, jq.bits, jq.shape, jq.nbytes_wire)
    want, got = JQ.blockwise_decode(jq), TQ.blockwise_decode(tq)
    assert got.shape == want.shape == (n,)
    assert _ulps(want, got.numpy()) <= 4


def test_log_bits_and_wire_bits():
    for k in range(0, 31):
        assert TQ.log_bits(k) == JQ.log_bits(k)
        assert TQ.LogGradQuantizer(k).wire_bits == \
            JQ.LogGradQuantizer(k).wire_bits
    for b in (64, 128, 256, 1024):
        assert TQ.BlockwiseQuantizer(b).wire_bits == \
            JQ.BlockwiseQuantizer(b).wire_bits
    assert TQ.IdentityQuantizer().wire_bits == 32.0
    assert TQ.TernGradQuantizer().wire_bits == 2.0


def test_identity_encode():
    x = torch.from_numpy(_x())
    qt = TQ.IdentityQuantizer().encode(x)
    jt = JQ.IdentityQuantizer().encode(jnp.asarray(x.numpy()))
    assert qt.codes is x and float(qt.scale) == 1.0
    assert (qt.kind, qt.bits, qt.shape, qt.nbytes_wire) == (
        jt.kind, jt.bits, jt.shape, jt.nbytes_wire)
    assert TQ.IdentityQuantizer()(x) is x


@pytest.mark.parametrize("spec", ["", "log", "log:3", "uniform", "uniform:5",
                                  "uniform_amax", "uniform_amax:4",
                                  "terngrad", "blockwise", "blockwise:128",
                                  None, "none", "identity", "fp32"])
def test_grammar(spec):
    jq, tq = JQ.get_quantizer(spec or None), TQ.get_quantizer(spec or None)
    assert type(tq).__name__ == type(jq).__name__
    fields = [f for f in ("k_g", "k_x", "absolute", "block", "name")
              if hasattr(jq, f)]
    assert {f: getattr(tq, f) for f in fields} == \
        {f: getattr(jq, f) for f in fields}


@pytest.mark.parametrize("bad", ["uniformx:3", "ternary", "blockwise256",
                                 "lg:6"])
def test_unknown_spec_raises_value_error(bad):
    with pytest.raises(ValueError):
        JQ.get_quantizer(bad)
    with pytest.raises(ValueError, match="unknown quantizer spec"):
        TQ.get_quantizer(bad)
