"""The fused row encodes of the port's wire against the JAX package: #5
``encode_rows`` (amax + quantize + pack, log / uniform / ternary) and
K6's ternary decode; the tiers and gates below also serve
``tests/test_torch_codec_encode.py`` (``Codec.encode``/``decode``,
``WireBuffer`` and the blockwise sign grid, #14 and #8).

Tiers. Inputs come from numpy seeds; the reference runs its jnp branch
(its Pallas kernels run the same functions in interpret mode), the port
its plain versions (the CPU side of the kernels; the card tests hold the
kernels against these bitwise):

  * #5 payload rows and scales, K6 decoded rows, ``Codec`` payloads,
    scales and decoded tensors: bitwise, over n_rows in {1, 2, 4}, chunk
    lengths {1, 7, 4099} (the last row short by n_rows - 1 elements), the
    log grid at k_g {2, 4, 6, 8}, the uniform wire at k_x {3, 6, 7} with
    the absolute and the amax scale, TernGrad fed the reference's own
    uniforms (``jax.random.uniform(key, (n,))``), and zero input;
  * blockwise sign codes and packed payloads: bitwise; the per-block
    scales within BLOCK_SCALE_ULPS ulps: the port sums each block's |x|
    in one fixed halving-tree order (the kernel's), XLA in its own
    (measured: at most 3 ulps over the inputs here, about half the
    blocks off by one or more).

A planted fault (a flipped sign code, a scale taken from the next row or
block) fails each gate.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comm as J
from repro_torch.comm import codec as T

BLOCK_SCALE_ULPS = 4
CHUNKS = (1, 7, 4099)


def _codec_pair(kind, k=None, absolute=True):
    if kind == "log":
        return J.LogCodec(k_g=k), T.LogCodec(k_g=k)
    if kind == "uniform":
        return (J.uniform_wire_codec(k, absolute),
                T.uniform_wire_codec(k, absolute))
    return J.TernaryCodec(), T.TernaryCodec()


CODECS = ([("log", k, True) for k in (2, 4, 6, 8)]
          + [("uniform", k, a) for k in (3, 6, 7) for a in (True, False)]
          + [("ternary", None, True)])


def _x(n, seed, kind, zero=False):
    rng = np.random.default_rng(seed)
    if zero:
        return np.zeros(n, np.float32)
    scale = 0.3 if kind == "uniform" else rng.choice([1e-3, 1.0, 30.0])
    return (rng.standard_normal(n) * scale).astype(np.float32)


def _key_and_u(seed, n):
    """The reference's key and the uniforms it draws from it over the
    flat x (``Codec._draw``), as numpy."""
    key = jax.random.PRNGKey(seed)
    return key, np.array(jax.random.uniform(key, (n,)))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def rows_gate(want, got) -> bool:
    """The bitwise gate of payload rows, scales and decoded values."""
    return all(np.array_equal(_bits(w), _bits(g)) for w, g in zip(want, got))


def blockwise_gate(want_codes, want_scales, got_codes, got_scales) -> bool:
    """Codes (or packed payloads) bitwise, scales within
    BLOCK_SCALE_ULPS ulps."""
    return (np.array_equal(np.asarray(want_codes), np.asarray(got_codes))
            and np.asarray(want_scales).shape == np.asarray(got_scales).shape
            and bool((_ulps(want_scales, got_scales)
                      <= BLOCK_SCALE_ULPS).all()))


# ---------------------------------------------------------------------------
# #5 encode_rows and K6 decode_rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,k,absolute", CODECS, ids=str)
@pytest.mark.parametrize("c", CHUNKS)
@pytest.mark.parametrize("n_rows", [1, 2, 4])
def test_encode_rows_bitwise(kind, k, absolute, c, n_rows):
    jc, tc = _codec_pair(kind, k, absolute)
    assert (tc.spec, tc.bits, tc.kind, tc.clip_abs, tc.static_scale) == \
        (jc.spec, jc.bits, jc.kind, jc.clip_abs, jc.static_scale)
    n = n_rows * c - (n_rows - 1)
    seed = n_rows * 1000 + c + (k or 0)
    x = _x(n, seed, kind)
    key, u = _key_and_u(seed, n)
    jp, js = J.encode_rows(jnp.asarray(x), jc, n_rows, key=key,
                           backend="jnp")
    tp, ts = T.encode_rows(torch.from_numpy(x), tc, n_rows,
                           u=torch.from_numpy(u))
    assert tuple(tp.shape) == (n_rows, tc.payload_nbytes(c))
    assert tp.dtype == torch.uint8 and ts.shape == () and \
        ts.dtype == torch.float32
    assert rows_gate((jp, js), (tp.numpy(), ts.numpy()))
    # decode with a distinct scale per source row (K6; ternary: c * s)
    scales = (np.random.default_rng(c).uniform(0.5, 2.0, n_rows)
              * np.asarray(js)).astype(np.float32)
    jd = J.decode_rows(jp, jnp.asarray(scales), jc, c, backend="jnp")
    td = T.decode_rows(tp, torch.from_numpy(scales), tc, c)
    assert tuple(td.shape) == (n_rows, c)
    assert rows_gate((jd,), (td.numpy(),))


@pytest.mark.parametrize("kind,k,absolute", CODECS, ids=str)
def test_encode_rows_zero_input(kind, k, absolute):
    jc, tc = _codec_pair(kind, k, absolute)
    x = _x(1001, 0, kind, zero=True)
    key, u = _key_and_u(5, 1001)
    jp, js = J.encode_rows(jnp.asarray(x), jc, 2, key=key, backend="jnp")
    tp, ts = T.encode_rows(torch.from_numpy(x), tc, 2, u=torch.from_numpy(u))
    assert rows_gate((jp, js), (tp.numpy(), ts.numpy()))
    if tc.static_scale is None:
        assert float(ts) == 1.0          # the zero guard
    np.testing.assert_array_equal(
        np.asarray(J.decode_rows(jp, jnp.ones(2), jc, 501, backend="jnp")),
        T.decode_rows(tp, torch.ones(2), tc, 501).numpy())


def test_ternary_decode_rows_bitwise():
    """K6's ternary kind against ``decode_rows`` on codes from every lane
    value (-2 never comes out of the quantizer; it decodes all the
    same)."""
    jc, tc = J.TernaryCodec(), T.TernaryCodec()
    rng = np.random.default_rng(9)
    for n_rows, c in ((1, 1), (2, 7), (4, 4099), (3, 1000003)):
        payload = rng.integers(0, 256, (n_rows, tc.payload_nbytes(c)),
                               dtype=np.uint8)
        scales = rng.uniform(1e-3, 30.0, n_rows).astype(np.float32)
        jd = J.decode_rows(jnp.asarray(payload), jnp.asarray(scales), jc, c,
                           backend="jnp")
        td = T.decode_rows(torch.from_numpy(payload),
                           torch.from_numpy(scales), tc, c)
        assert rows_gate((jd,), (td.numpy(),))


@pytest.mark.parametrize("fault", ["flipped code", "scale of the next row"])
def test_rows_gate_fails_on_planted_fault(fault):
    jc, tc = _codec_pair("ternary")
    n, n_rows = 4099, 4
    x = _x(n, 3, "ternary")
    key, u = _key_and_u(3, n)
    jp, js = J.encode_rows(jnp.asarray(x), jc, n_rows, key=key,
                           backend="jnp")
    tp, ts = T.encode_rows(torch.from_numpy(x), tc, n_rows,
                           u=torch.from_numpy(u))
    c = -(-n // n_rows)
    scales = np.asarray([1.0, 2.0, 3.0, 4.0], np.float32)
    jd = J.decode_rows(jp, jnp.asarray(scales), jc, c, backend="jnp")
    if fault == "flipped code":
        codes = T.decode_rows(tp, torch.ones(n_rows), tc, c)
        j = int(torch.nonzero(codes.reshape(-1))[0])
        flat = codes.reshape(-1).to(torch.int8)
        flat[j] = -flat[j]
        from repro_torch.comm import bits as TB
        tp = TB.pack_rows(flat.reshape(n_rows, c), tc.bits)
        assert not rows_gate((jp,), (tp.numpy(),))
        td = T.decode_rows(tp, torch.from_numpy(scales), tc, c)
    else:
        td = T.decode_rows(tp, torch.from_numpy(np.roll(scales, -1)), tc, c)
    assert not rows_gate((jd,), (td.numpy(),))


# ---------------------------------------------------------------------------
# #5 at the card kernel's chunk geometry: every lane width and kind, x (and
# the ternary kind's u) as views at float offsets 0-3, rows whose payload
# bytes are no multiple of 16 (the card kernel's chunks hold 512 codes;
# tests/test_torch_cuda_kernels.py holds the kernel against these plain
# versions at the same cases)
# ---------------------------------------------------------------------------

CHUNK = 512
CHUNK_CS = (1, CHUNK - 1, CHUNK, CHUNK + 1, 1100)
GEOMETRY = ([("uniform", k, True, b) for b, k in ((2, 1), (3, 2), (4, 3),
                                                  (6, 5), (8, 7), (16, 15))]
            + [("uniform", 7, False, 8), ("uniform", 14, False, 16)]
            + [("log", k, True, None) for k in (1, 2, 30, 126)]
            + [("ternary", None, True, None)])


def _geometry_pair(kind, k, absolute, bits):
    if kind == "uniform":
        return (J.UniformCodec(k_x=k, absolute=absolute, wire_bits=bits),
                T.UniformCodec(k_x=k, absolute=absolute, wire_bits=bits))
    return _codec_pair(kind, k, absolute)


def _view(a, off):
    buf = torch.full((a.size + 4,), float("nan"))
    view = buf[off:off + a.size]
    view.copy_(torch.from_numpy(a))
    return view


@pytest.mark.parametrize("kind,k,absolute,bits", GEOMETRY, ids=str)
@pytest.mark.parametrize("c", CHUNK_CS)
@pytest.mark.parametrize("n_rows", [1, 2, 3, 4, 5])
def test_encode_rows_chunk_geometry(kind, k, absolute, bits, c, n_rows):
    """Payload rows and scales bitwise the reference's, from x (and u) as
    views at float offsets 0-3 of larger buffers."""
    jc, tc = _geometry_pair(kind, k, absolute, bits)
    assert (tc.spec, tc.bits, tc.clip_abs, tc.static_scale) == \
        (jc.spec, jc.bits, jc.clip_abs, jc.static_scale)
    n = n_rows * c - (n_rows - 1 if c > 1 else 0)
    seed = n_rows * 7000 + c + (k or 0)
    x = _x(n, seed, kind)
    key, u = _key_and_u(seed, n)
    jp, js = J.encode_rows(jnp.asarray(x), jc, n_rows, key=key,
                           backend="jnp")
    assert np.asarray(jp).shape == (n_rows, tc.payload_nbytes(-(-n // n_rows)))
    for off in range(4):
        tp, ts = T.encode_rows(_view(x, off), tc, n_rows,
                               u=_view(u, 3 - off))
        assert rows_gate((jp, js), (tp.numpy(), ts.numpy()))


@pytest.mark.parametrize("kind,k,absolute,bits", GEOMETRY, ids=str)
def test_encode_rows_zero_chunks(kind, k, absolute, bits):
    """All-zero input over a chunk and a half, three rows (the zero
    guard's scale 1 for the amax kinds)."""
    jc, tc = _geometry_pair(kind, k, absolute, bits)
    n = 3 * (CHUNK + CHUNK // 2)
    x = np.zeros(n, np.float32)
    key, u = _key_and_u(7, n)
    jp, js = J.encode_rows(jnp.asarray(x), jc, 3, key=key, backend="jnp")
    tp, ts = T.encode_rows(_view(x, 1), tc, 3, u=_view(u, 2))
    assert rows_gate((jp, js), (tp.numpy(), ts.numpy()))
