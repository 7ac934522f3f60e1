"""The single-tensor encodes of the port against the JAX package:
``Codec.encode``/``decode`` and ``WireBuffer`` for every codec (#5, or #8
for the blockwise codec; K6 on decode), and the blockwise sign grid (#14
``quantize_blockwise``, #8 ``BlockwiseCodec.encode``). The row encodes
and the tiers' reasons are in ``tests/test_torch_encode_rows.py``, whose
helpers and gates this file uses:

  * payloads, scales and decoded tensors bitwise (the reference's jnp
    branch, and for the one-scale codecs its fused Pallas encode in
    interpret mode);
  * blockwise sign codes and packed payloads bitwise, the per-block
    scales within BLOCK_SCALE_ULPS ulps of XLA's sum order, the port's
    fixed halving-tree order bitwise a numpy spelling of it;
  * a flipped sign code or a scale taken from the next block fails the
    blockwise gate.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import comm as J
from repro.opt import engine as JE
from repro_torch.comm import codec as T
from repro_torch.comm import kernels as TK
from repro_torch.opt import engine as TE
from test_torch_encode_rows import (_key_and_u, _ulps, _x, blockwise_gate,
                                    rows_gate)


# ---------------------------------------------------------------------------
# Codec.encode / decode and WireBuffer
# ---------------------------------------------------------------------------

SPECS = ["none", "log:2", "log:6", "log:8", "uniform:7", "uniform:3",
         "uniform_amax:7", "uniform_amax:6:wire", "uniform:7:wire",
         "uniform:6:w4", "terngrad", "blockwise:256", "blockwise:64"]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("shape", [(1,), (7, 3), (4099,), (3, 64, 17)])
def test_codec_encode_decode_bitwise(spec, shape):
    jc, tc = J.get_codec(spec), T.get_codec(spec)
    n = int(np.prod(shape))
    x = _x(n, n, "log").reshape(shape)
    key, u = _key_and_u(n, n)
    jwb = jc.encode(jnp.asarray(x), key=key, backend="jnp")
    twb = tc.encode(torch.from_numpy(x), u=torch.from_numpy(u))
    assert isinstance(twb, T.WireBuffer)
    assert (twb.spec, twb.shape, twb.numel, twb.bits, twb.nbytes) == \
        (jwb.spec, jwb.shape, jwb.numel, jwb.bits, jwb.nbytes)
    assert twb.nbytes == tc.wire_nbytes(n)
    np.testing.assert_array_equal(np.asarray(jwb.payload), twb.payload.numpy())
    if spec.startswith("blockwise"):
        assert blockwise_gate(jwb.payload, jwb.scale, twb.payload.numpy(),
                              twb.scale.numpy())
        # decode the reference's own buffer: bitwise
        jwb_t = T.WireBuffer(torch.from_numpy(np.array(jwb.payload)),
                             torch.from_numpy(np.array(jwb.scale)),
                             jwb.spec, jwb.shape)
    else:
        assert rows_gate((jwb.scale,), (twb.scale.numpy(),))
        jwb_t = twb
    jd = np.asarray(jc.decode(jwb, backend="jnp"))
    td = jwb_t.decode()
    assert tuple(td.shape) == shape and td.dtype == torch.float32
    assert rows_gate((jd,), (td.numpy(),))
    assert torch.equal(tc.decode(twb, out_dtype=torch.bfloat16),
                       twb.decode().to(torch.bfloat16))


def test_codec_encode_zero_and_pallas_backends():
    """Zero input through every one-scale codec, against the reference's
    fused Pallas encode (interpret mode) as well as its jnp branch."""
    for spec in ("log:6", "uniform_amax:7:wire", "uniform:3", "terngrad"):
        jc, tc = J.get_codec(spec), T.get_codec(spec)
        for zero in (False, True):
            x = _x(3001, 4, "log", zero=zero)
            key, u = _key_and_u(4, 3001)
            twb = tc.encode(torch.from_numpy(x), u=torch.from_numpy(u))
            for bk in ("jnp", "pallas"):
                jwb = jc.encode(jnp.asarray(x), key=key, backend=bk)
                assert rows_gate((jwb.payload, jwb.scale),
                                 (twb.payload.numpy(), twb.scale.numpy()))


# ---------------------------------------------------------------------------
# #14 quantize_blockwise and #8 BlockwiseCodec.encode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 255, 256, 257, 1001, 70001, 1000003])
def test_quantize_blockwise(n):
    x = _x(n, n, "log")
    x[::13] = 0.0
    jc, js = JE.quantize_blockwise(jnp.asarray(x), 256, backend="jnp")
    tc, ts = TE.quantize_blockwise(torch.from_numpy(x), 256)
    assert tuple(tc.shape) == (-(-n // 256), 256) and tc.dtype == torch.int8
    assert blockwise_gate(jc, js, tc.numpy(), ts.numpy())
    print(f"n={n}: block scales off XLA's by at most "
          f"{int(_ulps(js, ts.numpy()).max())} ulps "
          f"({float((np.asarray(js) != ts.numpy()).mean()):.1%} of blocks)")
    if n <= 70001:      # the reference's Pallas kernel, interpret mode
        pc, ps = JE.quantize_blockwise(jnp.asarray(x), 256,
                                       backend="pallas")
        assert blockwise_gate(pc, ps, tc.numpy(), ts.numpy())
    # the fixed order, spelled out in numpy float32: bitwise
    a = np.abs(np.pad(x, (0, tc.shape[0] * 256 - n)).reshape(-1, 256))
    while a.shape[1] > 1:
        h = a.shape[1] // 2
        a = a[:, :h] + a[:, h:]
    np.testing.assert_array_equal(a[:, 0] * np.float32(1 / 256), ts.numpy())


def order_ulps(block: int) -> int:
    """Ulps by which two float32 sums of the same ``block`` nonnegative
    terms in two orders can differ: the reference's XLA sum on the CPU
    (sequential for rows of 32, each partial sum within (block - 1) u of
    its exact value) against the port's halving tree (within log2(block)
    u), u = 2^-24 of the sum, which is under one ulp of it.
    BLOCK_SCALE_ULPS is the tier measured at blocks of 256; at 32 the
    two orders differ by 5 ulps on some inputs (tests below)."""
    return block - 1 + block.bit_length() - 1


def order_gate(want_codes, want_scales, got_codes, got_scales, block):
    """Codes (or packed payloads) bitwise, scales within
    ``order_ulps(block)``."""
    return (np.array_equal(np.asarray(want_codes), np.asarray(got_codes))
            and np.asarray(want_scales).shape == np.asarray(got_scales).shape
            and bool((_ulps(want_scales, got_scales)
                      <= order_ulps(block)).all()))


def _tree_scales(x, block):
    """The port's order, the halving tree, spelled out in numpy float32."""
    a = np.abs(np.pad(x, (0, -(-x.size // block) * block - x.size))
               .reshape(-1, block))
    while a.shape[1] > 1:
        h = a.shape[1] // 2
        a = a[:, :h] + a[:, h:]
    return a[:, 0] * np.float32(1 / block)


@pytest.mark.parametrize("block", [32, 64, 1024])
@pytest.mark.parametrize("n", [1, 31, 1000, 4099, 70001])
def test_quantize_blockwise_other_blocks(block, n):
    """#14's plain version at blocks other than 256 (the kernel takes every
    power of two): codes bitwise the reference's, scales bitwise the
    halving tree in numpy and within ``order_ulps`` of XLA's sum order;
    the reference's Pallas kernel (interpret mode) agrees."""
    x = _x(n, n + block, "log")
    x[::11] = 0.0
    jc, js = JE.quantize_blockwise(jnp.asarray(x), block, backend="jnp")
    tc, ts = TE.quantize_blockwise(torch.from_numpy(x), block)
    assert tuple(tc.shape) == (-(-n // block), block)
    np.testing.assert_array_equal(_tree_scales(x, block), ts.numpy())
    assert order_gate(jc, js, tc.numpy(), ts.numpy(), block)
    print(f"block {block}, n={n}: scales off XLA's by at most "
          f"{int(_ulps(js, ts.numpy()).max())} ulps")
    if n <= 4099:
        pc, ps = JE.quantize_blockwise(jnp.asarray(x), block,
                                       backend="pallas")
        assert order_gate(pc, ps, tc.numpy(), ts.numpy(), block)


@pytest.mark.parametrize("block", [32, 64, 1024])
@pytest.mark.parametrize("n", [1, 7, 4099, 70001])
def test_blockwise_encode_other_blocks(block, n):
    """#8's plain version at blocks other than 256 against the reference's
    ``BlockwiseCodec(block).encode``: payload bitwise, scales bitwise the
    halving tree and within ``order_ulps`` of the reference's."""
    jc = J.BlockwiseCodec(block=block)
    x = _x(n, n + 2 * block, "log")
    jp = jc.encode(jnp.asarray(x), backend="jnp")
    tp, ts = TK.blockwise_encode(torch.from_numpy(x), block)
    assert tp.shape == (T.BlockwiseCodec(block=block).payload_nbytes(n),)
    np.testing.assert_array_equal(_tree_scales(x, block), ts.numpy())
    assert order_gate(jp.payload, jp.scale, tp.numpy(), ts.numpy(), block)


@pytest.mark.parametrize("block", [32, 1024])
@pytest.mark.parametrize("fault", ["flipped code", "scale of the next block",
                                   "one element dropped"])
def test_order_gate_fails_on_planted_fault(block, fault):
    """The wider tier of other blocks still fails a flipped code, a scale
    taken from the next block, and a block sum missing one element."""
    x = _x(70001, 3, "log")
    jc, js = JE.quantize_blockwise(jnp.asarray(x), block, backend="jnp")
    tc, ts = TE.quantize_blockwise(torch.from_numpy(x), block)
    tc, ts = tc.numpy().copy(), ts.numpy().copy()
    assert order_gate(jc, js, tc, ts, block)
    if fault == "flipped code":
        i = np.flatnonzero(tc)[0]
        tc.reshape(-1)[i] = -tc.reshape(-1)[i]
    elif fault == "scale of the next block":
        ts = np.roll(ts, -1)
    else:
        y = x.copy()
        y[::block] = 0.0               # each block's first element
        ts = _tree_scales(y, block)
    assert not order_gate(jc, js, tc, ts, block)


@pytest.mark.parametrize("n", [1, 7, 256, 4099, 70001])
def test_blockwise_encode(n):
    jc, tc = J.BlockwiseCodec(), T.BlockwiseCodec()
    x = _x(n, n + 1, "log")
    jp = jc.encode(jnp.asarray(x), backend="jnp")
    tp, ts = TK.blockwise_encode(torch.from_numpy(x))
    assert tp.shape == (tc.payload_nbytes(n),)
    assert blockwise_gate(jp.payload, jp.scale, tp.numpy(), ts.numpy())
    jk = jc.encode(jnp.asarray(x), backend="pallas")   # #8, interpret mode
    assert blockwise_gate(jk.payload, jk.scale, tp.numpy(), ts.numpy())


@pytest.mark.parametrize("fault", ["flipped code", "scale of the next block"])
def test_blockwise_gate_fails_on_planted_fault(fault):
    x = _x(70001, 2, "log")
    jc, js = JE.quantize_blockwise(jnp.asarray(x), 256, backend="jnp")
    tc, ts = TE.quantize_blockwise(torch.from_numpy(x), 256)
    tc, ts = tc.numpy().copy(), ts.numpy().copy()
    assert blockwise_gate(jc, js, tc, ts)
    if fault == "flipped code":
        i = np.flatnonzero(tc)[0]
        tc.reshape(-1)[i] = -tc.reshape(-1)[i]
    else:
        ts = np.roll(ts, -1)
    assert not blockwise_gate(jc, js, tc, ts)


def test_codec_paths_outside_the_contract_raise():
    x = torch.ones(8)
    with pytest.raises(ValueError, match="stochastic"):
        T.TernaryCodec().encode(x)
    with pytest.raises(ValueError, match="stochastic"):
        T.encode_rows(x, T.TernaryCodec(), 2)
    with pytest.raises(NotImplementedError, match="blockwise_exchange"):
        T.encode_rows(x, T.BlockwiseCodec(), 2)
    with pytest.raises(ValueError, match="residual"):
        T.encode_rows_ef(x, torch.tensor(1.0), T.TernaryCodec(), 2)
    with pytest.raises(ValueError, match="power-of-two"):
        TK.blockwise_quantize(x, block=48)
