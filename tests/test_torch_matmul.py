"""K1 dequant-matmul wrapper (plain version on the CPU) against the JAX
package's ``dequant_matmul`` on the same codes and activations, in both
orientations: ``x @ W`` (K1) and ``x @ W.T`` from code rows (K1t, the
tied logit head; ``transpose=True``).

Tiers: float32 activations within rtol 1e-5 / atol 1e-6 (summation
order); bf16 activations through the cast chain within one bf16 ulp
(plus a floor of K1_FLOOR sqrt(K) 2^-24 |x*w|_2 for sums that cancel to
near zero, as ``chip_smoke.py`` holds the kernel); dequantized weights
bitwise.
The JAX side runs ``backend="jnp"`` and ``backend="pallas"`` (interpret
mode off-TPU), as its own tests do.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.comm import bits as JB
from repro.comm import matmul as JM
from repro_torch.comm import bits as TB
from repro_torch.comm import matmul as TM

K1_FLOOR = 8.0

def _case(k_x, pack_bits, K, N, M, seed):
    rng = np.random.default_rng(seed)
    lim = 2 ** k_x
    codes = rng.integers(-lim, lim + 1, size=(K, N))
    codes = codes.astype(np.int16 if k_x > 6 else np.int8)
    if pack_bits:
        codes = np.array(JB.pack_rows(jnp.asarray(codes), pack_bits))
    x = rng.standard_normal((M, K)).astype(np.float32)
    return codes, np.float32(0.0312), x


CASES = [(6, 0), (7, 0), (2, 4), (3, 6), (1, 3), (4, 6)]


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("k_x,pack_bits", CASES)
def test_f32_matches_reference(backend, k_x, pack_bits):
    codes, s, x = _case(k_x, pack_bits, 64, 256, 3, seed=k_x)
    kw = dict(k_x=k_x, n=256, pack_bits=pack_bits, w_dtype="float32",
              cast_dtype="float32")
    ref = JM.dequant_matmul(jnp.asarray(x), jnp.asarray(codes), s,
                            backend=backend, **kw)
    out = TM.dequant_matmul(torch.from_numpy(x), torch.from_numpy(codes),
                            torch.tensor(s), **kw)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("k_x,pack_bits", CASES)
def test_bf16_cast_chain_within_one_ulp(k_x, pack_bits):
    codes, s, x = _case(k_x, pack_bits, 96, 128, 4, seed=10 + k_x)
    xb = x.astype(ml_dtypes.bfloat16)
    kw = dict(k_x=k_x, n=128, pack_bits=pack_bits, w_dtype="float32",
              cast_dtype="bfloat16")
    ref = np.asarray(JM.dequant_matmul(jnp.asarray(xb), jnp.asarray(codes),
                                       s, backend="jnp", **kw)).astype(np.float32)
    out = TM.dequant_matmul(torch.from_numpy(xb.astype(np.float32)).to(
        torch.bfloat16), torch.from_numpy(codes), torch.tensor(s), **kw)
    assert out.dtype == torch.bfloat16
    got = out.float().numpy()
    # one bf16 ulp, plus a floor at the scale of fp32 summation-order
    # noise (it matters only where the sum cancels to near zero)
    w = TM.dequant_codes(torch.from_numpy(codes), torch.tensor(s), k_x=k_x,
                         n=128, pack_bits=pack_bits, w_dtype="float32",
                         cast_dtype="bfloat16").float().numpy()
    norm = np.sqrt(xb.astype(np.float32) ** 2 @ w ** 2)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126))) - 7)
    floor = K1_FLOOR * np.sqrt(96) * 2.0 ** -24 * norm
    assert np.all(np.abs(got - ref) <= ulp + floor)


@pytest.mark.parametrize("k_x,pack_bits", CASES)
def test_dequantized_weight_bitwise(k_x, pack_bits):
    codes, s, _ = _case(k_x, pack_bits, 16, 40, 1, seed=20 + k_x)
    for cast in ("float32", "bfloat16"):
        ref = JM._dequant_codes(
            JB.unpack_rows(jnp.asarray(codes), pack_bits, 40) if pack_bits
            else jnp.asarray(codes), s, k_x=k_x, w_dtype="float32",
            cast_dtype=cast)
        out = TM.dequant_codes(torch.from_numpy(codes), torch.tensor(s),
                               k_x=k_x, n=40, pack_bits=pack_bits,
                               w_dtype="float32", cast_dtype=cast)
        np.testing.assert_array_equal(np.asarray(ref).astype(np.float32),
                                      out.float().numpy())


def test_ragged_shapes_and_leading_dims():
    codes, s, x = _case(6, 0, 33, 7, 10, seed=5)
    x3 = x.reshape(2, 5, 33)
    kw = dict(k_x=6, n=7)
    ref = JM.dequant_matmul(jnp.asarray(x3), jnp.asarray(codes), s, **kw)
    out = TM.dequant_matmul(torch.from_numpy(x3), torch.from_numpy(codes),
                            torch.tensor(s), **kw)
    assert out.shape == (2, 5, 7)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    assert TB.payload_nbytes(7, 4) == 4


def test_transpose_and_cuda_backend_refused_on_cpu():
    """transpose computes on the CPU through the plain version, without a
    launch; backend="cuda" on CPU tensors is refused in both
    orientations."""
    codes, s, x = _case(6, 0, 8, 8, 2, seed=1)
    args = (torch.from_numpy(x), torch.from_numpy(codes), torch.tensor(s))
    n0, t0 = TM.launches, TM.t_launches
    out = TM.dequant_matmul(*args, k_x=6, n=8, transpose=True)
    w = TM.dequant_codes(args[1], args[2], k_x=6, n=8, pack_bits=0,
                         w_dtype="float32", cast_dtype=None)
    torch.testing.assert_close(out, args[0] @ w.T, rtol=1e-6, atol=1e-7)
    for transpose in (False, True):
        with pytest.raises(ValueError):
            TM.dequant_matmul(*args, k_x=6, n=8, backend="cuda",
                              transpose=transpose)
    TM.dequant_matmul(*args, k_x=6, n=8)
    assert (TM.launches, TM.t_launches) == (n0, t0)   # CPU never launches


def _case_t(k_x, pack_bits, V, d, M, seed):
    """Code rows (V, d) (packed rows for pack_bits) and x (M, d)."""
    rng = np.random.default_rng(seed)
    codes, s, _ = _case(k_x, pack_bits, V, d, 1, seed)
    return codes, s, rng.standard_normal((M, d)).astype(np.float32)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("k_x,pack_bits", CASES)
def test_transpose_f32_matches_reference(backend, k_x, pack_bits):
    """K1t's plain version against the reference's transposed branch
    (pallas: _mm_t_body in interpret mode; 256 rows = two of its tiles)."""
    codes, s, x = _case_t(k_x, pack_bits, 256, 96, 3, seed=30 + k_x)
    kw = dict(k_x=k_x, n=96, pack_bits=pack_bits, w_dtype="float32",
              cast_dtype="float32", transpose=True)
    ref = JM.dequant_matmul(jnp.asarray(x), jnp.asarray(codes), s,
                            backend=backend, **kw)
    out = TM.dequant_matmul(torch.from_numpy(x), torch.from_numpy(codes),
                            torch.tensor(s), **kw)
    assert out.dtype == torch.float32 and out.shape == (3, 256)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("k_x,pack_bits", CASES)
def test_transpose_bf16_cast_chain_within_one_ulp(k_x, pack_bits):
    codes, s, x = _case_t(k_x, pack_bits, 128, 80, 4, seed=40 + k_x)
    xb = x.astype(ml_dtypes.bfloat16)
    kw = dict(k_x=k_x, n=80, pack_bits=pack_bits, w_dtype="float32",
              cast_dtype="bfloat16", transpose=True)
    ref = np.asarray(JM.dequant_matmul(jnp.asarray(xb), jnp.asarray(codes),
                                       s, backend="jnp", **kw)).astype(np.float32)
    out = TM.dequant_matmul(torch.from_numpy(xb.astype(np.float32)).to(
        torch.bfloat16), torch.from_numpy(codes), torch.tensor(s), **kw)
    assert out.dtype == torch.bfloat16
    w = TM.dequant_codes(torch.from_numpy(codes), torch.tensor(s), k_x=k_x,
                         n=80, pack_bits=pack_bits, w_dtype="float32",
                         cast_dtype="bfloat16").float().numpy()
    norm = np.sqrt(xb.astype(np.float32) ** 2 @ (w ** 2).T)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126))) - 7)
    floor = K1_FLOOR * np.sqrt(80) * 2.0 ** -24 * norm
    assert np.all(np.abs(out.float().numpy() - ref) <= ulp + floor)


@pytest.mark.parametrize("k_x,pack_bits", [(6, 0), (2, 4), (1, 3)])
def test_transpose_ragged_rows_and_leading_dims(k_x, pack_bits):
    """V = 200 rows (no multiple of the reference's 128-row tile, which
    its Pallas path refuses and its jnp path takes) and d = 37 (a ragged
    last packing group), with leading dims on x."""
    codes, s, x = _case_t(k_x, pack_bits, 200, 37, 6, seed=50 + k_x)
    x3 = x.reshape(2, 3, 37)
    kw = dict(k_x=k_x, n=37, pack_bits=pack_bits, transpose=True)
    for backend in ("jnp", "pallas"):
        ref = JM.dequant_matmul(jnp.asarray(x3), jnp.asarray(codes), s,
                                backend=backend, **kw)
        out = TM.dequant_matmul(torch.from_numpy(x3), torch.from_numpy(codes),
                                torch.tensor(s), **kw)
        assert out.shape == (2, 3, 200)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# the tensor-core route's host side: route choice and launch plan
# ---------------------------------------------------------------------------

PLAN_SHAPES = [(1, 4096, 11008), (4, 4096, 512), (32, 4096, 11008),
               (32, 11008, 4096), (4, 4096, 64000), (64, 2304, 9216),
               (17, 300, 70), (33, 1000, 1001), (4, 11008, 64),
               (100, 5000, 300), (3, 37, 9), (16, 2304, 1024)]


TC_BITS = [2, 3, 4, 6, 8, 16]   # packed lanes, int8, int16


@pytest.mark.parametrize("code_bits", TC_BITS)
@pytest.mark.parametrize("M,K,N", PLAN_SHAPES)
def test_tc_plan_slices_cover_k_once_in_order(M, K, N, code_bits):
    plan = TM.k1_plan(M, K, N, code_bits)
    assert plan.slices[0][0] == 0 and plan.slices[-1][1] == K
    for (a0, a1), (b0, b1) in zip(plan.slices, plan.slices[1:]):
        assert a1 == b0                      # contiguous, in order
    assert all(k0 < k1 for k0, k1 in plan.slices)   # none empty
    assert plan.k_slice % TM.TC_SLICE_ROWS == 0
    assert len(plan.slices) == plan.grid[2] <= TM.TC_MAX_SLICES
    # every output column and row is in exactly one block of each slice
    assert plan.grid[0] == -(-N // plan.tile_n)
    assert plan.grid[1] == -(-M // plan.m_tile)
    assert plan.tile_n in TM.TC_TILE_N
    # one row tile up to 64 rows: each code byte read once per call
    assert (plan.grid[1] == 1) == (M <= TM.TC_TILE_M)


@pytest.mark.parametrize("code_bits", TC_BITS)
@pytest.mark.parametrize("M", [1, 4, 32])
def test_tc_plan_split_fills_the_card(M, code_bits):
    """K is split at N = 512, K = 4096 (yi's wk and wv) until every SM has
    a block, at every code width."""
    plan = TM.k1_plan(M, 4096, 512, code_bits)
    assert plan.grid[2] > 1 and plan.blocks >= TM.SMS


@pytest.mark.parametrize("code_bits", TC_BITS)
@pytest.mark.parametrize("M,K,N", PLAN_SHAPES)
def test_tc_plan_workspace_size(M, K, N, code_bits):
    plan = TM.k1_plan(M, K, N, code_bits)
    expect = plan.grid[2] * M * N if plan.grid[2] > 1 else 0
    assert plan.workspace == expect


def test_tc_plan_refuses_other_codes():
    for bits in (5, 32, 1, 0):
        with pytest.raises(ValueError):
            TM.k1_plan(4, 64, 64, bits)
    with pytest.raises(ValueError):
        TM.k1_plan(0, 64, 64, 8)


# the CUDA-core route's plan: the serving paths' float32 shapes (yi-6b's
# and gemma2-2b's projections at decode and chunk sizes), ragged ones, and
# M past one row tile
FMA_PLAN_SHAPES = PLAN_SHAPES + [
    (4, 4096, 4096), (32, 4096, 512), (4, 2304, 2048), (32, 2304, 1024),
    (4, 9216, 2304), (32, 2048, 2304), (1, 4096, 64000), (5, 1000, 1001),
    (9, 4095, 300), (64, 4096, 11008), (200, 300, 70), (1, 1, 1)]


@pytest.mark.parametrize("code_bits", TC_BITS)
@pytest.mark.parametrize("M,K,N", FMA_PLAN_SHAPES)
def test_fma_plan_slices_cover_k_once_in_order(M, K, N, code_bits):
    plan = TM.fma_plan(M, K, N, code_bits)
    assert plan.slices[0][0] == 0 and plan.slices[-1][1] == K
    for (a0, a1), (b0, b1) in zip(plan.slices, plan.slices[1:]):
        assert a1 == b0                      # contiguous, in order
    assert all(k0 < k1 for k0, k1 in plan.slices)   # none empty
    assert plan.k_slice % TM.FMA_SLICE_ROWS == 0
    assert len(plan.slices) == plan.grid[2] <= TM.FMA_MAX_SLICES
    # every output column and row is in exactly one block of each slice
    assert plan.grid[0] == -(-N // TM.FMA_TILE_N)
    assert plan.grid[1] == -(-M // plan.m_tile)
    assert plan.m_tile in TM.FMA_M_TILES
    # the staged x of a slice fits the block's shared memory
    assert plan.m_tile * plan.k_slice <= TM.FMA_X_FLOATS


@pytest.mark.parametrize("code_bits", TC_BITS)
@pytest.mark.parametrize("M", [1, 2, 4, 5, 8, 9, 16, 17, 32, 33, 64, 100])
def test_fma_plan_reads_each_code_byte_once(M, code_bits):
    """One row tile of x for M <= 32 (each code byte read once a call),
    the narrowest that holds M; 32-row tiles past it."""
    plan = TM.fma_plan(M, 4096, 11008, code_bits)
    assert (plan.grid[1] == 1) == (M <= 32)
    assert plan.m_tile == min(t for t in TM.FMA_M_TILES if t >= min(M, 32))


@pytest.mark.parametrize("code_bits", TC_BITS)
@pytest.mark.parametrize("M", [1, 4, 32])
@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 512), (4096, 11008),
                                 (11008, 4096), (2304, 2048), (2304, 1024),
                                 (2304, 9216), (9216, 2304), (2048, 2304)])
def test_fma_plan_fills_the_card(M, K, N, code_bits):
    """At every float32 serving shape of yi-6b and gemma2-2b, K is split
    until every SM has a block."""
    plan = TM.fma_plan(M, K, N, code_bits)
    assert plan.blocks >= TM.SMS


def test_fma_plan_fills_the_card_where_k_allows():
    """Where K has too few 32-row units to give each SM a block, every
    unit is its own slice."""
    plan = TM.fma_plan(4, 64, 256, 8)
    assert plan.grid[2] == 2 and plan.k_slice == 32


@pytest.mark.parametrize("code_bits", TC_BITS)
@pytest.mark.parametrize("M,K,N", FMA_PLAN_SHAPES)
def test_fma_plan_workspace_size(M, K, N, code_bits):
    plan = TM.fma_plan(M, K, N, code_bits)
    expect = plan.grid[2] * M * N if plan.grid[2] > 1 else 0
    assert plan.workspace == expect


def test_fma_plan_refuses_bad_shapes():
    for bits in (5, 32, 1, 0):
        with pytest.raises(ValueError):
            TM.fma_plan(4, 64, 64, bits)
    for M, K, N in ((0, 64, 64), (4, 0, 64), (4, 64, 0), (-1, 64, 64)):
        with pytest.raises(ValueError):
            TM.fma_plan(M, K, N, 8)
    # more K than FMA_MAX_SLICES slices of staged x can hold
    with pytest.raises(ValueError):
        TM.fma_plan(32, TM.FMA_MAX_SLICES * TM.FMA_X_FLOATS // 32 + 32, 64, 8)




@pytest.mark.parametrize("x,codes,pack,w,cast,expect", [
    (torch.bfloat16, torch.int8, 0, "float32", "bfloat16", "tc"),
    (torch.bfloat16, torch.int16, 0, "float32", "bfloat16", "tc"),
    (torch.bfloat16, torch.int8, 0, "bfloat16", None, "tc"),
    (torch.bfloat16, torch.int8, 0, "bfloat16", "float32", "tc"),
    # packed lanes whose weight is a bf16 number: tensor cores
    (torch.bfloat16, torch.uint8, 4, "float32", "bfloat16", "tc"),
    (torch.bfloat16, torch.uint8, 2, "bfloat16", None, "tc"),
    (torch.bfloat16, torch.uint8, 3, "float32", "bfloat16", "tc"),
    (torch.bfloat16, torch.uint8, 6, "bfloat16", "float32", "tc"),
    # float32 weights or activations: CUDA cores (TF32 on tensor cores)
    (torch.bfloat16, torch.uint8, 4, "float32", None, "fma"),
    (torch.float32, torch.uint8, 4, "float32", None, "fma"),
    (torch.float32, torch.uint8, 6, "bfloat16", None, "fma"),
    (torch.bfloat16, torch.int8, 0, "float32", None, "fma"),
    (torch.float32, torch.int8, 0, "float32", None, "fma"),
    (torch.float32, torch.int16, 0, "bfloat16", None, "fma"),
])
def test_route_by_dtype_and_code_type(x, codes, pack, w, cast, expect):
    assert TM.route(x, codes, pack, w, cast) == expect


def test_tensor_core_route_refused_on_cpu():
    """bf16 activations against int8 codes (the tensor-core route) with
    backend="cuda" on CPU tensors raise; without a backend the plain
    version runs and no counter moves."""
    codes, s, x = _case(6, 0, 64, 96, 4, seed=3)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    args = (xb, torch.from_numpy(codes), torch.tensor(s))
    kw = dict(k_x=6, n=96, cast_dtype="bfloat16")
    counts = (TM.launches, TM.launches_tc, TM.launches_fma)
    with pytest.raises(ValueError):
        TM.dequant_matmul(*args, backend="cuda", **kw)
    out = TM.dequant_matmul(*args, **kw)
    assert out.dtype == torch.bfloat16 and out.shape == (4, 96)
    assert (TM.launches, TM.launches_tc, TM.launches_fma) == counts


@pytest.mark.parametrize("pack_bits,k_x", [(2, 0), (3, 1), (4, 2), (6, 4)])
def test_packed_tensor_core_route_refused_on_cpu(pack_bits, k_x):
    """bf16 activations against packed lanes (now the tensor-core route)
    with backend="cuda" on CPU tensors raise; without a backend the plain
    version runs, within one bf16 ulp plus the floor of the reference's
    product at a ragged N (a packed row of no whole 16 bytes), and no
    counter moves."""
    N = 1001
    codes, s, x = _case(k_x, pack_bits, 96, N, 5, seed=60 + pack_bits)
    xb = x.astype(ml_dtypes.bfloat16)
    assert codes.shape[1] == TB.payload_nbytes(N, pack_bits)
    args = (torch.from_numpy(xb.astype(np.float32)).to(torch.bfloat16),
            torch.from_numpy(codes), torch.tensor(s))
    kw = dict(k_x=k_x, n=N, pack_bits=pack_bits, cast_dtype="bfloat16")
    assert TM.route(args[0].dtype, args[1].dtype, pack_bits, "float32",
                    "bfloat16") == "tc"
    counts = (TM.launches, TM.launches_tc, TM.launches_tc_packed,
              TM.launches_fma)
    with pytest.raises(ValueError):
        TM.dequant_matmul(*args, backend="cuda", **kw)
    out = TM.dequant_matmul(*args, **kw)
    assert (TM.launches, TM.launches_tc, TM.launches_tc_packed,
            TM.launches_fma) == counts
    ref = np.asarray(JM.dequant_matmul(
        jnp.asarray(xb), jnp.asarray(codes), s, backend="jnp",
        w_dtype="float32", **kw)).astype(np.float32)
    w = TM.dequant_codes(args[1], args[2], k_x=k_x, n=N,
                         pack_bits=pack_bits, w_dtype="float32",
                         cast_dtype="bfloat16").float().numpy()
    norm = np.sqrt(xb.astype(np.float32) ** 2 @ w ** 2)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126))) - 7)
    floor = K1_FLOOR * np.sqrt(96) * 2.0 ** -24 * norm
    assert out.dtype == torch.bfloat16 and out.shape == (5, N)
    assert np.all(np.abs(out.float().numpy() - ref) <= ulp + floor)


# K1t (transpose=True) takes the same two routes, by the same rule, with
# counters of its own: t_launches_tc / t_launches_fma (t_launches both)
@pytest.mark.parametrize("x,codes,pack,w,cast,expect", [
    # bf16 activations against a bf16 weight: tensor cores, every code type
    (torch.bfloat16, torch.int8, 0, "float32", "bfloat16", "tc"),
    (torch.bfloat16, torch.int16, 0, "float32", "bfloat16", "tc"),
    (torch.bfloat16, torch.uint8, 2, "float32", "bfloat16", "tc"),
    (torch.bfloat16, torch.uint8, 3, "bfloat16", None, "tc"),
    (torch.bfloat16, torch.uint8, 4, "float32", "bfloat16", "tc"),
    (torch.bfloat16, torch.uint8, 6, "bfloat16", "float32", "tc"),
    # float32 activations or a float32 weight: CUDA cores
    (torch.float32, torch.int8, 0, "float32", None, "fma"),
    (torch.float32, torch.int16, 0, "bfloat16", None, "fma"),
    (torch.float32, torch.uint8, 4, "float32", "bfloat16", "fma"),
    (torch.bfloat16, torch.int8, 0, "float32", None, "fma"),
    (torch.bfloat16, torch.uint8, 3, "float32", "float32", "fma"),
    (torch.float32, torch.uint8, 6, "float32", None, "fma"),
])
def test_transposed_route_by_dtype_and_code_type(x, codes, pack, w, cast,
                                                 expect):
    assert TM.route(x, codes, pack, w, cast) == expect


def _t_counts():
    return (TM.t_launches, TM.t_launches_tc, TM.t_launches_fma,
            TM.launches)


@pytest.mark.parametrize("k_x,pack_bits", CASES)
def test_transposed_tensor_core_route_refused_on_cpu(k_x, pack_bits):
    """bf16 activations against code rows with a bf16 weight (K1t's
    tensor-core route) with backend="cuda" on CPU tensors raise, on every
    code type; without a backend the plain version runs, within one bf16
    ulp plus the floor of the reference's transposed product at a ragged
    V and d, and no counter moves."""
    V, d, M = 77, 37, 5
    codes, s, x = _case_t(k_x, pack_bits, V, d, M, seed=70 + k_x + pack_bits)
    xb = x.astype(ml_dtypes.bfloat16)
    args = (torch.from_numpy(xb.astype(np.float32)).to(torch.bfloat16),
            torch.from_numpy(codes), torch.tensor(s))
    kw = dict(k_x=k_x, n=d, pack_bits=pack_bits, cast_dtype="bfloat16",
              transpose=True)
    assert TM.route(args[0].dtype, args[1].dtype, pack_bits, "float32",
                    "bfloat16") == "tc"
    counts = _t_counts()
    with pytest.raises(ValueError):
        TM.dequant_matmul(*args, backend="cuda", **kw)
    out = TM.dequant_matmul(*args, **kw)
    assert _t_counts() == counts
    ref = np.asarray(JM.dequant_matmul(
        jnp.asarray(xb), jnp.asarray(codes), s, backend="jnp",
        w_dtype="float32", **kw)).astype(np.float32)
    w = TM.dequant_codes(args[1], args[2], k_x=k_x, n=d,
                         pack_bits=pack_bits, w_dtype="float32",
                         cast_dtype="bfloat16").float().numpy()
    norm = np.sqrt(xb.astype(np.float32) ** 2 @ (w ** 2).T)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126))) - 7)
    floor = K1_FLOOR * np.sqrt(d) * 2.0 ** -24 * norm
    assert out.dtype == torch.bfloat16 and out.shape == (M, V)
    assert np.all(np.abs(out.float().numpy() - ref) <= ulp + floor)


def test_transposed_fma_route_refused_on_cpu():
    """float32 activations (K1t's CUDA-core route): backend="cuda" on CPU
    tensors raises; the plain version runs without moving a counter."""
    codes, s, x = _case_t(6, 0, 40, 24, 3, seed=80)
    args = (torch.from_numpy(x), torch.from_numpy(codes), torch.tensor(s))
    assert TM.route(torch.float32, torch.int8, 0, "float32", None) == "fma"
    counts = _t_counts()
    with pytest.raises(ValueError):
        TM.dequant_matmul(*args, k_x=6, n=24, transpose=True, backend="cuda")
    out = TM.dequant_matmul(*args, k_x=6, n=24, transpose=True)
    assert out.dtype == torch.float32 and out.shape == (3, 40)
    assert _t_counts() == counts


@pytest.mark.parametrize("code_bits", [2, 3, 4, 6, 8, 16])
@pytest.mark.parametrize("M", [1, 2, 4, 5, 8, 33])
def test_t_fma_plan_row_tiles(M, code_bits):
    """K1t's CUDA-core row tile: 1 for one row, 4 up to four, else 8 (a
    grid row per 8), its staged x within a block's shared memory at
    gemma2's d (2304)."""
    tile = TM.t_fma_plan(M, 2304, code_bits)
    assert tile == (1 if M == 1 else 4 if M <= 4 else 8)
    assert TM.t_fma_smem(2304, code_bits, tile) <= TM.SMEM_BYTES


@pytest.mark.parametrize("M,d,bits,tile", [
    (8, 8000, 8, 4),       # 8 rows past shared memory: tiles of 4
    (8, 20000, 8, 1),      # and of 4: one row a tile
    (5, 20000, 16, 1), (2, 14000, 3, 4)])
def test_t_fma_plan_wide_rows(M, d, bits, tile):
    """Where the staged x of the wanted tile does not fit, a smaller tile
    (more passes over the codes); past one row's, a refusal that names
    the reason."""
    assert TM.t_fma_plan(M, d, bits) == tile
    assert TM.t_fma_smem(d, bits, tile) <= TM.SMEM_BYTES
    if tile < 8:
        bigger = {1: 4, 4: 8}[tile]
        assert TM.t_fma_smem(d, bits, bigger) > TM.SMEM_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        TM.t_fma_plan(1, 60000, 8)
