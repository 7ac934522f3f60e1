"""The port's log grid Q_g, Adam+EF leaf math and their kernel wrappers
(K11, K15, K16: plain versions here) against the JAX package on the same
numpy-seeded inputs.

Tiers:
  * bitwise: log-grid codes (zeros, negatives, subnormals, values above
    the scale, NaN, every float32 in the binades around the zero
    threshold and the top midpoint, windows of ulps around every decision
    point and power of two), dequant values and lane tables, EF codes and
    residuals fed the reference's Delta+e and scale, the amax scale, and
    the moments against a float32 op-by-op numpy emulation (the K15
    kernel's definition);
  * moments against XLA on the CPU, which contracts mul+add into fma and
    divides through an approximate rsqrt: v' within 1 ulp; m' within 2
    ulp of the larger product max(|beta m|, |(1-beta) g|) (the fma skips
    the rounding of beta*m; at cancellation that is many ulps of m'
    itself); Delta+e, with beta = theta_t = 0 so that m' = g and
    v' = g*g exactly on both sides, within 4 ulp of the larger addend
    max(|alpha m'/sqrt(v'+eps)|, |e|). The Pallas interpret path meets
    the same tiers. ``pytest -s`` prints the readings.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import bits as JB
from repro.opt import engine as JE
from repro.opt import grids as JG
from repro_torch.comm import codec as TC
from repro_torch.comm import kernels as TK
from repro_torch.core import quantizers as TQ
from repro_torch.kernels import adam_ef as TA
from repro_torch.opt import engine as TE
from repro_torch.opt import grids as TG

f32 = np.float32


def _eq(a_jax, b_torch):
    a = np.asarray(a_jax)
    b = b_torch.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                  b.reshape(-1).view(np.uint8))


def _ulp(x):
    x = np.abs(np.asarray(x, np.float32))
    return (np.nextafter(x, f32(np.inf)) - x).astype(np.float64)


def _window(center: float, n: int = 600) -> np.ndarray:
    """The float32 values within n ulps of ``center`` (center > 0)."""
    c = np.asarray(center, f32).view(np.int32)
    return (c + np.arange(-n, n + 1, dtype=np.int32)).view(f32)


def _log_inputs(k_g: int) -> np.ndarray:
    """Windows of ulps around every decision point and power of two of
    the k_g grid at scale 1, both signs, plus special values."""
    pts = TG.log_thresholds(k_g) + [2.0 ** -j for j in range(-1, k_g + 4)]
    x = np.concatenate([_window(p) for p in pts])
    special = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, 1.2e-38, 3.0, -7.5,
                        np.inf, -np.inf, np.nan], f32)
    return np.concatenate([x, -x, special]).astype(f32)


_jit_log_quantize = jax.jit(JG.log_quantize, static_argnums=2)


@pytest.mark.parametrize("k_g", range(0, 9))
def test_log_quantize_decision_points_bitwise(k_g):
    x = _log_inputs(k_g)
    for scale in (f32(1.0), f32(0.37), f32(1e-31)):
        xs = x * scale if scale != f32(1.0) else x
        t = TG.log_quantize(torch.from_numpy(xs), torch.tensor(scale), k_g)
        _eq(JG.log_quantize(jnp.asarray(xs), jnp.float32(scale), k_g), t)
        _eq(_jit_log_quantize(jnp.asarray(xs), jnp.float32(scale), k_g), t)


@pytest.mark.parametrize("k_g", [30, 126])
def test_log_quantize_deep_decision_points_bitwise(k_g):
    """Windows of ulps around every decision point and power of two of
    the deep grids, where the reference's points come from XLA's exp2
    (and, in binade 125, its log2) and sit an ulp or more off the exact
    ones. Bitwise wherever |x| and |x| / scale are normal floats: XLA on
    the CPU flushes subnormals (the port's rule there is
    ``test_torch_log_grid_deep.py``'s)."""
    x = _log_inputs(k_g)
    for scale in (f32(1.0), f32(0.37), f32(1e-31)):
        xs = x * scale if scale != f32(1.0) else x
        keep = ~np.isfinite(xs) | (xs == 0) | (
            (np.abs(xs) >= f32(2.0 ** -126)) &
            (np.abs(xs) / scale >= f32(2.0 ** -126)))
        xs = np.ascontiguousarray(xs[keep])
        t = TG.log_quantize(torch.from_numpy(xs), torch.tensor(scale), k_g)
        _eq(_jit_log_quantize(jnp.asarray(xs), jnp.float32(scale), k_g), t)
        _eq(JG.log_quantize(jnp.asarray(xs), jnp.float32(scale), k_g), t)


@pytest.mark.parametrize("lo", [-7, -1, 0])
def test_log_quantize_full_binade_bitwise(lo):
    """Every float32 in [2^lo, 2^(lo+1)) at k_g = 6: the binade of the
    zero threshold 2^-7, of the top midpoint 0.75, and above the scale."""
    start = np.asarray(2.0 ** lo, f32).view(np.int32)
    x = (start + np.arange(1 << 23, dtype=np.int32)).view(f32)
    t = TG.log_quantize(torch.from_numpy(x), torch.tensor(1.0), 6)
    _eq(_jit_log_quantize(jnp.asarray(x), jnp.float32(1.0), 6), t)


@pytest.mark.parametrize("k_g", [*range(1, 9), 30, 126])
def test_log_dequant_table_and_lane_codes_bitwise(k_g):
    """Every lane code's table entry, at the shallow grids and at the
    adaptive plan's deep ones (log:30 on 6-bit lanes, log:126 on 8-bit
    lanes), whose powers of two come from XLA's inexact exp2."""
    bits = JB.lane_bits_for(k_g + 1)
    jt = JG.log_dequant_table(k_g, bits)
    np.testing.assert_array_equal(jt.view(np.uint32),
                                  TG.log_dequant_table(k_g, bits).view(
                                      np.uint32))
    n = 1 << bits
    codes = np.arange(-(n // 2), n // 2).astype(np.int8)
    # scales keep the values normal: XLA on the CPU flushes subnormal
    # results to zero, the port (and the card) keeps them
    small = float(np.abs(jt[jt != 0]).min())
    for scale in (f32(1.0), f32(0.0123), f32(2.0 ** -100), f32(3.7e5)):
        if small * float(scale) < 2.0 ** -126 or \
                float(np.abs(jt).max()) * float(scale) > 3e38:
            continue
        _eq(JG.log_dequantize(jnp.asarray(codes), jnp.float32(scale), k_g),
            TG.log_dequantize(torch.from_numpy(codes), torch.tensor(scale),
                              k_g))
        _eq(JE.dequantize_log(jnp.asarray(codes), jnp.float32(scale), k_g,
                              backend="jnp"),
            TK.log_dequantize(torch.from_numpy(codes), torch.tensor(scale),
                              k_g))


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("k_g", [2, 4, 6])
def test_dequantize_log_engine_bitwise(backend, k_g):
    rng = np.random.default_rng(k_g)
    codes = rng.integers(-(k_g + 1), k_g + 2, size=(37, 129)).astype(np.int8)
    s = f32(0.731)
    _eq(JE.dequantize_log(jnp.asarray(codes), jnp.float32(s), k_g,
                          backend=backend),
        TE.dequantize_log(torch.from_numpy(codes), torch.tensor(s), k_g))


def _state(n, seed, gscale=1.0):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(n) * gscale).astype(f32)
    m = (rng.standard_normal(n) * 0.3 * gscale).astype(f32)
    v = (rng.random(n) * gscale * gscale).astype(f32)
    e = (rng.standard_normal(n) * 1e-4).astype(f32)
    return g, m, v, e


def _moments_numpy(g, m, v, e, a, b, th, eps):
    """float32 op by op, one rounding each (numpy never contracts)."""
    b, th, eps = f32(b), f32(th), f32(eps)
    v2 = th * v + ((f32(1) - th) * g) * g
    m2 = b * m + (f32(1) - b) * g
    return m2, v2, (a * m2) / np.sqrt(v2 + eps) + e


@pytest.mark.parametrize("seed", range(4))
def test_adam_moments_exact_rounding_bitwise(seed):
    g, m, v, e = _state(4099, seed, 10.0 ** (seed - 3))
    a, b, th, eps = f32(1e-3), 0.99, f32(1) - f32(0.999) / f32(seed + 1), 1e-5
    hp = TE.hyperparams(a, b, th, eps, "cpu")
    got = TE.adam_ef_moments(*(torch.from_numpy(x) for x in (g, m, v, e)), hp)
    for want, t in zip(_moments_numpy(g, m, v, e, a, b, th, eps), got):
        np.testing.assert_array_equal(want.view(np.uint32),
                                      t.numpy().view(np.uint32))
    _, _, de, amax = TA.adam_moments(*(torch.from_numpy(x)
                                       for x in (g, m, v, e)), hp)
    _eq(JG.amax_scale(jnp.asarray(de.numpy())),
        TE.amax_scale(amax))


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("seed", range(3))
def test_adam_moments_vs_reference_tiers(backend, seed):
    g, m, v, e = _state(5000, seed, 10.0 ** (seed - 2))
    a, b, th, eps = f32(3e-3), 0.99, f32(1) - f32(0.999) / f32(seed + 2), 1e-5
    jm, jv, _ = (np.asarray(t) for t in JE.adam_ef_moments(
        *(jnp.asarray(x) for x in (g, m, v, e)), a, b, th, eps,
        backend=backend))
    hp = TE.hyperparams(a, b, th, eps, "cpu")
    tm, tv, _ = (t.numpy() for t in TE.adam_ef_moments(
        *(torch.from_numpy(x) for x in (g, m, v, e)), hp))
    bm, gm = np.abs(f32(b) * m), np.abs((f32(1) - f32(b)) * g)
    assert (np.abs(jm.astype(np.float64) - tm)
            <= 2 * _ulp(np.maximum(bm, gm))).all()
    assert (np.abs(jv.astype(np.float64) - tv) <= _ulp(tv)).all()
    assert (jm != tm).any()        # the tier is not vacuous: fma shows
    # Delta+e with beta = theta_t = 0: m' = g, v' = g*g on both sides
    jm0, jv0, jde = (np.asarray(t) for t in JE.adam_ef_moments(
        *(jnp.asarray(x) for x in (g, m, v, e)), a, 0.0, f32(0.0), eps,
        backend=backend))
    tm0, tv0, tde = (t.numpy() for t in TE.adam_ef_moments(
        *(torch.from_numpy(x) for x in (g, m, v, e)),
        TE.hyperparams(a, 0.0, 0.0, eps, "cpu")))
    np.testing.assert_array_equal(jm0, tm0)
    np.testing.assert_array_equal(jv0, tv0)
    q = np.abs((a * tm0) / np.sqrt(tv0 + f32(eps)))
    de_units = np.abs(jde.astype(np.float64) - tde) / _ulp(
        np.maximum(q, np.abs(e)))
    assert (de_units <= 4).all()
    m_units = np.abs(jm.astype(np.float64) - tm) / _ulp(np.maximum(bm, gm))
    print(f"{backend} seed {seed}: m' {m_units.max():.2f} ulp of the larger "
          f"product, v' {(np.abs(jv.astype(np.float64) - tv) / _ulp(tv)).max():.2f}"
          f" ulp, Delta+e {de_units.max():.2f} ulp of the larger addend")


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("k_g", [2, 4, 6, 30, 126])
def test_ef_quantize_and_update_bitwise_given_reference_de(backend, k_g):
    """Fed the reference's Delta+e: the scale, codes, residual and the
    decoded update are bitwise the reference's."""
    g, m, v, e = _state(3001, k_g)
    a, th = f32(1e-3), f32(1) - f32(0.999) / f32(3)
    _, _, de = JE.adam_ef_moments(*(jnp.asarray(x) for x in (g, m, v, e)),
                                  a, 0.99, th, 1e-5, backend=backend)
    js = JG.amax_scale(de)
    ts = TE.amax_scale(TG.block_amax(torch.from_numpy(np.asarray(de))))
    _eq(js, ts)
    jc, je = JE.ef_quantize(de, js, k_g, backend=backend)
    tc, te = TE.ef_quantize(torch.from_numpy(np.asarray(de)), ts, k_g)
    _eq(jc, tc)
    if k_g <= 12:
        _eq(je, te)
    else:
        # past k_g = 12 the levels are XLA's inexact powers of two, so
        # level * scale rounds: the port rounds it and then the
        # difference (as the kernels do); XLA contracts the two into one
        # fma. Each side is bitwise its own form.
        de_n = np.asarray(de)
        lv = TG.log_dequant_table(k_g, JB.lane_bits_for(k_g + 1))[
            tc.numpy().astype(int) + (1 << (JB.lane_bits_for(k_g + 1) - 1))]
        s = np.float32(js)
        np.testing.assert_array_equal(
            te.numpy().view(np.uint32), (de_n - lv * s).view(np.uint32))
        fma = (de_n.astype(np.float64)
               - lv.astype(np.float64) * np.float64(s)).astype(f32)
        np.testing.assert_array_equal(np.asarray(je).view(np.uint32),
                                      fma.view(np.uint32))
    _eq(JE.dequantize_log(jc, js, k_g, backend=backend),
        TE.dequantize_log(tc, ts, k_g))
    # the whole leaf update from the same state: Delta+e differs by XLA's
    # ulps, so a code may move one level where Delta+e sits within ulps of
    # a decision point, and the scale by the ulps of the largest element
    hp = TE.hyperparams(a, 0.99, th, 1e-5, "cpu")
    _, _, jc2, js2, _ = JE.adam_ef_step(
        *(jnp.asarray(x) for x in (g, m, v, e)), a, 0.99, th, 1e-5, k_g=k_g,
        backend=backend)
    # the port's step and update consume their state (in place): each
    # gets its own copy
    _, _, tc2, ts2, te2 = TE.adam_ef_step(
        *(torch.from_numpy(x).clone() for x in (g, m, v, e)), hp, k_g=k_g)
    assert abs(float(js2) - float(ts2)) <= 4 * _ulp(float(js2))
    jc2, tc2 = np.asarray(jc2).astype(int), tc2.numpy().astype(int)
    moved = jc2 != tc2
    assert moved.mean() <= 2e-3
    assert (np.abs(jc2 - tc2)[moved] == 1).all()
    assert (np.sign(jc2) * np.sign(tc2) >= 0).all()
    tupd, _, _, te3 = TE.adam_ef_update(
        *(torch.from_numpy(x).clone() for x in (g, m, v, e)), hp, k_g)
    _eq(-tupd.numpy(), TG.log_dequantize(torch.from_numpy(tc2.astype(np.int8)),
                                         ts2, k_g))
    _eq(te2.numpy(), te3)


def test_codecs_and_quantizers_bitwise():
    from repro.core import quantizers as JQ
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, 40, 24)) * 0.02).astype(f32)
    for spec in ("uniform:7", "uniform_amax:7", "uniform_amax:3", "log:6",
                 "log:2"):
        _eq(JQ.get_quantizer(spec)(jnp.asarray(x)),
            TQ.get_quantizer(spec)(torch.from_numpy(x)))
    z = np.zeros((5, 7), f32)
    _eq(JQ.get_quantizer("uniform_amax:7").encode(jnp.asarray(z)).scale,
        TC.UniformCodec(7, absolute=False).compute_scale(torch.from_numpy(z)))
    t = torch.from_numpy(x)
    assert TQ.get_quantizer(None)(t) is t
    js = JG.amax_scale(jnp.asarray(x))
    _eq(JG.log_quantize(jnp.asarray(x), js, 6),
        TC.LogCodec(6).quantize(t, TC.LogCodec(6).compute_scale(t)))
    # the baselines' specs parse as the reference's; an unknown one raises
    # ValueError in both
    for spec in ("terngrad", "blockwise:256"):
        assert type(TQ.get_quantizer(spec)).__name__ == \
            type(JQ.get_quantizer(spec)).__name__
    with pytest.raises(ValueError):
        JQ.get_quantizer("uniformx:3")
    with pytest.raises(ValueError, match="unknown quantizer spec"):
        TQ.get_quantizer("uniformx:3")


def test_wrappers_validate():
    x = torch.zeros(8)
    hp = torch.zeros(4)
    with pytest.raises(ValueError):
        TA.adam_moments(x, x, x, x.double(), hp)
    with pytest.raises(ValueError):
        TA.adam_moments(x, x, x, x, torch.zeros(3))
    with pytest.raises(ValueError):
        TA.adam_moments(x, x, x, x, hp, backend="cuda")
    with pytest.raises(ValueError):
        TA.ef_quantize(x, torch.ones(2), 6)
    with pytest.raises(ValueError):
        TK.log_dequantize(x, torch.tensor(1.0), 6)
    with pytest.raises(ValueError):
        TK.uniform_dequantize_rows(torch.zeros(2, 3, dtype=torch.int8),
                                   torch.ones(3), 6)
