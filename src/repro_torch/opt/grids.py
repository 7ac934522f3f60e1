"""The paper's grids, uniform Q_x and log Q_g, the baselines' TernGrad
ternary and blockwise sign grids, and the Adam+EF leaf math (port of
``repro/opt/grids.py``).

Plain tensor functions with explicit scales (pass 1 amax, pass 2
quantize): the plain versions the kernels are held against. Codes and
dequantized values are bitwise equal to the reference's for the same
input and scale; the Adam moments differ from XLA's CPU evaluation by
its fma contraction and approximate rsqrt (see :func:`adam_ef_moments`).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.comm import bits as B


def block_amax(x: torch.Tensor) -> torch.Tensor:
    """Per-call global amax (the scale pass)."""
    return x.to(torch.float32).abs().amax()


def amax_scale(x: torch.Tensor) -> torch.Tensor:
    """Amax scale with the zero guard every channel shares."""
    amax = block_amax(x)
    return torch.where(amax > 0, amax, torch.ones_like(amax))


def uniform_code_dtype(k_x: int) -> torch.dtype:
    """Codes live in [-2^k, 2^k]: int8 holds k_x <= 6, int16 k_x <= 14."""
    if k_x <= 6:
        return torch.int8
    return torch.int16 if k_x <= 14 else torch.int32


def uniform_quantize(x: torch.Tensor, scale, k_x: int) -> torch.Tensor:
    """``round(clip(x / max(scale, 1e-30), -1, 1) * 2^k)``; ``round``
    is half to even, as ``jnp.round``. ``scale`` broadcasts against x."""
    n = float(2 ** k_x)
    s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    y = torch.clamp(x.to(torch.float32) / torch.clamp_min(s, 1e-30), -1.0, 1.0)
    return torch.round(y * n).to(uniform_code_dtype(k_x))


def uniform_dequantize(codes: torch.Tensor, scale, k_x: int) -> torch.Tensor:
    """``codes / 2^k * scale`` in float32 (the division is exact)."""
    n = float(2 ** k_x)
    s = torch.as_tensor(scale, dtype=torch.float32, device=codes.device)
    return codes.to(torch.float32) / n * s


@functools.lru_cache(maxsize=None)
def uniform_dequant_table(k_x: int, bits: int) -> np.ndarray:
    """Scale-1 dequant values per ``bits``-wide lane code, ordered by raw
    lane value (index = code + 2^{bits-1}), built by evaluating
    :func:`uniform_dequantize` itself."""
    n = 1 << bits
    codes = torch.arange(-(n // 2), n // 2, dtype=torch.int32)
    return uniform_dequantize(codes, 1.0, k_x).numpy()


# ---------------------------------------------------------------------------
# log grid (the paper's Q_g)
# ---------------------------------------------------------------------------

MAX_LOG_K = 126   # int8 codes hold +/-(k_g + 1)

# The reference evaluates exp2 through XLA, which on the CPU computes it
# as exp(x ln 2): for most integral exponents below -12 and odd or large
# ones above 12 that misses 2^e by a few ulps (measured on the
# reference's CPU backend, jax 0.9.0). Its lane tables and its decision
# points come from that exp2, so the port carries the values: each
# entry is XLA's exp2(e) minus 2^e, counted in float32 bit patterns.
# Below e = -125 the result falls under the smallest normal float and
# XLA's flush makes it 0.
_XLA_EXP2_ULPS = {
    -125: 26, -124: 14, -123: 2, -122: -20, -121: -44, -120: 30, -119: 18,
    -118: 6, -117: -12, -116: -36, -115: -60, -114: 22, -113: 10, -112: -4,
    -111: -28, -110: -52, -109: 26, -108: 14, -107: 2, -106: -19,
    -105: -43, -104: -67, -103: 18, -102: 6, -101: -11, -100: -35,
    -99: -59, -98: 22, -97: 10, -96: -3, -95: -27, -94: -51, -93: 27,
    -92: 15, -91: 3, -90: -19, -89: 11, -88: -3, -87: -27, -86: 7,
    -85: -11, -84: -35, -83: 3, -82: -19, -81: 11, -80: -3, -79: -27,
    -78: 7, -77: -10, -76: 15, -75: 3, -74: -18, -73: 11, -72: -2,
    -71: -26, -70: 7, -69: -10, -68: -34, -67: 3, -66: -18, -65: 11,
    -64: -2, -63: -26, -62: 7, -61: -10, -60: 15, -59: 3, -58: -18,
    -57: 11, -56: -2, -55: -26, -54: 7, -53: -10, -52: -34, -51: 3,
    -50: -18, -49: 11, -48: -2, -47: -26, -46: 7, -45: -9, -44: -1, -43: 3,
    -42: -17, -41: -9, -40: -1, -39: 3, -38: 7, -37: -9, -36: -1, -35: 3,
    -34: -17, -33: -9, -32: -1, -31: 4, -30: 8, -29: -9, -28: -1, -27: 4,
    -26: -17, -25: -9, -24: -1, -23: 4, -22: -1, -21: -9, -20: -1, -19: 4,
    -18: -1, -17: -9, -16: -1, -15: 4, -13: -8, 13: 4, 15: -8, 17: 4,
    19: -7, 21: 4, 23: -7, 25: 4, 26: 8, 27: -7, 29: 4, 30: -15, 31: -7,
    32: 1, 33: 5, 34: 9, 35: -7, 36: 1, 37: 5, 38: -15, 39: -7, 40: 1,
    41: 5, 42: 9, 43: -7, 44: 1, 45: 5, 46: -15, 47: 13, 48: 1, 49: -22,
    50: 9, 51: -6, 52: 17, 53: 5, 54: -14, 55: 13, 56: 1, 57: -22, 58: 9,
    59: -6, 60: -30, 61: 5, 62: -14, 63: 13, 64: 1, 65: -22, 66: 9, 67: -6,
    68: 17, 69: 5, 70: -14, 71: 13, 72: 1, 73: -22, 74: 9, 75: -6, 76: -30,
    77: 5, 78: -14, 79: 13, 80: 1, 81: -21, 82: 9, 83: -5, 84: 17, 85: 5,
    86: -13, 87: 13, 88: 1, 89: -21, 90: 9, 91: -5, 92: -29, 93: -53,
    94: 26, 95: 14, 96: 2, 97: -21, 98: -45, 99: 30, 100: 18, 101: 6,
    102: -13, 103: -37, 104: 34, 105: 22, 106: 10, 107: -5, 108: -29,
    109: -53, 110: 26, 111: 14, 112: 2, 113: -20, 114: -44, 115: 30,
    116: 18, 117: 6, 118: -12, 119: -36, 120: -60, 121: 22, 122: 10,
    123: -4, 124: -28, 125: -52, 126: 26, 127: 14}


def xla_exp2(e: int) -> float:
    """The reference's ``jnp.exp2(e)`` for an integral e, as a float32
    value (0 for e <= -126, inf for e >= 128)."""
    if e <= -126:
        return 0.0
    if e >= 128:
        return math.inf
    bits = np.float32(math.ldexp(1.0, e)).view(np.int32) \
        + _XLA_EXP2_ULPS.get(e, 0)
    return float(np.int32(bits).view(np.float32))


# In binade j = 125 the reference's midpoint 1.5 * exp2(-126) is 0, so
# its decision falls where -log2(y) stops rounding to 126 (measured: the
# first y quantized to level 2^-125 at k_g = 126).
_MID_125 = float.fromhex("0x1.00000cp-126")


@functools.lru_cache(maxsize=None)
def log_midpoint(j: int) -> float:
    """The reference's decision point between levels 2^-j and 2^-(j+1)
    (0 <= j <= 125): ``1.5 * exp2(-(j+1))`` in float32, 0.75 * 2^-j up
    to an ulp or so. It lies strictly inside [2^-(j+1), 2^-j)."""
    if j == 125:
        return _MID_125
    return float(np.float32(1.5) * np.float32(xla_exp2(-(j + 1))))


@functools.lru_cache(maxsize=None)
def log_zero_threshold(k_g: int) -> float:
    """The reference's zero threshold ``exp2(-k_g) * 0.5`` in float32,
    halfway to the smallest level. At k_g = 126 the reference's is 0
    (its exp2(-126) flushes); the port keeps the exact grid's 2^-127."""
    if k_g == MAX_LOG_K:
        return math.ldexp(1.0, -(k_g + 1))
    return float(np.float32(xla_exp2(-k_g)) * np.float32(0.5))


def log_thresholds(k_g: int):
    """Decision points of the log grid on y = |x| / scale, ascending: the
    zero threshold, then the linear-space midpoints between levels 2^-j
    and 2^-(j+1), j = k_g-1 .. 0. Each is the reference's own value
    (:func:`log_zero_threshold`, :func:`log_midpoint`): 2^-(k_g+1) and
    0.75 * 2^-j exactly for shallow grids, an ulp or more off them for
    deep ones."""
    if not 0 <= k_g <= MAX_LOG_K:
        raise ValueError(f"k_g={k_g} outside [0, {MAX_LOG_K}]")
    return ([log_zero_threshold(k_g)]
            + [log_midpoint(j) for j in range(k_g - 1, -1, -1)])


GRID_TABLE_LEN = 256


@functools.lru_cache(maxsize=None)
def log_grid_table() -> np.ndarray:
    """The decision points every log kernel reads, float32 (256,):
    ``[j]`` is :func:`log_midpoint` (j <= 125), ``[128 + k]`` is
    :func:`log_zero_threshold` (k <= 126); the rest is 0."""
    t = np.zeros(GRID_TABLE_LEN, np.float32)
    for j in range(MAX_LOG_K):
        t[j] = log_midpoint(j)
    for k in range(MAX_LOG_K + 1):
        t[128 + k] = log_zero_threshold(k)
    return t


def log_quantize(x: torch.Tensor, scale, k_g: int) -> torch.Tensor:
    """Nearest-in-linear-space log-grid codes given a scale, int8.

    Code layout: 0 encodes 0; signed code c with |c| in [1, k_g+1]
    encodes +/- 2^-(k_g+1-|c|). The reference finds the level through
    log2/exp2; here the magnitude is the number of decision points
    (:func:`log_thresholds`, the reference's values) that y = |x| / scale
    reaches, compared exactly. A y exactly at a decision point goes to
    the larger level, as in the reference; a NaN y (NaN input or scale)
    gets the reference's magnitude, k_g (1 at k_g = 0).

    Subnormal y: XLA on the CPU flushes a subnormal y to zero. At
    k_g <= 125 every subnormal y lies below the zero threshold, so both
    programs give code 0. At k_g = 126 the reference's zero threshold
    flushes to 0 as well, and a nonzero x whose |x| / scale is subnormal
    gets the code +/-126 there (level 2^-1, about scale / 2; measured).
    The port does not copy the flush: it keeps the exact grid, 0 below
    2^-127 and +/-1 from 2^-127 to the first midpoint. Every normal y
    gets the reference's code.
    """
    x = x.to(torch.float32)
    s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    y = (x.abs() / torch.clamp_min(s, 1e-30)).contiguous()
    thr = torch.tensor(log_thresholds(k_g), dtype=torch.float32,
                       device=x.device)
    # the decision points at or below y (ascending, so a search)
    mag = torch.searchsorted(thr, y, right=True).to(torch.int8)
    mag = torch.where(torch.isnan(y), max(k_g, 1), mag).to(torch.int8)
    mag = torch.where(x == 0, 0, mag).to(torch.int8)
    return torch.where(x < 0, -mag, mag)


@functools.lru_cache(maxsize=None)
def log_dequant_table(k_g: int, bits: int) -> np.ndarray:
    """Scale-1 dequant values ``sign(c) * 2^(|c|-k_g-1)`` (0 for c = 0)
    for every ``bits``-wide lane code, ordered by raw lane value (index =
    code + 2^{bits-1}). Each power of two is the reference's own
    (:func:`xla_exp2`): exact for exponents -12 .. 12, an ulp or more off
    beyond, and a signed 0 where it flushes (code +/-1 at k_g = 126)."""
    n = 1 << bits
    vals = []
    for c in range(-(n // 2), n // 2):
        mag = 0.0 if c == 0 else xla_exp2(abs(c) - (k_g + 1))
        vals.append(math.copysign(mag, c))
    return np.asarray(vals, dtype=np.float32)


_tables = {}   # (name, device) -> a grid table on that device


def _table_on(name, make, device) -> torch.Tensor:
    key = (name, str(device))
    if key not in _tables:
        _tables[key] = torch.from_numpy(make()).to(device)
    return _tables[key]


def log_table_on(k_g: int, device) -> torch.Tensor:
    """:func:`log_dequant_table` of k_g's lane on ``device``, copied there
    once (the levels every log kernel reads)."""
    return _table_on(("levels", k_g), lambda: log_dequant_table(
        k_g, B.lane_bits_for(k_g + 1)), device)


def log_grid_on(device) -> torch.Tensor:
    """:func:`log_grid_table` on ``device``, copied there once (the
    decision points every log quantizer kernel reads)."""
    return _table_on("grid", log_grid_table, device)


def log_dequantize(codes: torch.Tensor, scale, k_g: int) -> torch.Tensor:
    """``table[c] * scale`` in float32: the reference's
    ``sign(c) * 2^(|c|-k_g-1) * scale``, which multiplies its signed
    power of two (:func:`log_dequant_table`) by the scale once. Codes must lie in the k_g
    grid's lane (every quantizer output does); others clip to its ends."""
    table = log_table_on(k_g, codes.device)
    half = table.shape[0] // 2
    idx = torch.clamp(codes.to(torch.int64) + half, 0, 2 * half - 1)
    s = torch.as_tensor(scale, dtype=torch.float32, device=codes.device)
    return table[idx] * s


# ---------------------------------------------------------------------------
# ternary grid (TernGrad baseline)
# ---------------------------------------------------------------------------

def ternary_quantize(x: torch.Tensor, u: torch.Tensor, scale) -> torch.Tensor:
    """Unbiased stochastic ternary codes {-1, 0, +1}, int8:
    ``sign(x) * (u < |x| / max(scale, 1e-30))`` with ``u`` uniforms in
    [0, 1) of x's shape, drawn outside. The division is one IEEE
    rounding, as the reference's."""
    x = x.to(torch.float32)
    s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    p = x.abs() / torch.clamp_min(s, 1e-30)
    return torch.sign(x).to(torch.int8) * (u < p).to(torch.int8)


def ternary_dequantize(codes: torch.Tensor, scale) -> torch.Tensor:
    """``codes * scale`` in float32."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=codes.device)
    return codes.to(torch.float32) * s


# ---------------------------------------------------------------------------
# blockwise sign grid (Zheng et al. '19 baseline)
# ---------------------------------------------------------------------------

def tree_sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim (a power of two) in one fixed order, a
    halving tree: ``x[..., :h] + x[..., h:]`` down to one column. The
    blockwise kernel sums in this order, so the two are bitwise."""
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError(f"the tree sums a power-of-two width, got {n}")
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def blockwise_quantize(x2d: torch.Tensor):
    """(nb, block) float32 -> (sign codes int8, per-block mean |x|). The
    mean is :func:`tree_sum_last` of |x| times 1/block (exact for a
    power of two); the reference's XLA sum takes another order, within a
    few ulps."""
    x2d = x2d.to(torch.float32)
    scale = tree_sum_last(x2d.abs()) * (1.0 / x2d.shape[-1])
    return torch.sign(x2d).to(torch.int8), scale


def blockwise_dequantize(codes2d: torch.Tensor,
                         scales: torch.Tensor) -> torch.Tensor:
    return codes2d.to(torch.float32) * scales[..., None]


# ---------------------------------------------------------------------------
# Adam+EF leaf math (Algorithm 1 lines 3-6)
# ---------------------------------------------------------------------------

def adam_ef_moments(g, m, v, e, hp):
    """Moment updates and the full-precision Delta_t + e_t, in float32,
    one rounding per operation and in the reference's order:

        v' = theta_t * v + ((1 - theta_t) * g) * g
        m' = beta * m + (1 - beta) * g
        Delta + e = (alpha_t * m') / sqrt(v' + eps) + e

    ``hp`` is the (4,) float32 tensor [alpha_t, beta, theta_t, eps] on
    the tensors' device. Returns (m', v', Delta + e). XLA on the CPU
    contracts the reference's mul+add pairs into fma and evaluates the
    division through an approximate rsqrt; this form does neither, which
    is what the K15 kernel computes bit for bit. The root is taken in
    float64 and rounded once, which gives the correctly rounded float32
    root (float64 has more than twice float32's precision); PyTorch's
    float32 sqrt on the CPU is not correctly rounded.
    """
    g = g.to(torch.float32)
    alpha_t, beta, theta_t, eps = hp[0], hp[1], hp[2], hp[3]
    v_new = theta_t * v + ((1.0 - theta_t) * g) * g
    m_new = beta * m + (1.0 - beta) * g
    root = torch.sqrt((v_new + eps).to(torch.float64)).to(torch.float32)
    delta_plus_e = (alpha_t * m_new) / root + e
    return m_new, v_new, delta_plus_e


def adam_ef_quantize(delta_plus_e, scale, k_g: int):
    """Codes and the new EF residual (Algorithm 1 lines 5-6):
    e' = (Delta + e) - log_dequantize(codes, scale)."""
    codes = log_quantize(delta_plus_e, scale, k_g)
    deq = log_dequantize(codes, scale, k_g)
    return codes, delta_plus_e - deq
