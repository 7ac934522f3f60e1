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

def log_thresholds(k_g: int):
    """Decision points of the log grid on y = |x| / scale, ascending: the
    zero threshold 2^-(k_g+1) (halfway to the smallest level), then the
    linear-space midpoints 0.75 * 2^-j between levels 2^-j and 2^-(j+1),
    j = k_g-1 .. 0. All are exact in float32."""
    return ([math.ldexp(1.0, -(k_g + 1))]
            + [0.75 * math.ldexp(1.0, -j) for j in range(k_g - 1, -1, -1)])


def log_quantize(x: torch.Tensor, scale, k_g: int) -> torch.Tensor:
    """Nearest-in-linear-space log-grid codes given a scale, int8.

    Code layout: 0 encodes 0; signed code c with |c| in [1, k_g+1]
    encodes +/- 2^-(k_g+1-|c|). The reference finds the level through
    log2/exp2; here the magnitude is the number of decision points
    (:func:`log_thresholds`) that y reaches, compared exactly, so no
    transcendental can round a value across a boundary. A y exactly at
    a midpoint goes to the larger level, as in the reference; a NaN y
    (NaN input or scale) gets the reference's magnitude, k_g (1 at
    k_g = 0).
    """
    x = x.to(torch.float32)
    s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    y = x.abs() / torch.clamp_min(s, 1e-30)
    mag = torch.zeros(x.shape, dtype=torch.int8, device=x.device)
    for t in log_thresholds(k_g):
        mag += (y >= t).to(torch.int8)
    mag = torch.where(torch.isnan(y), max(k_g, 1), mag).to(torch.int8)
    mag = torch.where(x == 0, 0, mag).to(torch.int8)
    return torch.where(x < 0, -mag, mag)


# XLA evaluates exp2 as exp(x ln 2), which misses 2^n by an ulp for these
# integral n (measured on the reference's CPU backend); lane codes past
# the grid (|c| > k_g+1, never produced by the quantizer) reach them for
# k_g >= 7, and the port's tables carry the reference's values.
_XLA_EXP2 = {13: float.fromhex("0x1.000008p+13"),
             15: float.fromhex("0x1.fffffp+14"),
             17: float.fromhex("0x1.000008p+17"),
             19: float.fromhex("0x1.fffff2p+18"),
             21: float.fromhex("0x1.000008p+21"),
             23: float.fromhex("0x1.fffff2p+22")}


@functools.lru_cache(maxsize=None)
def log_dequant_table(k_g: int, bits: int) -> np.ndarray:
    """Scale-1 dequant values ``sign(c) * 2^(|c|-k_g-1)`` (0 for c = 0)
    for every ``bits``-wide lane code, ordered by raw lane value (index =
    code + 2^{bits-1}). Powers of two are built exactly with ldexp;
    exponents past 12 take the reference's own values (``_XLA_EXP2``)."""
    n = 1 << bits
    vals = []
    for c in range(-(n // 2), n // 2):
        e = abs(c) - (k_g + 1)
        mag = 0.0 if c == 0 else _XLA_EXP2.get(e, math.ldexp(1.0, e))
        vals.append(math.copysign(mag, c))
    return np.asarray(vals, dtype=np.float32)


_log_tables = {}   # (k_g, device) -> the lane table on that device


def _log_table_on(k_g: int, device) -> torch.Tensor:
    """:func:`log_dequant_table` on ``device``, copied there once."""
    key = (k_g, str(device))
    if key not in _log_tables:
        bits = B.lane_bits_for(k_g + 1)
        _log_tables[key] = torch.from_numpy(
            log_dequant_table(k_g, bits)).to(device)
    return _log_tables[key]


def log_dequantize(codes: torch.Tensor, scale, k_g: int) -> torch.Tensor:
    """``table[c] * scale`` in float32: the reference's
    ``sign(c) * 2^(|c|-k_g-1) * scale``, which multiplies the exact
    signed power of two by the scale once. Codes must lie in the k_g
    grid's lane (every quantizer output does); others clip to its ends."""
    table = _log_table_on(k_g, codes.device)
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
