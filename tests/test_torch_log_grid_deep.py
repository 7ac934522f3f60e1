"""The deep log grids of the adaptive plan's lanes (log:30 on 6-bit lanes,
log:126 on 8-bit lanes) against the JAX package, on every float32.

The reference finds a level through ``log2``/``exp2``, and XLA on the CPU
computes ``exp2(n)`` as ``exp(n ln 2)``, which misses 2^n by an ulp or
more for most n below -12. So its zero threshold ``exp2(-k_g) * 0.5`` and
its midpoints ``1.5 * exp2(-(e+1))`` sit off the exact grid's 2^-(k_g+1)
and 0.75 * 2^-j there; in binade 125 its midpoint is 0 (exp2(-126)
flushes) and the decision falls where its log2 puts it. The port carries
those values (``repro_torch.opt.grids.log_thresholds``).

Tiers:
  * bitwise, every float32 of every binade [2^-(j+1), 2^-j) that holds a
    decision point the reference moved off the exact grid (18 binades at
    k_g = 30, 113 at k_g = 126), at scale 1: y is x itself, so the whole
    binade of y is covered; negative x on every 64th value;
  * the subnormal rule, pinned on both sides: XLA on the CPU flushes a
    subnormal |x| / scale to zero. At k_g <= 125 that lies below the zero
    threshold on both sides (code 0). At k_g = 126 the reference's zero
    threshold flushes too and it gives a nonzero x there the code +/-126
    (level 2^-1); the port keeps the exact grid (0 below 2^-127, +/-1
    above it, whose level is the reference's flushed 0).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.opt import grids as JG
from repro_torch.opt import grids as TG

f32 = np.float32
_jit_log_quantize = jax.jit(JG.log_quantize, static_argnums=2)


def _moved_binades(k_g: int):
    """The binade exponents lo (binade [2^lo, 2^(lo+1))) of the normal
    decision points of the k_g grid that differ from the exact grid's."""
    exact = [2.0 ** -(k_g + 1)] + [0.75 * 2.0 ** -j
                                   for j in range(k_g - 1, -1, -1)]
    out = []
    for t, e in zip(TG.log_thresholds(k_g), exact):
        if t != e and t >= 2.0 ** -126:
            out.append(int(np.floor(np.log2(t))))
    return sorted(set(out))


CASES = [(k, lo) for k in (30, 126) for lo in _moved_binades(k)]


def test_moved_binade_counts():
    """The reference moved 18 normal decision points of the 30 grid and
    113 of the 126 grid (its zero threshold there is subnormal, held
    below)."""
    assert len(_moved_binades(30)) == 18
    assert len(_moved_binades(126)) == 113


@pytest.mark.parametrize("k_g,lo", CASES)
def test_every_float32_of_moved_binade_bitwise(k_g, lo):
    start = np.asarray(2.0 ** lo, f32).view(np.int32)
    x = (start + np.arange(1 << 23, dtype=np.int32)).view(f32)
    t = TG.log_quantize(torch.from_numpy(x), torch.tensor(1.0), k_g).numpy()
    j = np.asarray(_jit_log_quantize(jnp.asarray(x), jnp.float32(1.0), k_g))
    np.testing.assert_array_equal(j, t)
    # the binade holds exactly one step, up by one level
    assert np.count_nonzero(np.diff(t.astype(np.int16))) == 1
    neg = np.ascontiguousarray(-x[::64])
    np.testing.assert_array_equal(
        np.asarray(_jit_log_quantize(jnp.asarray(neg), jnp.float32(1.0),
                                     k_g)),
        TG.log_quantize(torch.from_numpy(neg), torch.tensor(1.0),
                        k_g).numpy())


def test_subnormal_rule_pinned():
    """|x| / scale subnormal (x itself normal): both programs' codes
    stated, so a change on either side shows."""
    scale = f32(1e10)
    x = np.array([1e-30, -1e-30, 8e-29, -2e-34, 1.2e-29, -9e-29], f32)
    y = np.abs(x) / scale
    assert (y < f32(2.0 ** -126)).all() and (y > 0).all()
    for k_g in (6, 30, 125):
        want = np.zeros(x.shape, np.int8)
        np.testing.assert_array_equal(np.asarray(_jit_log_quantize(
            jnp.asarray(x), jnp.float32(scale), k_g)), want)
        np.testing.assert_array_equal(TG.log_quantize(
            torch.from_numpy(x), torch.tensor(scale), k_g).numpy(), want)
    ref = np.asarray(_jit_log_quantize(jnp.asarray(x), jnp.float32(scale),
                                       126))
    np.testing.assert_array_equal(ref, (126 * np.sign(x)).astype(np.int8))
    port = TG.log_quantize(torch.from_numpy(x), torch.tensor(scale),
                           126).numpy()
    exact = np.where(y >= f32(2.0 ** -127), 1, 0) * np.sign(x)
    np.testing.assert_array_equal(port, exact.astype(np.int8))
    # code +/-1's level at k_g = 126 is the reference's exp2(-126): 0
    tab = TG.log_dequant_table(126, 8)
    assert tab[128 + 1] == 0.0 and tab[128 - 1] == 0.0
    assert np.signbit(tab[128 - 1])
    # a normal y keeps its code on both sides, down to the last binade
    xn = np.array([2.0 ** -126, 1.00001 * 2.0 ** -126, 1.4 * 2.0 ** -126,
                   2.0 ** -125], f32)
    np.testing.assert_array_equal(
        np.asarray(_jit_log_quantize(jnp.asarray(xn), jnp.float32(1.0),
                                     126)),
        TG.log_quantize(torch.from_numpy(xn), torch.tensor(1.0),
                        126).numpy())
