"""#17 flash attention: the port's plain version (what the wrapper runs on
CPU tensors) against the JAX package's ``flash_attention`` in interpret
mode and against ``repro.models.layers.attention``.

The float32 route's arithmetic, 3xTF32, is emulated in numpy and held
to the card's tier, rtol 1e-4 / atol 1e-5 of the reference kernel; one
TF32 pass must fail it.

Tiers: float32 within rtol 2e-4 / atol 2e-5, the reference's own tier
for its kernel against ``layers.attention`` (the two apply 1/sqrt(hd)
at different places: to q before the product, or to the scores after
it); bfloat16 outputs within one bf16 ulp of the reference kernel's
(both round the same float32 result once, which two summation orders
can put on either side of a rounding boundary).
"""
import functools

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash
from repro.models import layers as JL
from repro_torch.kernels import flash_attention as TF

TOL = dict(rtol=2e-4, atol=2e-5)

# the four cases of tests/test_kernels.py (TestFlashAttention), gemma2's
# smoke widths (4 heads over 2 KV heads, hd 32, window 16, softcap 50),
# and hd 256 as gemma2's published width
CASES = {
    "causal": dict(B=2, Sq=256, Skv=256, H=4, K=2, hd=64, causal=True,
                   window=0, softcap=None),
    "suffix": dict(B=1, Sq=128, Skv=384, H=8, K=2, hd=32, causal=True,
                   window=0, softcap=None, q_offset=256),
    "swa_softcap": dict(B=1, Sq=256, Skv=256, H=2, K=2, hd=64, causal=True,
                        window=96, softcap=50.0),
    "bidirectional": dict(B=2, Sq=128, Skv=128, H=4, K=4, hd=128,
                          causal=False, window=0, softcap=None),
    "gemma2_smoke_local": dict(B=1, Sq=128, Skv=128, H=4, K=2, hd=32,
                               causal=True, window=16, softcap=50.0),
    "gemma2_smoke_global": dict(B=2, Sq=128, Skv=128, H=4, K=2, hd=32,
                                causal=True, window=0, softcap=50.0),
    "gemma2_hd256": dict(B=1, Sq=128, Skv=128, H=8, K=4, hd=256,
                         causal=True, window=48, softcap=50.0),
}


def _inputs(c, seed=7):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(c["B"], c["Sq"], c["H"], c["hd"])).astype(np.float32)
    k = rng.normal(size=(c["B"], c["Skv"], c["K"], c["hd"])).astype(np.float32)
    v = rng.normal(size=(c["B"], c["Skv"], c["K"], c["hd"])).astype(np.float32)
    return q, k, v


def _kw(c):
    return dict(causal=c["causal"], window=c["window"], softcap=c["softcap"],
                q_offset=c.get("q_offset", 0))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_reference_kernel_and_attention(name):
    c = CASES[name]
    q, k, v = _inputs(c)
    out = TF.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), **_kw(c))
    assert out.dtype == torch.float32 and out.shape == q.shape
    ref = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 interpret=True, **_kw(c))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    q_off = c.get("q_offset", 0)
    expect = JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          q_pos=q_off + jnp.arange(c["Sq"]),
                          causal=c["causal"], window=c["window"],
                          softcap=c["softcap"])
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), **TOL)


def test_bf16_output_within_one_ulp():
    c = CASES["gemma2_smoke_local"]
    q, k, v = (a.astype(ml_dtypes.bfloat16) for a in _inputs(c, seed=3))
    out = TF.flash_attention(
        *(torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
          for a in (q, k, v)), **_kw(c))
    assert out.dtype == torch.bfloat16
    ref = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            interpret=True, **_kw(c))).astype(np.float32)
    got = out.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126))) - 7)
    assert np.all(np.abs(got - ref) <= ulp)


def test_ragged_sq_and_skv():
    """Sq and Skv that are no multiple of any tile: the reference kernel
    needs them padded, so it runs on the padded inputs (queries past Sq
    discarded; keys past Skv out of every query's view by causality)."""
    c = dict(B=1, Sq=100, Skv=150, H=4, K=2, hd=64, causal=True, window=40,
             softcap=30.0, q_offset=50)
    q, k, v = _inputs(c, seed=5)
    out = TF.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), **_kw(c))
    pad = lambda a, n: np.pad(a, ((0, 0), (0, n - a.shape[1]), (0, 0),
                                  (0, 0)))
    ref = jflash(jnp.asarray(pad(q, 128)), jnp.asarray(pad(k, 256)),
                 jnp.asarray(pad(v, 256)), interpret=True, **_kw(c))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref)[:, :100], **TOL)
    expect = JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          q_pos=50 + jnp.arange(100), causal=True, window=40,
                          softcap=30.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(expect), **TOL)


def test_query_that_sees_no_key_gets_zeros_and_cuda_is_refused_on_cpu():
    c = dict(B=1, Sq=8, Skv=8, H=2, K=1, hd=32, causal=True, window=2,
             softcap=None, q_offset=12)     # queries at 12..19, keys 0..7
    q, k, v = (torch.from_numpy(a) for a in _inputs(c, seed=1))
    out = TF.flash_attention(q, k, v, **_kw(c))
    assert torch.equal(out, torch.zeros_like(out))
    with pytest.raises(ValueError):
        TF.flash_attention(q, k, v, backend="cuda")
    with pytest.raises(ValueError):
        TF.flash_attention(q, k[..., :16], v[..., :16])
    n0 = TF.launches
    TF.flash_attention(q, k, v)
    assert TF.launches == n0          # CPU tensors never launch the kernel


@pytest.mark.parametrize("dtype,expect", [(torch.bfloat16, "tc"),
                                          (torch.float32, "tc32")])
def test_route_by_dtype(dtype, expect):
    assert TF.route(dtype) == expect


def test_route_refuses_other_dtypes_and_cuda_on_cpu():
    with pytest.raises(ValueError):
        TF.route(torch.float16)
    c = dict(B=1, Sq=8, Skv=8, H=2, K=1, hd=32)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(c, seed=2))
    counts = (TF.launches, TF.launches_tc, TF.launches_tc32)
    with pytest.raises(ValueError):
        TF.flash_attention(q, k, v, backend="cuda")
    out = TF.flash_attention(q, k, v)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert (TF.launches, TF.launches_tc, TF.launches_tc32) == counts


# ---------------------------------------------------------------------------
# the float32 route's arithmetic (3xTF32), emulated in numpy
# ---------------------------------------------------------------------------

F32_TIER = dict(rtol=1e-4, atol=1e-5)   # the card's gate for "tc32"


def _tf32(a, rounding="rn"):
    """a rounded to TF32 (10 explicit mantissa bits): "rn" to nearest,
    ties away from zero (cvt.rna.tf32.f32: half of the low 13 bits' weight
    added to the magnitude, then the 13 bits masked); "trunc" toward zero
    (the 13 bits masked), the kernel's split."""
    b = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    if rounding == "rn":
        b = b + np.uint32(0x1000)
    return (b & np.uint32(0xFFFFE000)).view(np.float32)


def _mm_tf32(a, b, passes, rounding):
    """a @ b from TF32 operands with fp32 sums: 3 passes split each operand
    into hi = tf32(x), lo = tf32(x - hi) and take lo hi + hi lo + hi hi;
    1 pass takes hi hi alone."""
    ah, bh = _tf32(a, rounding), _tf32(b, rounding)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah, rounding), _tf32(b - bh, rounding)
    return (al @ bh + ah @ bl) + ah @ bh


def _flash_tf32(q, k, v, *, causal, window, softcap, q_offset, passes,
                rounding):
    """#17 with both products (S = q k^T, O = P V) in TF32 passes: the
    score scaled after the product, softmax in float32, P split as the
    kernel splits it."""
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    qp = q_offset + np.arange(Sq)[:, None]
    kp = np.arange(Skv)[None, :]
    vis = np.ones((Sq, Skv), dtype=bool)
    if causal:
        vis &= qp >= kp
    if window:
        vis &= kp > qp - window
    scale = np.float32(1.0 / np.sqrt(hd))
    out = np.zeros(q.shape, np.float32)
    for b in range(B):
        for h in range(H):
            kh = h // (H // K)
            s = _mm_tf32(q[b, :, h], k[b, :, kh].T, passes, rounding) * scale
            if softcap is not None:
                s = np.float32(softcap) * np.tanh(s / np.float32(softcap))
            s = np.where(vis, s, np.float32(-1e30))
            p = np.where(vis, np.exp(s - s.max(-1, keepdims=True)),
                         np.float32(0.0)).astype(np.float32)
            o = _mm_tf32(p, v[b, :, kh], passes, rounding)
            den = np.maximum(p.sum(-1, dtype=np.float32), np.float32(1e-30))
            out[b, :, h] = o / den[:, None]
    return out


# the four cases of tests/test_kernels.py and a gemma2-like layer (hd 256,
# a window inside the sequence, the softcap)
TF32_CASES = ["causal", "suffix", "swa_softcap", "bidirectional",
              "gemma2_hd256"]


@functools.lru_cache(maxsize=None)
def _reference(name):
    c = CASES[name]
    q, k, v = _inputs(c, seed=11)
    ref = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            interpret=True, **_kw(c)))
    return q, k, v, ref


def test_tf32_rounding():
    """rn: to nearest, ties away from zero; trunc: toward zero; 10
    mantissa bits kept either way"""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    x = np.array([1 + 2.0 ** -11, 1 + 2.0 ** -11 - 2.0 ** -23,
                  -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11, 3.0, 0.0],
                 dtype=np.float32)
    np.testing.assert_array_equal(
        _tf32(x, "rn"), np.array([one + ulp, one, -(one + ulp),
                                  one + 2 * ulp, 3.0, 0.0], dtype=np.float32))
    np.testing.assert_array_equal(
        _tf32(x, "trunc"), np.array([one, one, -one, one + ulp, 3.0, 0.0],
                                    dtype=np.float32))
    r = np.random.default_rng(0).normal(size=1000).astype(np.float32)
    for rounding, bound in (("rn", 11), ("trunc", 10)):
        hi = _tf32(r, rounding)
        assert np.all(hi.view(np.uint32) & np.uint32(0x1FFF) == 0)
        assert np.all(np.abs(r - hi) <= np.abs(r) * 2.0 ** -bound)
        lo = _tf32(r - hi, rounding)
        assert np.all(np.abs(r - hi - lo) <= np.abs(r) * 2.0 ** -(2 * bound))


@pytest.mark.parametrize("rounding", ["rn", "trunc"])
@pytest.mark.parametrize("name", TF32_CASES)
def test_3xtf32_holds_the_float32_tier(name, rounding):
    """The split (three TF32 products a product; "trunc" is the kernel's)
    stays within rtol 1e-4 / atol 1e-5 of the reference kernel."""
    q, k, v, ref = _reference(name)
    out = _flash_tf32(q, k, v, passes=3, rounding=rounding,
                      **_kw(CASES[name]))
    np.testing.assert_allclose(out, ref, **F32_TIER)


@pytest.mark.parametrize("rounding", ["rn", "trunc"])
@pytest.mark.parametrize("name", TF32_CASES)
def test_one_tf32_pass_fails_the_float32_tier(name, rounding):
    """The planted fault: one TF32 product a product (2^-11 to 2^-10 an
    operand) breaks the same tier, so the gate can tell the schemes
    apart."""
    q, k, v, ref = _reference(name)
    out = _flash_tf32(q, k, v, passes=1, rounding=rounding,
                      **_kw(CASES[name]))
    assert not np.allclose(out, ref, **F32_TIER)
