"""#17 flash attention: the port's plain version (what the wrapper runs on
CPU tensors) against the JAX package's ``flash_attention`` in interpret
mode and against ``repro.models.layers.attention``.

Tiers: float32 within rtol 2e-4 / atol 2e-5, the reference's own tier
for its kernel against ``layers.attention`` (the two apply 1/sqrt(hd)
at different places: to q before the product, or to the scores after
it); bfloat16 outputs within one bf16 ulp of the reference kernel's
(both round the same float32 result once, which two summation orders
can put on either side of a rounding boundary).
"""
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
                                          (torch.float32, "fma")])
def test_route_by_dtype(dtype, expect):
    assert TF.route(dtype) == expect


def test_route_refuses_other_dtypes_and_cuda_on_cpu():
    with pytest.raises(ValueError):
        TF.route(torch.float16)
    c = dict(B=1, Sq=8, Skv=8, H=2, K=1, hd=32)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(c, seed=2))
    counts = (TF.launches, TF.launches_tc, TF.launches_fma)
    with pytest.raises(ValueError):
        TF.flash_attention(q, k, v, backend="cuda")
    out = TF.flash_attention(q, k, v)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert (TF.launches, TF.launches_tc, TF.launches_fma) == counts
