"""The SSD layers of the SSM and hybrid family
(``repro_torch.models.layers``: ``segsum``, ``ssd_chunked``,
``causal_conv1d``, ``mamba2_mix``, and the meta-token prefix of the
attention functions) against the JAX package's, in float32. Tier 1, a
few seconds.

Tolerance: the port takes the inter-chunk prefixes in chunk order where
the reference takes them with ``lax.associative_scan``, and writes the
intra-chunk contraction as three products where XLA orders one
four-operand einsum its own way; both round differently in float32. So
outputs, states and gradients are held at rtol 1e-5 and an atol of
2e-6 times the largest magnitude of the compared tensor (a few float32
ulps of the sums). The convolution is the same chain of float32 adds
in both packages (rtol 1e-6 / atol 1e-7: XLA may contract into fma).
A planted fault (the inter-chunk state term dropped) must fail the same
gate.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import layers as JL
from repro.models.model import Model as JModel
from repro_torch.models import layers as TL

SCALE_ATOL = 2e-6
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want) -> bool:
    """The module's gate: within rtol 1e-5 and 2e-6 of the largest
    magnitude of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = SCALE_ATOL * max(float(np.max(np.abs(want))), 1e-30)
    return bool(np.all(np.abs(got - want) <= atol + RTOL * np.abs(want)))


def _ssd_inputs(seed, B=2, S=32, H=4, P=8, G=1, N=16):
    rng = np.random.default_rng(seed)
    xdt = rng.standard_normal((B, S, H, P)).astype(np.float32)
    a = (-np.abs(rng.standard_normal((B, S, H))) * 0.5).astype(np.float32)
    Bm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, G, N)).astype(np.float32)
    init = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return xdt, a, Bm, Cm, init


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_segsum():
    a = np.random.default_rng(0).standard_normal((2, 3, 8)).astype(
        np.float32)
    want = np.asarray(JL._segsum(jnp.asarray(a)))
    got = TL.segsum(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("nchunks", [1, 2, 4])
def test_ssd_chunked_against_reference(nchunks, with_init, groups):
    """y and the final state at 1, 2 and 4 chunks, with and without an
    initial state, one group or two (heads share a group's B and C)."""
    xdt, a, Bm, Cm, init = _ssd_inputs(nchunks, G=groups)
    chunk = 32 // nchunks
    jy, jf = JL.ssd_chunked(*map(jnp.asarray, (xdt, a, Bm, Cm)), chunk=chunk,
                            initial_state=jnp.asarray(init) if with_init
                            else None)
    ty, tf = TL.ssd_chunked(*_t(xdt, a, Bm, Cm), chunk=chunk,
                            initial_state=torch.from_numpy(init)
                            if with_init else None)
    assert ty.dtype == torch.float32 and tf.shape == (2, 4, 8, 16)
    assert _close(ty.numpy(), jy) and _close(tf.numpy(), jf)


def test_ssd_keeps_the_activation_dtype():
    xdt, a, Bm, Cm, _ = _ssd_inputs(5)
    y, f = TL.ssd_chunked(torch.from_numpy(xdt).to(torch.bfloat16),
                          *_t(a, Bm, Cm), chunk=8)
    assert y.dtype == torch.bfloat16 and f.dtype == torch.float32


def test_ssd_sequence_must_tile_the_chunk():
    xdt, a, Bm, Cm, _ = _ssd_inputs(0, S=24)
    with pytest.raises(ValueError, match="24.*chunk 16"):
        TL.ssd_chunked(*_t(xdt, a, Bm, Cm), chunk=16)


def _ssd_loss_weights(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 32, 4, 8)).astype(np.float32),
            rng.standard_normal((2, 4, 8, 16)).astype(np.float32))


@pytest.mark.parametrize("nchunks", [1, 4])
def test_ssd_gradients(nchunks):
    """Gradients of sum(y w1) + sum(final w2) with respect to every
    input, the initial state included."""
    xdt, a, Bm, Cm, init = _ssd_inputs(11)
    w1, w2 = _ssd_loss_weights(12)
    chunk = 32 // nchunks

    def jloss(*args):
        y, f = JL.ssd_chunked(*args[:4], chunk=chunk, initial_state=args[4])
        return jnp.sum(y * w1) + jnp.sum(f * w2)
    jg = jax.grad(jloss, argnums=tuple(range(5)))(
        *map(jnp.asarray, (xdt, a, Bm, Cm, init)))
    ts = [t.requires_grad_() for t in _t(xdt, a, Bm, Cm, init)]
    y, f = TL.ssd_chunked(*ts[:4], chunk=chunk, initial_state=ts[4])
    loss = torch.sum(y * torch.from_numpy(w1)) + torch.sum(
        f * torch.from_numpy(w2))
    tg = torch.autograd.grad(loss, ts)
    for name, g, want in zip(("xdt", "a_bar", "B", "C", "init"), tg, jg):
        assert torch.isfinite(g).all(), name
        assert _close(g.numpy(), want), name


def test_dropped_inter_chunk_term_fails_the_gate(monkeypatch):
    """The planted fault: each chunk's prefix state without the chunks
    before it (the inter-chunk term dropped) fails the gate at 4 chunks,
    while the single-chunk scan, which has no such term, still passes."""
    xdt, a, Bm, Cm, _ = _ssd_inputs(4)
    want = {n: JL.ssd_chunked(*map(jnp.asarray, (xdt, a, Bm, Cm)),
                              chunk=32 // n)[0] for n in (1, 4)}
    monkeypatch.setattr(TL, "chunk_prefix",
                        lambda d, s: (torch.cumprod(d, dim=1), s))
    got = {n: TL.ssd_chunked(*_t(xdt, a, Bm, Cm), chunk=32 // n)[0]
           for n in (1, 4)}
    assert _close(got[1].numpy(), want[1])
    assert not _close(got[4].numpy(), want[4])


@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv1d(with_tail):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    tail = rng.standard_normal((2, 3, 12)).astype(np.float32)
    want = JL.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                            prev_tail=jnp.asarray(tail) if with_tail
                            else None)
    got = TL.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                           prev_tail=torch.from_numpy(tail) if with_tail
                           else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_softplus_is_the_reference_formula():
    x = np.linspace(-40, 40, 801).astype(np.float32)
    np.testing.assert_allclose(TL.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


_MIX = {}


def _mixer():
    """mamba2's smoke mixer (d_model 128, 8 heads of 32, d_state 16,
    chunk 8): layer 0 of the reference's initialized tree, with random
    dt_bias, D and norm_w so that every leaf matters."""
    if not _MIX:
        cfg = jget("mamba2-2.7b", smoke=True)
        p = JModel(cfg).init(jax.random.PRNGKey(0))["blocks"]["ssm"]
        p = {k: np.asarray(v[0]) for k, v in p.items()}
        rng = np.random.default_rng(9)
        p["D"] = rng.standard_normal(p["D"].shape).astype(np.float32)
        p["norm_w"] = (1 + 0.1 * rng.standard_normal(
            p["norm_w"].shape)).astype(np.float32)
        p["dt_bias"] = (p["dt_bias"] + rng.standard_normal(
            p["dt_bias"].shape)).astype(np.float32)
        _MIX.update(cfg=cfg, p=p)
    return _MIX["cfg"], _MIX["p"]


def _cache(cfg, rng, B):
    s = cfg.ssm
    conv_dim = cfg.d_inner + 2 * s.n_groups * s.d_state
    return {"ssm": rng.standard_normal(
                (B, cfg.n_ssm_heads, s.head_dim, s.d_state)).astype(
                    np.float32) * 0.1,
            "conv": rng.standard_normal((B, s.d_conv - 1, conv_dim)).astype(
                np.float32)}


@pytest.mark.parametrize("mode", ["train", "recurrence", "chunked"])
def test_mamba2_mix_three_modes(mode):
    """Training/prefill (the scan from zero), the single-token
    recurrence and the chunked prefill seeded from a decode cache: the
    output, the new state and the new conv tail."""
    cfg, p = _mixer()
    rng = np.random.default_rng(3)
    S = {"train": 16, "recurrence": 1, "chunked": 16}[mode]
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    cache = None if mode == "train" else _cache(cfg, rng, 2)
    jout, jst = JL.mamba2_mix(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), cfg.ssm, cfg.d_model,
        decode_cache=None if cache is None else jax.tree.map(jnp.asarray,
                                                             cache))
    tout, tst = TL.mamba2_mix(
        jax.tree.map(torch.from_numpy, p), torch.from_numpy(x), cfg.ssm,
        cfg.d_model, decode_cache=None if cache is None else
        jax.tree.map(torch.from_numpy, cache))
    assert _close(tout.numpy(), jout)
    assert _close(tst["ssm"].numpy(), jst["ssm"])
    assert _close(tst["conv"].numpy(), jst["conv"])     # in_proj's rows


def test_recurrence_equals_the_scan():
    """Sixteen single-token steps from a cache end where one chunked
    prefill of the same tokens from that cache ends (the two decode
    modes the admission rule mixes)."""
    cfg, p = _mixer()
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1, 16, cfg.d_model)).astype(
        np.float32))
    c0 = jax.tree.map(torch.from_numpy, _cache(cfg, rng, 1))
    tp = jax.tree.map(torch.from_numpy, p)
    whole, st = TL.mamba2_mix(tp, x, cfg.ssm, cfg.d_model, decode_cache=c0)
    c, outs = dict(c0), []
    for t in range(16):
        o, c = TL.mamba2_mix(tp, x[:, t:t + 1], cfg.ssm, cfg.d_model,
                             decode_cache=c)
        outs.append(o)
    assert _close(torch.cat(outs, 1).numpy(), whole.numpy())
    assert _close(c["ssm"].numpy(), st["ssm"].numpy())
    assert _close(c["conv"].numpy(), st["conv"].numpy())


def _attn_inputs(seed, B=2, S=12, M=4, H=4, K=2, hd=8):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    mk = rng.standard_normal((B, M, K, hd)).astype(np.float32)
    mv = rng.standard_normal((B, M, K, hd)).astype(np.float32)
    return q, k, v, mk, mv


@pytest.mark.parametrize("window", [0, 5])
def test_training_attention_meta_prefix(window):
    """The meta prefix in front of the keys at positions below M: the
    window never masks it (hymba's training attention)."""
    q, k, v, mk, mv = _attn_inputs(5)
    M = mk.shape[1]
    kf, vf = np.concatenate([mk, k], 1), np.concatenate([mv, v], 1)
    qp = np.arange(q.shape[1]) + M
    want = JL.attention(jnp.asarray(q), jnp.asarray(kf), jnp.asarray(vf),
                        q_pos=jnp.asarray(qp), window=window, meta_tokens=M)
    got = TL.attention(*_t(q, kf, vf), q_pos=torch.from_numpy(qp),
                       window=window, meta_tokens=M)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    if window:   # without the whitelist the window would hide the prefix
        off = TL.attention(*_t(q, kf, vf), q_pos=torch.from_numpy(qp),
                           window=window)
        assert not np.allclose(off.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("window", [0, 5])
def test_cache_attention_meta_prefix(window):
    """decode_attention and chunk_attention with ``meta_kv``: the prefix
    always valid."""
    q, k, v, mk, mv = _attn_inputs(6)
    B, S = q.shape[:2]
    tl = np.array([7, 12], np.int32)
    want = JL.decode_attention(jnp.asarray(q[:, :1]), jnp.asarray(k),
                               jnp.asarray(v), total_len=jnp.asarray(tl),
                               window=window, q_pos=jnp.asarray(tl - 1),
                               meta_kv=(jnp.asarray(mk), jnp.asarray(mv)))
    got = TL.decode_attention(*_t(q[:, :1], k, v),
                              total_len=torch.from_numpy(tl), window=window,
                              meta_kv=tuple(_t(mk, mv)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    qp = np.stack([np.arange(4) + 3, np.arange(4) + 8]).astype(np.int32)
    want = JL.chunk_attention(jnp.asarray(q[:, :4]), jnp.asarray(k),
                              jnp.asarray(v), q_pos=jnp.asarray(qp),
                              window=window,
                              meta_kv=(jnp.asarray(mk), jnp.asarray(mv)))
    got = TL.chunk_attention(*_t(q[:, :4], k, v), q_pos=torch.from_numpy(qp),
                             window=window, meta_kv=tuple(_t(mk, mv)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_configs_match_the_reference():
    """Both configurations, full and smoke, field for field, and the
    published sizes."""
    from repro_torch.configs import get_config as tget
    for arch in ("mamba2-2.7b", "hymba-1.5b"):
        for smoke in (False, True):
            assert dataclasses.asdict(jget(arch, smoke=smoke)) == \
                dataclasses.asdict(tget(arch, smoke=smoke))
    m, h = tget("mamba2-2.7b"), tget("hymba-1.5b")
    assert (m.d_inner, m.n_ssm_heads, m.ssm.d_state, m.ssm.chunk) == \
        (5120, 80, 128, 128)
    assert m.n_params() == 2_702_068_736
    assert h.layer_windows().count(0) == 3 and h.meta_tokens == 128
    assert [i for i, w in enumerate(h.layer_windows()) if w == 0] == \
        [0, 16, 31]
    assert h.n_params() == 1_589_565_696
