"""The port's dense decoder (decode_step, decode_chunk, the training
forward and loss; fixed lanes and paged pool; float32-resident and
quantized weights) against the JAX package on the same parameters,
cache layout and tokens, for yi-6b (untied head) and gemma2-2b (tied
head from codes, sliding window 16 at smoke size, softcaps,
post-sublayer norms, embedding scaling).

Tier: logits within rtol 1e-4 / atol 1e-5 (XLA on the CPU evaluates
rsqrt approximately and contracts into fma, so logits are compared to a
tolerance); the written cache to the same tolerance; gradients of the
loss per leaf within rel L2 1e-5 (the tier of test_torch_train.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models.layers import ShardCtx
from repro.models.model import Model as JModel
from repro.serve import quantized as JQ
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers as TL
from repro_torch.models.model import Model as TModel
from repro_torch.serve import quantized as TQ

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The smoke models' tensors are small: one intra-op thread is faster,
    and the test processes of a parallel run share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(arch):
    jm = JModel(jget(arch, smoke=True))
    tm = TModel(tget(arch, smoke=True))
    return jm, tm, jm.init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def models():
    return _models("yi-6b")


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


@pytest.mark.parametrize("k_x", [None, 6, 2])
@pytest.mark.parametrize("paged", [False, True])
def test_chunk_then_decode_logits(models, k_x, paged):
    jm, tm, jp = models
    if k_x is None:
        jpp, ctx, gather = jp, ShardCtx(), None
    else:
        jpp = JQ.quantize_params(jp, k_x=k_x, min_numel=256, pack=True)
        ctx = ShardCtx(param_gather=JQ.make_dequant_gather())
        gather = TQ.make_dequant_gather()
    tp = params_from_numpy(jax.tree.map(np.asarray, jpp), "cpu")
    B, S = 3, 32
    pool = (12, 8) if paged else None
    jc = jm.init_cache(B, S, page_pool=pool)
    tc = tm.init_cache(B, S, page_pool=pool, device="cpu")
    if paged:   # fragmented tables, a sentinel tail, and slot 1 short
        tab = np.array([[3, 1, 7, 9], [0, 2, 12, 12], [5, 4, 6, 8]], np.int32)
        jc["ptab"] = jnp.asarray(tab)
        tc["ptab"] = torch.from_numpy(tab)
    chunk = jax.jit(lambda p, t, c, s, n: jm.decode_chunk(
        p, {"token": t}, c, s, n, ctx))
    step = jax.jit(lambda p, t, c, pos: jm.decode_step(
        p, {"token": t}, c, pos, ctx))
    rng = np.random.default_rng(7)
    # two chunks and three steps carry the slots to positions 20-23, past
    # gemma2's smoke window of 16
    pos = np.zeros(B, np.int32)
    for nval in (np.array([12, 9, 11], np.int32),
                 np.array([8, 10, 9], np.int32)):
        toks = rng.integers(1, 512, size=(B, 12)).astype(np.int32)
        jl, jc = chunk(jpp, jnp.asarray(toks), jc, jnp.asarray(pos),
                       jnp.asarray(nval))
        tl, tc = tm.decode_chunk(tp, {"token": torch.from_numpy(toks)}, tc,
                                 torch.from_numpy(pos),
                                 torch.from_numpy(nval), gather)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        pos = pos + nval
    for _ in range(3):
        cur = rng.integers(1, 512, size=(B, 1)).astype(np.int32)
        jl, jc = step(jpp, jnp.asarray(cur), jc, jnp.asarray(pos))
        tl, tc = tm.decode_step(tp, {"token": torch.from_numpy(cur)}, tc,
                                torch.from_numpy(pos), gather)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        pos = pos + 1
    for name in (("pk", "pv") if paged else ("k", "v")):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **TOL)
    if paged:
        np.testing.assert_array_equal(tc["ptab"].numpy(),
                                      np.asarray(jc["ptab"]))


def test_released_rows_drop_their_writes(models):
    """Writes at the RELEASED sentinel, past the view, or in a chunk's
    padded tail vanish, as the reference's mode="drop" scatters."""
    _, tm, jp = models
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tc = tm.init_cache(2, 16, page_pool=(4, 8), device="cpu")
    tc["ptab"] = torch.tensor([[4, 4], [1, 4]], dtype=torch.int32)
    before = tc["pk"].clone()
    tm.decode_step(tp, {"token": torch.tensor([[3], [4]])}, tc,
                   torch.tensor([0, 16], dtype=torch.int32))
    assert torch.equal(tc["pk"], before)
    tm.decode_chunk(tp, {"token": torch.tensor([[5, 6, 7, 8]])},
                    {"pk": tc["pk"], "pv": tc["pv"], "ptab": tc["ptab"][1:]},
                    torch.tensor([6]), torch.tensor([1]))
    changed = (tc["pk"] != before).any(dim=(0, 3, 4))      # (pages, ps)
    assert changed.nonzero().tolist() == [[1, 6]]


def test_layers_match_reference():
    from repro.models import layers as JL
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    pos = np.array([[0, 5, 9], [2, 3, 100]], np.int32)
    np.testing.assert_allclose(
        TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 5e6).numpy(),
        np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos), 5e6)), **TOL)
    w = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        TL.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(JL.rmsnorm(jnp.asarray(x), jnp.asarray(w))), **TOL)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((2, 6, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 6, 2, 16)).astype(np.float32)
    tl = np.array([3, 0], np.int32)      # slot 1 has no valid column
    ref = JL.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                              total_len=jnp.asarray(tl),
                              q_pos=jnp.asarray(tl - 1))
    out = TL.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                              torch.from_numpy(vc),
                              total_len=torch.from_numpy(tl))
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_init_leaf_names_and_shapes(models):
    jm, tm, jp = models
    tp = tm.init(seed=0, device="cpu")
    jl = {tuple(k.key for k in path): leaf.shape for path, leaf in
          jax.tree_util.tree_flatten_with_path(jp)[0]}
    tl = {}

    def walk(t, path=()):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                tl[path + (k,)] = tuple(v.shape)
                assert v.dtype == torch.float32
    walk(tp)
    assert jl == tl
    assert float(tp["blocks"]["attn"]["q"].abs().max()) <= 0.04
    again = tm.init(seed=0, device="cpu")
    assert torch.equal(again["embed"], tp["embed"])


def test_unported_features_are_refused():
    """What no family of the reference has is refused by name (an
    unknown arch type, an unknown input mode); every family is ported:
    the SSM and hybrid families and meta tokens
    (``tests/test_torch_ssm_family.py`` holds them against the
    reference) and the encoder-decoder family, whisper-small
    (``tests/test_torch_encdec_family.py``), which builds; QKV bias,
    qk-norm and the local RoPE base are ported, and each matches the
    reference on yi-6b's smoke model with the feature switched on
    (random biases and norm weights: zeros and ones would hide a
    missing term)."""
    import dataclasses
    cfg = tget("yi-6b", smoke=True)
    for change, name in ((dict(arch_type="rnn"), "arch_type rnn"),
                         (dict(input_mode="video"), "input_mode video")):
        with pytest.raises(NotImplementedError, match=name):
            TModel(dataclasses.replace(cfg, **change)).init(device="cpu")
    for ported in (tget("mamba2-2.7b", smoke=True),
                   tget("hymba-1.5b", smoke=True),
                   tget("whisper-small", smoke=True),
                   dataclasses.replace(cfg, meta_tokens=4)):
        TModel(ported).init(device="cpu")
    assert tget("whisper-small").arch_type == "encdec"
    jcfg = jget("yi-6b", smoke=True)
    rng = np.random.default_rng(11)
    toks = rng.integers(1, 512, size=(2, 20)).astype(np.int32)
    for change in (dict(qkv_bias=True), dict(qk_norm=True),
                   dict(rope_theta_local=10_000.0, pattern="lg", window=8)):
        jm = JModel(dataclasses.replace(jcfg, **change))
        tm = TModel(dataclasses.replace(cfg, **change))

        def draw(path, x):
            name = path[-1].key
            if name in ("bq", "bk", "bv"):
                return jnp.asarray(rng.normal(size=x.shape, scale=0.5),
                                   jnp.float32)
            if name in ("q_norm", "k_norm"):
                return jnp.asarray(1 + rng.normal(size=x.shape, scale=0.3),
                                   jnp.float32)
            return x
        jp = jax.tree_util.tree_map_with_path(
            draw, jm.init(jax.random.PRNGKey(0)))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        want, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
        got = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_forward_logits_and_loss_grads(models):
    """The training forward over 24 tokens (past gemma2's smoke window)
    and the loss's gradients, float32 parameters."""
    jm, tm, jp = models
    rng = np.random.default_rng(3)
    toks = rng.integers(1, 512, size=(2, 24)).astype(np.int32)
    tgts = rng.integers(1, 512, size=(2, 24)).astype(np.int32)
    jl, _ = jax.jit(jm.forward)(jp, {"tokens": jnp.asarray(toks)})
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    tl = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    batch = {"tokens": toks, "targets": tgts}
    (jloss, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, batch)
    leaves = {}

    def grad_leaf(path, t):
        leaves[path] = t.requires_grad_()
        return t
    tq = TQ.tree_map_with_path(grad_leaf, tp)
    tloss, _ = tm.loss(tq, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = dict(zip(leaves, torch.autograd.grad(tloss, list(leaves.values()))))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jg)[0]:
        want = np.asarray(leaf)
        got = grads[tuple(k.key for k in path)].numpy()
        rel = np.linalg.norm(want - got) / np.linalg.norm(want)
        assert rel <= 1e-5, (path, rel)


@pytest.mark.parametrize("window,softcap", [(0, None), (5, None),
                                            (0, 50.0), (5, 2.0)])
def test_window_and_softcap_attention_match_reference(window, softcap):
    """The three attention variants with a sliding window and a logit
    softcap (small caps bite harder) against the reference's."""
    from repro.models import layers as JL
    rng = np.random.default_rng(11)
    B, S, H, K, hd = 2, 12, 4, 2, 16
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    kw = dict(window=window, softcap=softcap)
    qpos = np.arange(S, dtype=np.int32)
    for causal in (True, False):
        ref = JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           q_pos=jnp.asarray(qpos), causal=causal, **kw)
        out = TL.attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), q_pos=torch.from_numpy(qpos),
                           causal=causal, **kw)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    tl = np.array([12, 7], np.int32)
    ref = JL.decode_attention(jnp.asarray(q[:, :1]), jnp.asarray(k),
                              jnp.asarray(v), total_len=jnp.asarray(tl),
                              q_pos=jnp.asarray(tl - 1), **kw)
    out = TL.decode_attention(torch.from_numpy(q[:, :1]), torch.from_numpy(k),
                              torch.from_numpy(v),
                              total_len=torch.from_numpy(tl), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    cpos = np.stack([np.arange(4, 8), np.arange(8, 12)]).astype(np.int32)
    ref = JL.chunk_attention(jnp.asarray(q[:, :4]), jnp.asarray(k),
                             jnp.asarray(v), q_pos=jnp.asarray(cpos), **kw)
    out = TL.chunk_attention(torch.from_numpy(q[:, :4]), torch.from_numpy(k),
                             torch.from_numpy(v),
                             q_pos=torch.from_numpy(cpos), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


class TestGemma2:
    """The checks that take ``models``, on gemma2-2b."""

    @pytest.fixture(scope="class")
    def models(self):
        return _models("gemma2-2b")

    test_chunk_then_decode_logits = staticmethod(test_chunk_then_decode_logits)
    test_released_rows_drop_their_writes = staticmethod(
        test_released_rows_drop_their_writes)
    test_init_leaf_names_and_shapes = staticmethod(
        test_init_leaf_names_and_shapes)
    test_forward_logits_and_loss_grads = staticmethod(
        test_forward_logits_and_loss_grads)
