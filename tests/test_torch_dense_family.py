"""The dense family's new members against the JAX package, at smoke size:
gemma3-4b (qk-norm, a local RoPE base, the "lllllg" pattern with window
16 at smoke size, tied head, post-norms, embedding scaling), qwen2.5-14b
(QKV bias, untied head) and llava-next-mistral-7b (the mistral decoder on
embedding input).

Every model is converted from the reference's tree with the QKV biases
and the qk-norm weights drawn from a seeded generator (the reference
initializes them to zeros and ones, which would hide a missing or
swapped term). Tiers: logits and the prefill's cache within rtol 1e-4 /
atol 1e-5 (XLA on the CPU evaluates rsqrt approximately and contracts
into fma); gradients per leaf within rel L2 1e-5; greedy session tokens
identical; the embedding batches and the codes and scale of an all-zero
bias layer bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data.pipeline import batch_for_model as jbatches
from repro.models.layers import ShardCtx
from repro.models.model import Model as JModel
from repro.serve import Request as JRequest
from repro.serve import ServeSession as JSession
from repro.serve import quantized as JQ
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import batch_for_model as tbatches
from repro_torch.models.model import Model as TModel
from repro_torch.serve import quantized as TQ
from repro_torch.serve.session import Request, ServeSession

TOL = dict(rtol=1e-4, atol=1e-5)
ARCHS = ["gemma3-4b", "qwen2.5-14b", "llava-next-mistral-7b"]
SERVED = ["gemma3-4b", "qwen2.5-14b"]
MIXED = [[5, 6, 7, 8], [9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19], [3, 14],
         [21, 22, 23, 24, 25], [7, 8, 9],
         [2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24, 26],
         list(range(30, 51))]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The smoke models' tensors are small: one intra-op thread is faster,
    and the test processes of a parallel run share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomized(jp, seed=5):
    """The reference's tree with random QKV biases and qk-norm weights."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        name = path[-1].key
        if name in ("bq", "bk", "bv"):
            return jnp.asarray(rng.normal(size=x.shape, scale=0.5),
                               jnp.float32)
        if name in ("q_norm", "k_norm"):
            return jnp.asarray(1 + rng.normal(size=x.shape, scale=0.3),
                               jnp.float32)
        return x
    return jax.tree_util.tree_map_with_path(draw, jp)


_MODELS = {}


def _models(arch):
    if arch not in _MODELS:
        jm = JModel(jget(arch, smoke=True))
        tm = TModel(tget(arch, smoke=True))
        _MODELS[arch] = (jm, tm, _randomized(jm.init(jax.random.PRNGKey(0))))
    return _MODELS[arch]


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _inputs(cfg, rng, B, S, key):
    """Token or embedding inputs of shape (B, S), for both packages."""
    if cfg.input_mode == "embeddings":
        e = rng.normal(size=(B, S, cfg.d_model), scale=0.7).astype(np.float32)
        return {"embeds": jnp.asarray(e)}, {"embeds": torch.from_numpy(e)}
    t = rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    return {key: jnp.asarray(t)}, {key: torch.from_numpy(t)}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_leaf_names_and_shapes(arch):
    jm, tm, _ = _models(arch)
    jl = {tuple(k.key for k in path): leaf.shape for path, leaf in
          jax.tree_util.tree_flatten_with_path(
              jax.eval_shape(jm.init, jax.random.PRNGKey(0)))[0]}
    tp = tm.init(seed=0, device="cpu")
    tl = {}

    def walk(t, path=()):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                tl[path + (k,)] = tuple(v.shape)
    walk(tp)
    assert jl == tl
    attn = tp["blocks"]["attn"]
    for name in ("bq", "bk", "bv"):
        if name in attn:
            assert not attn[name].any()
    for name in ("q_norm", "k_norm"):
        if name in attn:
            assert bool((attn[name] == 1).all())


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_grads_and_prefill(arch):
    """The training forward over 24 tokens (past gemma3's smoke window),
    the loss's gradients, and the whole-prompt prefill's logits and
    padded cache, float32 and quantized."""
    jm, tm, jp = _models(arch)
    cfg = tm.cfg
    rng = np.random.default_rng(3)
    jb, tb = _inputs(cfg, rng, 2, 24, "tokens")
    tgts = rng.integers(1, cfg.vocab_size, size=(2, 24)).astype(np.int32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jl, _ = jax.jit(jm.forward)(jp, jb)
    np.testing.assert_allclose(_np(tm.forward(tp, tb)), _np(jl), **TOL)

    jbatch = dict(jb, targets=jnp.asarray(tgts))
    (jloss, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, jbatch)
    leaves = {}

    def grad_leaf(path, t):
        leaves[path] = t.requires_grad_()
        return t
    tq = TQ.tree_map_with_path(grad_leaf, tp)
    tloss, _ = tm.loss(tq, dict(tb, targets=torch.from_numpy(tgts)))
    grads = dict(zip(leaves, torch.autograd.grad(
        tloss, list(leaves.values()), allow_unused=True)))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jg)[0]:
        want = np.asarray(leaf)
        got = grads[tuple(k.key for k in path)]
        if not np.any(want):     # the unused embedding of an embeds model
            assert got is None or not got.any(), path
            continue
        got = got.numpy()
        rel = np.linalg.norm(want - got) / np.linalg.norm(want)
        assert rel <= 1e-5, (path, rel)

    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jq = JQ.quantize_params(jp, k_x=6, min_numel=256, pack=True)
    tqp = params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")
    for jpp, tpp, ctx, gather in (
            (jp, tp, ShardCtx(), None),
            (jq, tqp, ShardCtx(param_gather=JQ.make_dequant_gather()),
             TQ.make_dequant_gather())):
        jlog, jcache = jm.prefill(jpp, jb, 32, ctx=ctx)
        tlog, tcache = tm.prefill(tpp, tb, 32, gather=gather)
        np.testing.assert_allclose(_np(tlog), _np(jlog), **TOL)
        for name in ("k", "v"):
            assert tcache[name].shape == jcache[name].shape
            np.testing.assert_allclose(_np(tcache[name]), _np(jcache[name]),
                                       **TOL)


@pytest.mark.parametrize("k_x", [None, 6])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_chunk_then_decode_logits(arch, paged, k_x):
    """Two chunks and three decode steps carry 3 slots to positions
    20-23, past gemma3's smoke window; fixed lanes and a fragmented page
    table; float32 and quantized weights."""
    jm, tm, jp = _models(arch)
    cfg = tm.cfg
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
    if paged:
        tab = np.array([[3, 1, 7, 9], [0, 2, 12, 12], [5, 4, 6, 8]], np.int32)
        jc["ptab"] = jnp.asarray(tab)
        tc["ptab"] = torch.from_numpy(tab)
    chunk = jax.jit(lambda p, i, c, s, n: jm.decode_chunk(p, i, c, s, n, ctx))
    step = jax.jit(lambda p, i, c, pos: jm.decode_step(p, i, c, pos, ctx))
    rng = np.random.default_rng(7)
    pos = np.zeros(B, np.int32)
    for nval in (np.array([12, 9, 11], np.int32),
                 np.array([8, 10, 9], np.int32)):
        ji, ti = _inputs(cfg, rng, B, 12, "token")
        jl, jc = chunk(jpp, ji, jc, jnp.asarray(pos), jnp.asarray(nval))
        tl, tc = tm.decode_chunk(tp, ti, tc, torch.from_numpy(pos),
                                 torch.from_numpy(nval), gather)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        pos = pos + nval
    for _ in range(3):
        ji, ti = _inputs(cfg, rng, B, 1, "token")
        jl, jc = step(jpp, ji, jc, jnp.asarray(pos))
        tl, tc = tm.decode_step(tp, ti, tc, torch.from_numpy(pos), gather)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        pos = pos + 1
    for name in (("pk", "pv") if paged else ("k", "v")):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **TOL)


@pytest.mark.parametrize("arch", SERVED)
def test_quantized_paged_session_matches_reference(arch):
    """A quantized, paged, chunked-prefill session: greedy tokens identical
    to the reference's session, and the counters both keep equal."""
    jm, tm, jp = _models(arch)
    jq = JQ.quantize_params(jp, k_x=6, min_numel=256, pack=True)
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), "cpu")
    kw = dict(slots=3, max_seq=48, paged=True, page_size=8, prefill_chunk=4)
    js = JSession(jm, jq, **kw)
    jh = [js.submit(JRequest(prompt=p, max_new_tokens=6)) for p in MIXED]
    jr = js.drain()
    ts = ServeSession(tm, tq, device="cpu", **kw)
    th = [ts.submit(Request(prompt=p, max_new_tokens=6)) for p in MIXED]
    tr = ts.drain()
    assert [tr[h].tokens for h in th] == [jr[h].tokens for h in jh]
    assert ts.free_pages == ts.num_pages
    # the scheduler's counters (the compile counters count XLA compiles
    # there and nvcc builds here)
    shared = set(ts.stats) & set(js.stats) - {"compilations", "aot_loads"}
    assert {"dispatches", "syncs", "admitted", "chunk_dispatches"} <= shared
    assert {k: ts.stats[k] for k in shared} == {k: js.stats[k] for k in shared}
    assert ts.stats["captures"] == ts.stats["replays"] == 0   # the CPU


def test_gemma3_window_and_local_base_are_live():
    """A decode past gemma3's smoke window (16) changes with every window
    off, and with the local RoPE base set to the global one: both
    features bite, and the port matches the reference in each variant."""
    jm0, tm0, jp = _models("gemma3-4b")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(9)
    prompt = rng.integers(1, 512, size=(1, 24)).astype(np.int32)
    cur = np.array([[17]], np.int32)
    out = {}
    for name, change in (("base", {}), ("global", dict(window=None)),
                         ("one_theta", dict(rope_theta_local=None))):
        jm = JModel(dataclasses.replace(jm0.cfg, **change))
        tm = TModel(dataclasses.replace(tm0.cfg, **change))
        jc, tc = jm.init_cache(1, 32), tm.init_cache(1, 32, device="cpu")
        _, jc = jm.decode_chunk(jp, {"token": jnp.asarray(prompt)}, jc,
                                jnp.asarray([0]), jnp.asarray([24]))
        _, tc = tm.decode_chunk(tp, {"token": torch.from_numpy(prompt)}, tc,
                                torch.tensor([0]), torch.tensor([24]))
        jl, _ = jm.decode_step(jp, {"token": jnp.asarray(cur)}, jc,
                               jnp.asarray([24]))
        tl, _ = tm.decode_step(tp, {"token": torch.from_numpy(cur)}, tc,
                               torch.tensor([24], dtype=torch.int32))
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        out[name] = _np(tl)
    assert np.abs(out["base"] - out["global"]).max() > 1e-3
    assert np.abs(out["base"] - out["one_theta"]).max() > 1e-3


def test_llava_embedding_batches_bitwise():
    cfg_j = jget("llava-next-mistral-7b", smoke=True)
    cfg_t = tget("llava-next-mistral-7b", smoke=True)
    jit_, tit = jbatches(cfg_j, 16, 3, seed=4), tbatches(cfg_t, 16, 3, seed=4)
    for _ in range(3):
        jb, tb = next(jit_), next(tit)
        assert sorted(jb) == sorted(tb) == ["embeds", "mask", "targets"]
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(tb[k], jb[k])
    # token models keep the reference's token batches
    jb = next(jbatches(jget("qwen2.5-14b", smoke=True), 16, 3, seed=4))
    tb = next(tbatches(tget("qwen2.5-14b", smoke=True), 16, 3, seed=4))
    assert sorted(jb) == sorted(tb)
    for k in jb:
        np.testing.assert_array_equal(tb[k], jb[k])


def test_zero_bias_layers_quantize_bitwise():
    """qwen's stacked QKV biases are quantized per layer; at init every
    layer is zero, so the reference's scale is its 1e-30 floor and every
    code 0. The port gives that scale and those codes bitwise, no NaN,
    also for a stack whose other layer is not zero."""
    jm, _, _ = _models("qwen2.5-14b")
    jp0 = jm.init(jax.random.PRNGKey(0))
    bq = np.asarray(jp0["blocks"]["attn"]["bq"])
    assert not bq.any()
    mixed = bq.copy()
    mixed[1] = np.random.default_rng(2).normal(size=mixed.shape[1])
    for arr in (bq, mixed):
        tree = {"blocks": {"attn": {"bq": arr}}}
        jl = JQ.quantize_params(jax.tree.map(jnp.asarray, tree), k_x=6,
                                min_numel=16)["blocks"]["attn"]["bq"]
        tl = TQ.quantize_params(params_from_numpy(tree, "cpu"), k_x=6,
                                min_numel=16)["blocks"]["attn"]["bq"]
        assert TQ.is_qleaf(tl) and tl.scale.shape == (2,)
        np.testing.assert_array_equal(tl.codes.numpy(), np.asarray(jl.codes))
        np.testing.assert_array_equal(tl.scale.numpy().view(np.uint32),
                                      np.asarray(jl.scale).view(np.uint32))
        assert float(tl.scale[0]) == np.float32(1e-30)
        deq = tl.layer(0).dequantize()
        assert torch.isfinite(deq).all() and not deq.any()
