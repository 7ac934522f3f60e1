"""The MoE family against the JAX package, at smoke size:
deepseek-moe-16b (2 layers, 4 experts top-2, 1 shared) and
llama4-maverick-400b-a17b (4 experts top-1, 1 shared, GQA 8 over 2).

Every model is converted from the reference's tree. Tiers: forward
logits, the loss (its aux term included) and the prefill's, chunk's and
decode step's logits within rtol 1e-4 / atol 1e-5 (XLA on the CPU
evaluates rsqrt approximately and contracts into fma); gradients within
the reference's own sort-vs-einsum tolerance, rtol 2e-4 / atol 1e-5;
greedy session tokens identical under chunked, whole and injected
admission at the default capacity factor (each admission routes another
number of tokens a call, so each drops other tokens); the quantized
tree's codes and scales bitwise. Also the launchers' CPU smokes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models.layers import ShardCtx
from repro.models.model import Model as JModel
from repro.serve import Request as JRequest
from repro.serve import ServeSession as JSession
from repro.serve import quantized as JQ
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.models.model import Model as TModel
from repro_torch.serve import quantized as TQ
from repro_torch.serve.session import Request, ServeSession

TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=1e-5)
ARCHS = ["deepseek-moe-16b", "llama4-maverick-400b-a17b"]
MIXED = [[5, 6, 7, 8], [9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19], [3, 14],
         [21, 22, 23, 24, 25], [7, 8, 9],
         [2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24, 26],
         list(range(30, 51)), [17]]
MODES = [dict(paged=True, page_size=8, prefill_chunk=4),
         dict(prefill="whole"), dict(prefill="inject"),
         dict(prefill="inject", paged=True, page_size=8)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The smoke models' tensors are small: one intra-op thread is faster,
    and the test processes of a parallel run share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def _models(arch):
    if arch not in _MODELS:
        jm = JModel(jget(arch, smoke=True))
        tm = TModel(tget(arch, smoke=True))
        _MODELS[arch] = (jm, tm, jm.init(jax.random.PRNGKey(0)))
    return _MODELS[arch]


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _tokens(cfg, rng, B, S, key):
    t = rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    return {key: jnp.asarray(t)}, {key: torch.from_numpy(t)}


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_leaves(arch):
    """The reference's configurations, full and smoke, and its leaf names
    and shapes (router, the (E, d, fe) expert stacks, shared experts)."""
    for smoke in (False, True):
        jc, tc = jget(arch, smoke=smoke), tget(arch, smoke=smoke)
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert tget(arch).moe.dispatch == "einsum"
    jm, tm, _ = _models(arch)
    jl = {tuple(k.key for k in path): leaf.shape for path, leaf in
          jax.tree_util.tree_flatten_with_path(
              jax.eval_shape(jm.init, jax.random.PRNGKey(0)))[0]}
    tl = {}

    def walk(t, path=()):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                tl[path + (k,)] = tuple(v.shape)
    walk(tm.init(seed=0, device="cpu"))
    assert jl == tl
    assert ("blocks", "moe", "shared", "w_up") in tl
    assert ("blocks", "mlp", "w_up") not in tl


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads(arch, dispatch):
    """The training forward over 24 tokens, the loss with its aux term,
    and the loss's gradients of every leaf, under both dispatches."""
    jm0, tm0, jp = _models(arch)
    jm = JModel(dataclasses.replace(jm0.cfg, moe=dataclasses.replace(
        jm0.cfg.moe, dispatch=dispatch)))
    tm = TModel(dataclasses.replace(tm0.cfg, moe=dataclasses.replace(
        tm0.cfg.moe, dispatch=dispatch)))
    rng = np.random.default_rng(3)
    jb, tb = _tokens(tm.cfg, rng, 2, 24, "tokens")
    tgts = rng.integers(1, tm.cfg.vocab_size, size=(2, 24)).astype(np.int32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jl, jaux = jax.jit(jm.forward)(jp, jb)
    tl, taux = tm.forward_with_aux(tp, tb)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    assert float(taux) > 0
    assert torch.equal(tm.forward(tp, tb), tl)

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
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **TOL)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jg)[0]:
        np.testing.assert_allclose(
            grads[tuple(k.key for k in path)].numpy(), np.asarray(leaf),
            err_msg=str(path), **GRAD_TOL)


@pytest.mark.parametrize("k_x", [None, 6])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_and_decode_logits(arch, k_x):
    """The whole-prompt prefill's logits and cache, then two chunks and
    three decode steps of 3 slots on a fragmented page table; float32
    and quantized weights (the expert stacks dequantized at use)."""
    jm, tm, jp = _models(arch)
    cfg = tm.cfg
    if k_x is None:
        jpp, ctx, gather = jp, ShardCtx(), None
    else:
        jpp = JQ.quantize_params(jp, k_x=k_x, min_numel=256, pack=True)
        ctx = ShardCtx(param_gather=JQ.make_dequant_gather())
        gather = TQ.make_dequant_gather()
    tp = params_from_numpy(jax.tree.map(np.asarray, jpp), "cpu")
    rng = np.random.default_rng(7)
    jb, tb = _tokens(cfg, rng, 2, 12, "tokens")
    jlog, jcache = jm.prefill(jpp, jb, 32, ctx=ctx)
    tlog, tcache = tm.prefill(tp, tb, 32, gather=gather)
    np.testing.assert_allclose(_np(tlog), _np(jlog), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[name]), _np(jcache[name]),
                                   **TOL)
    B, S = 3, 32
    jc = jm.init_cache(B, S, page_pool=(12, 8))
    tc = tm.init_cache(B, S, page_pool=(12, 8), device="cpu")
    tab = np.array([[3, 1, 7, 9], [0, 2, 12, 12], [5, 4, 6, 8]], np.int32)
    jc["ptab"], tc["ptab"] = jnp.asarray(tab), torch.from_numpy(tab)
    chunk = jax.jit(lambda p, i, c, s, n: jm.decode_chunk(p, i, c, s, n, ctx))
    step = jax.jit(lambda p, i, c, pos: jm.decode_step(p, i, c, pos, ctx))
    pos = np.zeros(B, np.int32)
    for nval in (np.array([12, 9, 11], np.int32),
                 np.array([8, 10, 9], np.int32)):
        ji, ti = _tokens(cfg, rng, B, 12, "token")
        jl, jc = chunk(jpp, ji, jc, jnp.asarray(pos), jnp.asarray(nval))
        tl, tc = tm.decode_chunk(tp, ti, tc, torch.from_numpy(pos),
                                 torch.from_numpy(nval), gather)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        pos = pos + nval
    for _ in range(3):
        ji, ti = _tokens(cfg, rng, B, 1, "token")
        jl, jc = step(jpp, ji, jc, jnp.asarray(pos))
        tl, tc = tm.decode_step(tp, ti, tc, torch.from_numpy(pos), gather)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        pos = pos + 1
    for name in ("pk", "pv"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]), **TOL)


_QUANT = {}


def _quantized(arch):
    if arch not in _QUANT:
        jm, tm, jp = _models(arch)
        jq = JQ.quantize_params(jp, k_x=6, min_numel=256, pack=True)
        _QUANT[arch] = (jq, params_from_numpy(jax.tree.map(np.asarray, jq),
                                              "cpu"))
    return _QUANT[arch]


@pytest.mark.parametrize("mode", MODES, ids=lambda m: "-".join(
    str(v) for v in m.values()))
@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_session_matches_reference(arch, mode, monkeypatch):
    """A quantized session under chunked, whole and injected admission:
    greedy tokens identical to the reference's session. The capacity
    factor is the default, so pairs are dropped (asserted from the
    routes the port's layers took), and how many depends on the
    admission (the routed token count of each call)."""
    from repro_torch.models import layers as TL
    jm, tm, _ = _models(arch)
    jq, tq = _quantized(arch)
    js = JSession(jm, jq, slots=3, max_seq=48, **mode)
    jh = [js.submit(JRequest(prompt=p, max_new_tokens=6)) for p in MIXED]
    jr = js.drain()
    route, drops = TL.moe_route, []

    def watched(params, xt, mcfg, backend=None):
        probs, vals, idx = route(params, xt, mcfg, backend)
        load = torch.bincount(idx.reshape(-1), minlength=mcfg.n_experts)
        drops.append(int(torch.clamp_min(
            load - TL.capacity(xt.shape[0], mcfg), 0).sum()))
        return probs, vals, idx
    monkeypatch.setattr(TL, "moe_route", watched)
    ts = ServeSession(tm, tq, slots=3, max_seq=48, device="cpu", **mode)
    th = [ts.submit(Request(prompt=p, max_new_tokens=6)) for p in MIXED]
    tr = ts.drain()
    assert [tr[h].tokens for h in th] == [jr[h].tokens for h in jh]
    for key in ("dispatches", "admitted", "chunk_dispatches"):
        assert ts.stats[key] == js.stats[key], key
    assert sum(drops) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_params_and_fusion(arch):
    """``quantize_params`` of the MoE tree: codes and scales bitwise the
    reference's. The expert stacks (L, E, d, f) are not matmul-shaped
    and dequantize at use; the router and the shared experts stay codes
    for K1; a dequantized stack is bitwise the reference's."""
    jq, tq = _quantized(arch)
    tmine = TQ.quantize_params(params_from_numpy(
        jax.tree.map(np.asarray, _models(arch)[2]), "cpu"), k_x=6,
        min_numel=256, pack=True)
    moe_j, moe_t = jq["blocks"]["moe"], tmine["blocks"]["moe"]
    for name in ("router", "w_gate", "w_up", "w_down"):
        j, t = moe_j[name], moe_t[name]
        np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
        np.testing.assert_array_equal(t.scale.numpy().view(np.uint32),
                                      np.asarray(j.scale).view(np.uint32))
    for name in ("w_gate", "w_up", "w_down"):
        j, t = moe_j["shared"][name], moe_t["shared"][name]
        np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
    moe = tq["blocks"]["moe"]
    path = ("moe",)
    for name in ("w_gate", "w_up", "w_down"):
        leaf = moe[name].layer(1)
        assert len(leaf.shape) == 4
        assert not TQ._fused_ok(path + (name,), leaf, "blocks")
        want = np.asarray(jq["blocks"]["moe"][name].dequantize()[1])
        np.testing.assert_array_equal(leaf.dequantize().numpy(), want)
        assert TQ._fused_ok(path + ("shared", name),
                            moe["shared"][name].layer(1), "blocks")
    assert TQ._fused_ok(path + ("router",), moe["router"].layer(0), "blocks")
    one = TQ.make_dequant_gather()(TQ.layer_slice(tq["blocks"], 0),
                                   "blocks")["moe"]
    assert TQ.is_qleaf(one["router"]) and TQ.is_qleaf(one["shared"]["w_up"])
    assert isinstance(one["w_gate"], torch.Tensor)


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_smoke_on_cpu(arch, capsys):
    """``launch.serve`` (quantized, paged) and ``launch.train``
    (Algorithms 2+3 on one gloo rank) at smoke size on the CPU."""
    from repro_torch.launch import serve, train
    results = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--quantized", "--paged", "--requests", "3",
                          "--max-new", "4"])
    assert all(len(r.tokens) == 4 for r in results.values())
    r = train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                    "3", "--seq", "16", "--global-batch", "2",
                    "--log-every", "1"])
    losses = [h["loss"] for h in r["history"]]
    assert len(losses) == 3 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    assert f"arch={arch}" in out
