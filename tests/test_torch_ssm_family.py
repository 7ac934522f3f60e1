"""The SSM and hybrid family against the JAX package, at smoke size:
mamba2-2.7b (2 SSD layers, d_model 128, 8 heads of 32, d_state 16,
chunk 8) and hymba-1.5b (2 layers of attention and SSD heads side by
side, window 16, 8 meta tokens). Tier 1.

Every model is converted from the reference's tree. Tiers: forward
logits, the loss and the prefill's, chunk's and decode step's logits and
caches within rtol 1e-4 / atol 1e-5 (XLA on the CPU evaluates rsqrt
approximately and contracts into fma, and the SSD scan groups its
float32 sums differently: ``tests/test_torch_ssm.py``); gradients
within rtol 2e-4 / atol 1e-5; greedy session tokens identical under
chunked, whole and injected admission, where the reference's top-1 /
top-2 logit gap at every emitted token exceeds the logits' tolerance
(checked from the port's own logits); the admission mode picked as the
reference's session picks it; the quantized tree's leaf kinds and codes
bitwise. Also the launchers' CPU smokes.
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
ARCHS = ["mamba2-2.7b", "hymba-1.5b"]
# prompt lengths around the smoke SSD chunk (8): chunked, whole, inject
PROMPTS = [list(range(3, 19)), list(range(20, 28)), [5, 6, 7],
           list(range(30, 54)), list(range(40, 49)), list(range(60, 76))]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
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


def _leaf_shapes(tree, path=(), out=None):
    out = {} if out is None else out
    for k, v in tree.items():
        if isinstance(v, dict):
            _leaf_shapes(v, path + (k,), out)
        else:
            out[path + (k,)] = tuple(v.shape)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_leaves_match_the_reference(arch):
    """The port's ``Model.init`` has the reference's leaf names and
    shapes (an SSM block ``ln1`` + ``ssm``; hymba's meta banks, its
    never-read ``init_state`` and the two output norms), and its SSM
    leaves follow the reference's rules: dt_bias the inverse softplus of
    dt in [1e-3, 0.1], A_log = log(h % 15 + 1)."""
    jm, tm, _ = _models(arch)
    jl = {tuple(k.key for k in path): leaf.shape for path, leaf in
          jax.tree_util.tree_flatten_with_path(
              jax.eval_shape(jm.init, jax.random.PRNGKey(0)))[0]}
    tp = tm.init(seed=0, device="cpu")
    assert jl == _leaf_shapes(tp)
    ssm = tp["blocks"]["ssm"]
    dt = torch.nn.functional.softplus(ssm["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 0.1 * (1 + 1e-5)
    H = tm.cfg.n_ssm_heads
    want = np.log(np.arange(1, H + 1, dtype=np.float32) % 15 + 1.0)
    np.testing.assert_allclose(ssm["A_log"][1].numpy(), want, rtol=1e-6)
    if arch == "hymba-1.5b":
        assert ("blocks", "attn", "meta_k") in jl
        assert not torch.any(ssm["init_state"])
    else:
        assert ("blocks", "attn", "q") not in jl


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads(arch):
    """The training forward over 2 x 24 tokens (3 SSD chunks), the loss
    and its gradient of every leaf."""
    jm, tm, jp = _models(arch)
    rng = np.random.default_rng(3)
    jb, tb = _tokens(tm.cfg, rng, 2, 24, "tokens")
    tgts = rng.integers(1, tm.cfg.vocab_size, size=(2, 24)).astype(np.int32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jl, _ = jax.jit(jm.forward)(jp, jb)
    tl = tm.forward(tp, tb)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)

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
        key = tuple(k.key for k in path)
        g = grads[key]
        if g is None:          # init_state: never read, as the reference's
            assert key[-1] == "init_state"
            assert not np.any(np.asarray(leaf))
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(leaf),
                                   err_msg=str(path), **GRAD_TOL)


@pytest.mark.parametrize("k_x", [None, 6])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunk_and_decode(arch, k_x):
    """The whole-prompt prefill's logits and caches (K/V, SSM state,
    conv tail), then two 8-token chunks and three decode steps of 3
    slots (hymba on a fragmented page table); float32 and quantized
    weights (conv_w, norms and meta banks dequantized at use)."""
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
    jb, tb = _tokens(cfg, rng, 2, 16, "tokens")
    jlog, jcache = jm.prefill(jpp, jb, 32, ctx=ctx)
    tlog, tcache = tm.prefill(tp, tb, 32, gather=gather)
    np.testing.assert_allclose(_np(tlog), _np(jlog), **TOL)
    assert set(tcache) == set(jcache)
    for name in tcache:
        np.testing.assert_allclose(_np(tcache[name]), _np(jcache[name]),
                                   err_msg=name, **TOL)
    B, S = 3, 32
    paged = arch == "hymba-1.5b"
    pool = (12, 8) if paged else None
    jc = jm.init_cache(B, S, page_pool=pool)
    tc = tm.init_cache(B, S, page_pool=pool, device="cpu")
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}
    assert tc["ssm"].dtype == torch.float32
    if paged:
        tab = np.array([[3, 1, 7, 9], [0, 2, 12, 12], [5, 4, 6, 8]],
                       np.int32)
        jc["ptab"], tc["ptab"] = jnp.asarray(tab), torch.from_numpy(tab)
    chunk = jax.jit(lambda p, i, c, s, n: jm.decode_chunk(p, i, c, s, n, ctx))
    step = jax.jit(lambda p, i, c, pos: jm.decode_step(p, i, c, pos, ctx))
    pos = np.zeros(B, np.int32)
    nval = np.full(B, 8, np.int32)
    for _ in range(2):
        ji, ti = _tokens(cfg, rng, B, 8, "token")
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
    for name in tc:
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]),
                                   err_msg=name, **TOL)


def test_inactive_rows_keep_their_state():
    """``decode_step(write=...)``: the rows where it is False keep their
    SSM state and conv tail (the reference's step reverts them)."""
    _, tm, jp = _models("hymba-1.5b")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    cache = tm.init_cache(2, 16, device="cpu")
    cache["ssm"].normal_(generator=torch.Generator().manual_seed(1))
    before = {k: v.clone() for k, v in cache.items()}
    tm.decode_step(tp, {"token": torch.tensor([[5], [6]])}, cache,
                   torch.tensor([3, 4]), write=torch.tensor([True, False]))
    for name in ("ssm", "conv"):
        assert torch.equal(cache[name][:, 1], before[name][:, 1])
        assert not torch.equal(cache[name][:, 0], before[name][:, 0])


ADMISSION = [dict(prefill_chunk=16), dict(prefill_chunk=8),
             dict(prefill_chunk=12), dict(prefill_chunk=16, paged=True,
                                          page_size=8),
             dict(prefill="whole"), dict(prefill="inject")]


@pytest.mark.parametrize("arch", ARCHS)
def test_admission_table(arch):
    """The admission mode of prompts of 1-33 tokens around the SSD chunk
    of 8, under every prefill setting: the reference's choice."""
    jm, tm, jp = _models(arch)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    seen = set()
    for kw in ADMISSION:
        if kw.get("paged") and arch == "mamba2-2.7b":
            for S in (JSession, ServeSession):
                with pytest.raises(ValueError, match="no KV cache to page"):
                    if S is JSession:
                        S(jm, jp, slots=2, max_seq=48, **kw)
                    else:
                        S(tm, tp, slots=2, max_seq=48, device="cpu", **kw)
            continue
        js = JSession(jm, jp, slots=2, max_seq=48, **kw)
        ts = ServeSession(tm, tp, slots=2, max_seq=48, device="cpu", **kw)
        for plen in range(1, 34):
            mode = ts._admission_mode(plen)
            assert mode == js._admission_mode(plen), (kw, plen)
            seen.add(mode)
    assert seen == {"chunked", "whole", "inject"}


_QUANT = {}


def _quantized(arch):
    if arch not in _QUANT:
        jm, tm, jp = _models(arch)
        jq = JQ.quantize_params(jp, k_x=6, min_numel=256, pack=True)
        _QUANT[arch] = (jq, params_from_numpy(jax.tree.map(np.asarray, jq),
                                              "cpu"))
    return _QUANT[arch]


def _gap_ok(tm, tq, prompts, results, tol):
    """Every emitted token's top-1 / top-2 gap in the port's logits
    (recomputed by an unbatched prefill of prompt + tokens) exceeds
    ``tol``, so a float32 rounding cannot flip it."""
    gather = TQ.make_dequant_gather()
    c = tm.cfg.ssm.chunk
    for prompt, toks in zip(prompts, results):
        seq = list(prompt) + list(toks[:-1])
        seq += [0] * (-len(seq) % c)   # causal: the tail changes nothing
        t = torch.tensor([seq], dtype=torch.int32)
        lg, _ = tm.prefill(tq, {"tokens": t}, len(seq), gather=gather)
        lg = lg[:, :len(prompt) + len(toks) - 1]
        top = torch.topk(lg[0, len(prompt) - 1:], 2, dim=-1).values
        if float((top[:, 0] - top[:, 1]).min()) <= tol:
            return False
    return True


MODES = [dict(prefill_chunk=8), dict(prefill="whole"),
         dict(prefill="inject"), dict(prefill_chunk=16, paged=True,
                                      page_size=8)]
# pure SSM refuses paging (test_admission_table holds the refusal)
SESSIONS = [(arch, mode) for arch in ARCHS for mode in MODES
            if not (mode.get("paged") and arch == "mamba2-2.7b")]


@pytest.mark.parametrize("arch,mode", SESSIONS, ids=lambda v: v if
                         isinstance(v, str) else "-".join(
                             str(x) for x in v.values()))
def test_quantized_session_matches_reference(arch, mode):
    """A quantized session of 3 slots under chunked, whole and injected
    admission (the prompts mix all three where the mode allows): greedy
    tokens identical to the reference's session, and the same dispatch
    counts."""
    jm, tm, _ = _models(arch)
    jq, tq = _quantized(arch)
    js = JSession(jm, jq, slots=3, max_seq=48, **mode)
    jh = [js.submit(JRequest(prompt=p, max_new_tokens=6)) for p in PROMPTS]
    jr = js.drain()
    ts = ServeSession(tm, tq, slots=3, max_seq=48, device="cpu", **mode)
    th = [ts.submit(Request(prompt=p, max_new_tokens=6)) for p in PROMPTS]
    tr = ts.drain()
    want = [jr[h].tokens for h in jh]
    got = [tr[h].tokens for h in th]
    assert _gap_ok(tm, tq, PROMPTS, want, 1e-4)
    assert got == want
    for key in ("dispatches", "admitted", "chunk_dispatches"):
        assert ts.stats[key] == js.stats[key], key


def _batch_mates(model, params, **kw):
    alone = ServeSession(model, params, slots=1, max_seq=48, device="cpu",
                         **kw)
    h = alone.submit(Request(prompt=[5, 6, 7], max_new_tokens=6))
    want = alone.drain()[h].tokens
    sess = ServeSession(model, params, slots=2, max_seq=48, device="cpu",
                        **kw)
    h1 = sess.submit(Request(prompt=[5, 6, 7], max_new_tokens=6))
    h2 = sess.submit(Request(prompt=list(range(9, 21)), max_new_tokens=12))
    h3 = sess.submit(Request(prompt=[5, 6, 7], max_new_tokens=6))
    res = sess.drain()
    return want, res[h1].tokens, res[h3].tokens, res[h2].prompt_len


def test_tokens_independent_of_batch_mates(monkeypatch):
    """The reference's ``test_tokens_independent_of_batch_mates[mamba2]``:
    a request's greedy tokens do not depend on its batch mates, also
    when it is admitted into a slot freed mid-flight, whose SSM state and
    conv tail must be zeroed first; and they are the reference's. With
    the zeroing planted out, the reused slot's tokens change."""
    jm, tm, jp = _models("mamba2-2.7b")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    js = JSession(jm, jp, slots=1, max_seq=48)
    h = js.submit(JRequest(prompt=[5, 6, 7], max_new_tokens=6))
    ref = js.drain()[h].tokens
    want, t1, t3, plen = _batch_mates(tm, tp)
    assert want == ref and t1 == want and t3 == want and plen == 12

    def no_zeroing(self, slot, ptab_row):
        if self.paged:
            self._state["cache"]["ptab"][slot] = self._to_dev(ptab_row,
                                                              torch.int32)
    monkeypatch.setattr(ServeSession, "_claim_cache", no_zeroing)
    _, t1, t3, _ = _batch_mates(tm, tp)
    assert t1 == want and t3 != want


@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_leaf_kinds(arch):
    """``quantize_params`` of the family's tree: the leaf kinds of the
    reference's rules (in_proj/out_proj code-resident for K1; conv_w,
    the stacked norms and the meta banks dequantized whole at use, K12;
    A_log, D, dt_bias float under ``min_numel``) and codes and scales
    bitwise the reference's, at the default ``min_numel`` and at 256."""
    jm, tm, jp = _models(arch)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    for min_numel in (2 ** 14, 256):
        jq = JQ.quantize_params(jp, k_x=6, min_numel=min_numel, pack=True)
        tq = TQ.quantize_params(tp, k_x=6, min_numel=min_numel, pack=True)
        jflat = {tuple(k.key for k in path): leaf for path, leaf in
                 jax.tree_util.tree_flatten_with_path(
                     jq, is_leaf=JQ._is_qleaf)[0]}

        def walk(t, path=()):
            for k, v in t.items():
                if isinstance(v, dict):
                    yield from walk(v, path + (k,))
                else:
                    yield path + (k,), v
        tflat = dict(walk(tq))
        assert set(tflat) == set(jflat)
        for path, t in tflat.items():
            j = jflat[path]
            assert TQ.is_qleaf(t) == JQ._is_qleaf(j), path
            if TQ.is_qleaf(t):
                np.testing.assert_array_equal(t.codes.numpy(),
                                              np.asarray(j.codes))
                assert t.pack_bits == j.pack_bits
    one = TQ.make_dequant_gather()(TQ.layer_slice(tq["blocks"], 0),
                                   "blocks")
    assert TQ.is_qleaf(one["ssm"]["in_proj"])
    assert TQ.is_qleaf(one["ssm"]["out_proj"])
    for name in ("conv_w", "norm_w", "A_log", "D", "dt_bias"):
        assert isinstance(one["ssm"][name], torch.Tensor), name
    assert TQ.is_qleaf(tq["blocks"]["ssm"]["conv_w"])
    for name in ("A_log", "D", "dt_bias"):
        assert not TQ.is_qleaf(tq["blocks"]["ssm"][name])
    if arch == "hymba-1.5b":
        assert TQ.is_qleaf(tq["blocks"]["attn"]["meta_k"])
        assert isinstance(one["attn"]["meta_k"], torch.Tensor)
        assert TQ.is_qleaf(one["attn"]["q"])


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_smoke_on_cpu(arch, capsys):
    """``launch.serve`` (quantized; hymba paged, mamba2 refusing
    ``--paged`` with the reference's message) and ``launch.train``
    (Algorithms 2+3 on one gloo rank) at smoke size on the CPU."""
    from repro_torch.launch import serve, train
    flags = ["--arch", arch, "--smoke", "--device", "cpu", "--quantized",
             "--requests", "3", "--max-new", "4"]
    if arch == "mamba2-2.7b":
        with pytest.raises(SystemExit, match="no KV cache to page"):
            serve.main(flags + ["--paged"])
    else:
        flags.append("--paged")
    results = serve.main(flags)
    assert all(len(r.tokens) == 4 for r in results.values())
    r = train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                    "3", "--seq", "16", "--global-batch", "2",
                    "--log-every", "1"])
    losses = [h["loss"] for h in r["history"]]
    assert len(losses) == 3 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    assert f"arch={arch}" in out
