"""The encoder-decoder family (whisper-small) against the JAX package, at
smoke size: 2 encoder and 2 decoder layers, d_model 128, 4 heads, 16
audio frames. Tier 1.

Every model is converted from the reference's tree, with random
layernorm weights and biases (ones and zeros would hide a missing or
swapped term). Tiers: forward logits, the loss, the cross caches and
the decode step's logits within rtol 1e-4 / atol 1e-5 (XLA on the CPU
evaluates rsqrt, sin and tanh to its own rounding and contracts into
fma); gradients within rtol 2e-4 / atol 1e-5; greedy tokens equal
wherever the reference's top-1 / top-2 logit gap exceeds the logits'
tolerance; audio batches and quantized codes bitwise. Also the
family's refusals with the reference's messages and the training
launcher's CPU smoke.
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
from repro.serve import ServeSession as JSession
from repro.serve import quantized as JQ
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import batch_for_model as tbatches
from repro_torch.models.model import Model as TModel
from repro_torch.serve import quantized as TQ
from repro_torch.serve.session import ServeSession

ARCH = "whisper-small"
TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=1e-5)
GAP = 1e-4        # a greedy token is compared where its top-2 gap is above


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_MODELS = {}


def _models():
    """(reference model, port model, reference params with layernorm
    weights 1 + N(0, 0.3^2) and biases N(0, 0.5^2), the port's copy)."""
    if not _MODELS:
        jm = JModel(jget(ARCH, smoke=True))
        tm = TModel(tget(ARCH, smoke=True))
        rng = np.random.default_rng(5)

        def draw(path, x):
            name = path[-1].key
            if name == "b":
                return jnp.asarray(rng.normal(size=x.shape, scale=0.5),
                                   jnp.float32)
            if name == "w":
                return jnp.asarray(1 + rng.normal(size=x.shape, scale=0.3),
                                   jnp.float32)
            return x
        jp = jax.tree_util.tree_map_with_path(draw,
                                              jm.init(jax.random.PRNGKey(0)))
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        _MODELS.update(m=(jm, tm, jp, tp))
    return _MODELS["m"]


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _inputs(cfg, rng, B, S):
    toks = rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    audio = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model),
                       scale=0.7).astype(np.float32)
    return toks, audio


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, path + (k,))
    else:
        yield path, tree


def test_config_and_leaves_match_the_reference():
    """The registry's whisper-small is the reference's configuration
    (238,050,048 parameters), the smoke one too; ``Model.init`` has the
    reference's leaf names and shapes (layernorm ``w`` and ``b``, the
    gelu MLP's ``w_up``/``w_down``, ``enc_blocks``, ``enc_norm``,
    ``ln_x``, ``xattn``, a tied head), ones and zeros in the norms."""
    for smoke in (False, True):
        assert dataclasses.asdict(tget(ARCH, smoke=smoke)) == \
            dataclasses.asdict(jget(ARCH, smoke=smoke))
    assert tget(ARCH).n_params() == 238_050_048
    jm, tm, _, _ = _models()
    jl = {tuple(k.key for k in path): leaf.shape for path, leaf in
          jax.tree_util.tree_flatten_with_path(
              jax.eval_shape(jm.init, jax.random.PRNGKey(0)))[0]}
    tp = tm.init(seed=0, device="cpu")
    assert jl == {p: tuple(t.shape) for p, t in _flat(tp)}
    assert ("blocks", "xattn", "q") in jl and ("enc_norm", "b") in jl
    assert ("unembed",) not in jl and ("blocks", "mlp", "w_gate") not in jl
    assert torch.equal(tp["blocks"]["ln_x"]["b"], torch.zeros(2, 128))
    assert torch.equal(tp["enc_blocks"]["ln1"]["w"], torch.ones(2, 128))


def test_forward_loss_and_grads():
    """The training forward over 2 x 12 tokens and 16 frames, the loss,
    and its gradient of every leaf."""
    jm, tm, jp, tp = _models()
    rng = np.random.default_rng(3)
    toks, audio = _inputs(tm.cfg, rng, 2, 12)
    tgts = rng.integers(1, tm.cfg.vocab_size, size=(2, 12)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks), "audio": jnp.asarray(audio),
          "targets": jnp.asarray(tgts)}
    tb = {"tokens": torch.from_numpy(toks), "audio": torch.from_numpy(audio),
          "targets": torch.from_numpy(tgts)}
    jl, jaux = jax.jit(jm.forward)(jp, jb)
    tl, taux = tm.forward_with_aux(tp, tb)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    assert float(taux) == float(jaux) == 0.0
    (jloss, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, jb)
    leaves = {}

    def grad_leaf(path, t):
        leaves[path] = t.clone().requires_grad_()
        return leaves[path]
    tq = TQ.tree_map_with_path(grad_leaf, tp)
    tloss, count = tm.loss(tq, tb)
    grads = dict(zip(leaves, torch.autograd.grad(tloss,
                                                 list(leaves.values()))))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **TOL)
    assert float(count) == 24
    for path, leaf in jax.tree_util.tree_flatten_with_path(jg)[0]:
        key = tuple(k.key for k in path)
        np.testing.assert_allclose(grads[key].numpy(), np.asarray(leaf),
                                   err_msg=str(key), **GRAD_TOL)


_QUANT = {}


def _trees(k_x):
    """(reference tree, reference hook ctx, port tree, port hook) for
    float32 (``k_x`` None) or quantized weights at k_x (every leaf of
    at least 256 elements: the smoke norms (2, 128) too)."""
    jm, tm, jp, tp = _models()
    if k_x is None:
        return jp, ShardCtx(), tp, None
    if k_x not in _QUANT:
        jq = JQ.quantize_params(jp, k_x=k_x, min_numel=256, pack=True)
        _QUANT[k_x] = (jq, params_from_numpy(jax.tree.map(np.asarray, jq),
                                             "cpu"))
    jq, tq = _QUANT[k_x]
    return (jq, ShardCtx(param_gather=JQ.make_dequant_gather()), tq,
            TQ.make_dequant_gather())


@pytest.mark.parametrize("per_slot", [False, True], ids=["scalar", "slot"])
@pytest.mark.parametrize("paged", [False, True], ids=["lanes", "paged"])
@pytest.mark.parametrize("k_x", [None, 6], ids=["float", "k6"])
def test_prefill_encoder_and_decode(k_x, paged, per_slot):
    """``prefill_encoder``'s cross caches, then 3 prompt tokens and 5
    greedy tokens through ``decode_step`` of 3 slots (fixed lanes, or a
    page pool behind a fragmented table; one position for all slots, or
    each slot at its own), float32 and quantized weights: ``ck``/``cv``,
    every step's logits and the caches against the reference's; greedy
    tokens equal where the reference's top-2 gap exceeds ``GAP`` (both
    sides are fed the reference's tokens)."""
    jm, tm, _, _ = _models()
    jpp, ctx, tp, gather = _trees(k_x)
    cfg = tm.cfg
    B, S, Sa = 3, 16, cfg.encoder_seq
    rng = np.random.default_rng(7)
    toks, audio = _inputs(cfg, rng, B, 3)
    pool = (12, 4) if paged else None
    jc = jm.init_cache(B, S, encoder_seq_local=Sa, page_pool=pool)
    tc = tm.init_cache(B, S, page_pool=pool, device="cpu",
                       encoder_seq_local=Sa)
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}
    if paged:
        tab = np.array([[3, 1, 7, 9], [0, 2, 11, 12], [5, 4, 6, 8]],
                       np.int32)
        jc["ptab"], tc["ptab"] = jnp.asarray(tab), torch.from_numpy(tab)
    jc = jax.jit(lambda p, a, c: jm.prefill_encoder(p, a, c, ctx))(
        jpp, jnp.asarray(audio), jc)
    same = tm.prefill_encoder(tp, torch.from_numpy(audio), tc, gather)
    assert same is tc
    for name in ("ck", "cv"):
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]),
                                   err_msg=name, **TOL)
    step = jax.jit(lambda p, i, c, pos: jm.decode_step(p, i, c, pos, ctx))
    pos = np.array([0, 2, 5], np.int32) if per_slot else np.int32(0)
    tok = toks[:, :1]
    compared = 0
    for t in range(8):
        jl, jc = step(jpp, {"token": jnp.asarray(tok)}, jc, jnp.asarray(pos))
        tl, tc = tm.decode_step(tp, {"token": torch.from_numpy(tok)}, tc,
                                torch.from_numpy(np.asarray(pos)), gather)
        np.testing.assert_allclose(_np(tl), _np(jl), err_msg=f"t={t}", **TOL)
        want = np.argmax(_np(jl), -1)
        top = np.sort(_np(jl), -1)
        ok = top[:, -1] - top[:, -2] > GAP
        np.testing.assert_array_equal(np.argmax(_np(tl), -1)[ok], want[ok])
        compared += int(ok.sum())
        tok = (toks[:, t + 1:t + 2] if t < 2 else
               want[:, None].astype(np.int32))
        pos = pos + 1
    assert compared >= 12
    for name in tc:
        np.testing.assert_allclose(_np(tc[name]), _np(jc[name]),
                                   err_msg=name, **TOL)


def test_decode_matches_forward():
    """Decode logits at position t equal the training forward's at t
    (the reference's ``test_decode_matches_forward``, at the port's
    float32 tier)."""
    _, tm, _, tp = _models()
    rng = np.random.default_rng(11)
    toks, audio = _inputs(tm.cfg, rng, 2, 6)
    want = tm.forward(tp, {"tokens": torch.from_numpy(toks),
                           "audio": torch.from_numpy(audio)}).detach()
    cache = tm.init_cache(2, 8, device="cpu",
                          encoder_seq_local=tm.cfg.encoder_seq)
    tm.prefill_encoder(tp, torch.from_numpy(audio), cache)
    for t in range(6):
        got, _ = tm.decode_step(tp, {"token": torch.from_numpy(
            toks[:, t:t + 1])}, cache, t)
        np.testing.assert_allclose(_np(got), _np(want[:, t]),
                                   err_msg=f"t={t}", **TOL)


def test_slot_follows_its_own_audio():
    """A slot's logits move with its own audio and not with a batch
    mate's: new audio for slot 1 leaves slot 0's logits bitwise as they
    were and changes slot 1's."""
    _, tm, _, tp = _models()
    rng = np.random.default_rng(13)
    toks, audio = _inputs(tm.cfg, rng, 2, 1)
    other = audio.copy()
    other[1] = rng.normal(size=other[1].shape, scale=0.7)

    def logits(a):
        cache = tm.init_cache(2, 8, device="cpu",
                              encoder_seq_local=tm.cfg.encoder_seq)
        tm.prefill_encoder(tp, torch.from_numpy(a), cache)
        return tm.decode_step(tp, {"token": torch.from_numpy(toks)}, cache,
                              torch.tensor([0, 3]))[0]
    a, b = logits(audio), logits(other)
    assert torch.equal(a[0], b[0])
    assert float((a[1] - b[1]).norm() / a[1].norm()) > 1e-3


def test_refusals_carry_the_reference_messages(monkeypatch):
    """``decode_chunk``, ``prefill``, ``ServeSession`` and ``launch.serve``
    refuse the family as the reference's do, with their messages (the
    port's session names its families after the reference's sentence);
    an unknown arch type and input mode are still refused by name."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    jm, tm, jp, tp = _models()
    toks = {"token": np.ones((1, 4), np.int32)}

    def message(fn, exc):
        with pytest.raises(exc) as e:
            fn()
        return str(e.value)
    one = jnp.zeros(1, jnp.int32)
    assert message(lambda: tm.decode_chunk(
        tp, {"token": torch.ones(1, 4, dtype=torch.int32)}, {}, [0], [4]),
        NotImplementedError) == message(lambda: jm.decode_chunk(
            jp, toks, {}, one, one), NotImplementedError)
    assert message(lambda: tm.prefill(
        tp, {"tokens": torch.ones(1, 4, dtype=torch.int32)}, 8),
        NotImplementedError) == message(lambda: jm.prefill(
            jp, {"tokens": jnp.ones((1, 4), jnp.int32)}, 8), AssertionError)
    ref = message(lambda: JSession(jm, jp, slots=1, max_seq=16), ValueError)
    assert message(lambda: ServeSession(tm, tp, slots=1, max_seq=16,
                                        device="cpu"),
                   ValueError).startswith(ref)
    flags = ["--arch", ARCH, "--smoke"]
    monkeypatch.setattr("sys.argv", ["serve"] + flags + ["--no-compile-cache"])
    assert message(lambda: tserve.main(flags + ["--device", "cpu"]),
                   SystemExit) == message(jserve.main, SystemExit)
    cfg = tget(ARCH, smoke=True)
    for change, name in ((dict(arch_type="rnn"), "arch_type rnn"),
                         (dict(input_mode="video"), "input_mode video")):
        with pytest.raises(NotImplementedError, match=name):
            TModel(dataclasses.replace(cfg, **change)).init(device="cpu")


def test_audio_batches_bitwise():
    """``batch_for_model``'s whisper batches (tokens, targets, mask and
    the audio stub's frames drawn after them) bitwise the reference's,
    three batches deep; the audio is (B, encoder_seq, d) float32."""
    cfg = tget(ARCH, smoke=True)
    jb, tb = jbatches(jget(ARCH, smoke=True), 24, 3, seed=4), \
        tbatches(cfg, 24, 3, seed=4)
    for _ in range(3):
        want, got = next(jb), next(tb)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    assert got["audio"].shape == (3, cfg.encoder_seq, cfg.d_model)


def test_quantized_leaf_kinds():
    """``quantize_params`` of the family's tree: codes and scales bitwise
    the reference's (the projections and the tied embedding code-
    resident for K1/K1t, the stacked norms dequantized at use), at the
    default ``min_numel`` and at 256. At full size every layernorm stack
    ((12, 768) and (768,)) falls under the default ``min_numel`` and
    stays float; every projection and the embedding are quantized."""
    jm, tm, jp, tp = _models()
    for min_numel in (2 ** 14, 256):
        jq = JQ.quantize_params(jp, k_x=6, min_numel=min_numel, pack=True)
        tq = TQ.quantize_params(tp, k_x=6, min_numel=min_numel, pack=True)
        jflat = {tuple(k.key for k in path): leaf for path, leaf in
                 jax.tree_util.tree_flatten_with_path(
                     jq, is_leaf=JQ._is_qleaf)[0]}
        tflat = dict(_flat(tq))
        assert set(tflat) == set(jflat)
        for path, t in tflat.items():
            j = jflat[path]
            assert TQ.is_qleaf(t) == JQ._is_qleaf(j), path
            if TQ.is_qleaf(t):
                np.testing.assert_array_equal(t.codes.numpy(),
                                              np.asarray(j.codes))
                np.testing.assert_array_equal(t.scale.numpy(),
                                              np.asarray(j.scale))
    one = TQ.make_dequant_gather()(TQ.layer_slice(tq["enc_blocks"], 0),
                                   "enc_blocks")
    assert TQ.is_qleaf(one["attn"]["q"]) and TQ.is_qleaf(one["mlp"]["w_up"])
    assert isinstance(one["ln1"]["w"], torch.Tensor)
    full = TModel(tget(ARCH)).init(device="meta")
    big = {p for p, t in _flat(full) if t.numel() >= 2 ** 14}
    assert big == {p for p, _ in _flat(full)
                   if p[-1] in TQ._MATMUL_KEYS}
    assert ("blocks", "ln_x", "w") not in big


@pytest.mark.parametrize("mode", ["qadam", "dp_adam"])
def test_launch_train_smoke_on_cpu(mode, capsys):
    """``launch.train --arch whisper-small --smoke --device cpu`` (one
    gloo rank, Algorithms 2+3): finite losses in ``qadam`` and in the
    full-precision ``dp_adam``."""
    from repro_torch.launch import train
    flags = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3",
             "--seq", "16", "--global-batch", "2", "--log-every", "1",
             "--mode", mode]
    if mode == "dp_adam":
        flags += ["--grad-bits", "0", "--weight-bits", "0"]
    r = train.main(flags)
    losses = [h["loss"] for h in r["history"]]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "grid={'data': 1, 'model': 1}" in capsys.readouterr().out
