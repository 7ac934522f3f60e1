"""The port's ``Model.init`` and its draw, ``core.threefry.truncated_normal``
(the plain version of ``rt_threefry_trunc_normal``), against the JAX
package's ``Model(cfg).init(PRNGKey(s))`` and ``jax.random.truncated_normal``,
with no conversion between them.

Tier: the truncated normal within 2e-6 absolute before the std (XLA's CPU
build evaluates ``log1p`` and contracts the ``erf_inv`` polynomial its own
way: about half the draws are bitwise, the rest a few float32 ulps off),
its erf constants bitwise; weights within 2e-6 times their std; ones,
zeros and ``A_log`` within one float32 ulp; ``dt_bias`` within rtol 1e-6
(``exp``/``expm1``/``log`` of two libraries); one forward on each side's
own init within the forward tier of ``test_torch_model.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.lax import special as jspecial

from repro.configs import get_config as jget
from repro.dist.step import TrainConfig as JTC
from repro.dist.step import make_train_step as j_make_train_step
from repro.models.model import Model as JModel
from repro_torch.configs import get_config as tget
from repro_torch.convert import dist_state_from_numpy
from repro_torch.core import threefry as TF
from repro_torch.dist.step import TrainConfig as TTC
from repro_torch.dist.step import make_train_step as t_make_train_step
from repro_torch.kernels import prng
from repro_torch.launch import mesh as TM
from repro_torch.models.model import Model as TModel
from repro_torch.train.session import SessionConfig, TrainSession
from repro_torch.tree import tree_leaves

ARCHS = ["yi-6b", "gemma2-2b", "gemma3-4b", "qwen2.5-14b",
         "llava-next-mistral-7b", "deepseek-moe-16b",
         "llama4-maverick-400b-a17b", "mamba2-2.7b", "hymba-1.5b",
         "whisper-small"]
TN_ATOL = 2e-6
FWD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_erf_constants_are_jax_float32():
    """a, b = erf(-+2 / sqrt2) in float32, as jax 0.9.0 computes them
    inside ``truncated_normal``, and sqrt2 and the clamp bounds."""
    sqrt2 = np.array(np.sqrt(2), np.float32)
    for (lo, hi), bits in TF.TRUNC_ERF_BITS.items():
        a = jspecial.erf(jnp.float32(lo) / sqrt2)
        b = jspecial.erf(jnp.float32(hi) / sqrt2)
        got = np.asarray([a, b], np.float32).view(np.uint32)
        assert got.tolist() == list(bits)
    assert np.float32(TF.SQRT2) == sqrt2


@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 - 1])
@pytest.mark.parametrize("shape", [(1,), (7,), (33, 65), (4, 5, 6)])
def test_truncated_normal_matches_jax(seed, shape):
    jk = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.truncated_normal(jk, -2, 2, shape))
    got = TF.truncated_normal(TF.key_data(jk), -2, 2, shape).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TN_ATOL)
    assert np.all(np.abs(got) < 2)


def test_truncated_normal_large_draw_and_tails():
    """2^20 draws (two pieces of the plain version's loop): the tier
    holds in both of the polynomial's branches, and the clamp."""
    jk = jax.random.PRNGKey(11)
    n = 1 << 20
    want = np.asarray(jax.random.truncated_normal(jk, -2, 2, (n,)))
    old = TF.PIECE
    TF.PIECE = 1 << 19
    try:
        got = TF.truncated_normal(TF.key_data(jk), -2, 2, (n,)).numpy()
    finally:
        TF.PIECE = old
    d = np.abs(got - want)
    print(f"max abs {d.max():.3e}, bitwise {np.mean(d == 0):.1%}")
    assert d.max() <= TN_ATOL
    assert np.abs(got).max() > 1.99   # the clamp's neighbourhood is drawn


@pytest.mark.parametrize("start", [0, 5, 2 ** 32 - 3])
def test_truncated_normal_start_offsets(start):
    """``start`` continues the flat draw: elements start.. of a longer
    draw, the 64-bit counter past 2^32 included (its high word)."""
    tk = TF.prng_key(21)
    full = TF.truncated_normal(tk, -2, 2, (16,))
    got = TF.truncated_normal(tk, -2, 2, (8,), start=start)
    if start + 8 <= 16:
        assert torch.equal(got, full[start:start + 8])
    else:   # past 2^32: the counters' high word is live, the range kept
        assert not torch.equal(got, full[:8])
        assert float(got.abs().max()) < 2
    if start == 0:
        want = np.asarray(jax.random.truncated_normal(
            jax.random.PRNGKey(21), -2, 2, (8,)))
        np.testing.assert_allclose(got.numpy(), want, atol=TN_ATOL, rtol=0)


def test_truncated_normal_table_is_vmap():
    """An (R, 2) table draws each row as ``vmap`` over keys does."""
    ks = jax.random.split(jax.random.PRNGKey(5), 3)
    want = np.asarray(jax.vmap(
        lambda k: jax.random.truncated_normal(k, -2, 2, (5, 9)))(ks))
    got = TF.truncated_normal(TF.key_data(ks), -2, 2, (5, 9)).numpy()
    assert got.shape == (3, 5, 9)
    np.testing.assert_allclose(got, want, atol=TN_ATOL, rtol=0)


def test_trunc_normal_wrapper_and_refusals():
    keys = TF.key_data(jax.random.split(jax.random.PRNGKey(2), 2))
    got = prng.trunc_normal(keys, (6, 3), std=0.2)
    want = TF.truncated_normal(keys, -2, 2, (6, 3)) * 0.2
    assert torch.equal(got, want)
    out = torch.empty(2, 6, 3)
    assert prng.trunc_normal(keys, (6, 3), 0.2, out=out) is out
    with pytest.raises(ValueError):
        prng.trunc_normal(keys.to(torch.int64), (3,))
    with pytest.raises(ValueError):
        prng.trunc_normal(keys, (3,), out=torch.empty(3))
    with pytest.raises(ValueError):
        prng.trunc_normal(keys, (3,), backend="cuda")
    with pytest.raises(ValueError):
        TF.truncated_normal(keys, -3, 3, (3,))


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


# the reference's draws and their std; every other leaf is ones or zeros,
# save the SSM's dt_bias and A_log
_STD = {"conv_w": 0.2}


def _kind(name):
    leaf = name.split(".")[-1]
    if leaf in ("dt_bias", "A_log"):
        return leaf
    if leaf in ("w", "b", "bq", "bk", "bv", "q_norm", "k_norm", "D",
                "norm_w", "init_state"):
        return "const"
    return "dense"


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_reference(arch, seed):
    jp = JModel(jget(arch, smoke=True)).init(jax.random.PRNGKey(seed))
    tp = TModel(tget(arch, smoke=True)).init(seed=seed, device="cpu")
    jpaths = _paths(jax.tree_util.tree_map(np.asarray, jp))
    tpaths = _paths(tp)
    assert sorted(jpaths) == sorted(tpaths)
    worst = 0.0
    for name, want in jpaths.items():
        got = tpaths[name]
        assert tuple(got.shape) == want.shape, name
        assert got.dtype == torch.float32 and want.dtype == np.float32, name
        got = got.numpy()
        kind = _kind(name)
        if kind == "dense":
            std = _STD.get(name.split(".")[-1], 0.02)
            d = np.abs(got - want).max() / std
            worst = max(worst, d)
            assert d <= TN_ATOL, (name, d)
        elif kind == "dt_bias":
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_max_ulp(got, want, maxulp=1)
    print(f"{arch}: worst weight difference {worst:.3e} x std")


def test_init_key_forms_and_refusal():
    """``key=`` takes the reference's uint32 key, the port's int32 key
    and a jax key alike; ``seed=s`` is ``PRNGKey(s)``; other shapes are
    refused."""
    m = TModel(tget("yi-6b", smoke=True))
    base = m.init(seed=3, device="cpu")
    for key in (jax.random.PRNGKey(3), np.asarray(jax.random.PRNGKey(3)),
                TF.prng_key(3)):
        other = m.init(key, device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(base),
                                                     tree_leaves(other)))
    with pytest.raises(ValueError, match="2 uint32 words"):
        m.init(np.zeros(3, np.uint32), device="cpu")


@pytest.mark.parametrize("form", ["jax", "uint32", "int32"])
def test_dist_state_takes_the_reference_key(form):
    """``init_state(key=)`` and ``TrainSession.from_artifacts(key=)`` give
    the reference's ``init_state(key)`` (the master within 2e-6 times the
    std, ones exact; moments and residuals zero) and equal ``seed=5``
    bitwise, with the key as jax's, the reference's uint32 words or the
    port's int32 key."""
    jk = jax.random.PRNGKey(5)
    key = {"jax": jk, "uint32": np.asarray(jk),
           "int32": TF.prng_key(5)}[form]
    jm = JModel(jget("yi-6b", smoke=True))
    jart = j_make_train_step(jm, jax.make_mesh((1, 1), ("data", "model")),
                             JTC(worker_axes=("data",)))
    want = jax.tree.map(np.asarray, jart.init_state(jk))
    group = TM.make_process_group("cpu", store=torch.distributed.HashStore())
    try:
        art = t_make_train_step(TModel(tget("yi-6b", smoke=True)), group,
                                TTC())
        ref = dist_state_from_numpy(want, art.rank, art.n_workers, "cpu")
        by_seed = art.init_state(seed=5, device="cpu")
        with TrainSession.from_artifacts(
                art, iter(()), SessionConfig(), key=key, device="cpu",
                log=lambda *_: None) as sess:
            states = [art.init_state(device="cpu", key=key), sess.state]
            for got in states:
                assert set(got) == set(ref) and got["count"] == 0
                for k in sorted(set(ref) - {"count"}):
                    a, b, c = (_paths(s[k]) for s in (got, by_seed, ref))
                    assert list(a) == list(b) and sorted(a) == sorted(c)
                    tol = TN_ATOL * 0.02 if k == "master" else 0.0
                    for name, t in a.items():
                        assert torch.equal(t, b[name]), (k, name)
                        np.testing.assert_allclose(
                            t.numpy(), c[name].numpy(), rtol=0, atol=tol,
                            err_msg=f"{k}.{name}")
    finally:
        TM.close_process_group()


@pytest.mark.parametrize("arch", ARCHS)
def test_init_meta_shapes(arch):
    """``device="meta"`` draws nothing and keeps every leaf's shape."""
    m = TModel(tget(arch, smoke=True))
    real = _paths(m.init(seed=0, device="cpu"))
    meta = _paths(m.init(device="meta"))
    assert list(real) == list(meta)
    for name, t in meta.items():
        assert t.device.type == "meta" and t.shape == real[name].shape, name
        assert t.dtype == real[name].dtype


def _batch(cfg, rng, B=2, S=16):
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
             "targets": rng.integers(0, cfg.vocab_size, (B, S)),
             "mask": np.ones((B, S), np.float32)}
    batch["tokens"] = batch["tokens"].astype(np.int32)
    batch["targets"] = batch["targets"].astype(np.int32)
    if cfg.input_mode == "embeddings":
        batch["embeds"] = rng.normal(size=(B, S, cfg.d_model)).astype(
            np.float32)
    if cfg.input_mode == "audio+tokens":
        batch["audio"] = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)
                                    ).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", ["yi-6b", "gemma2-2b", "deepseek-moe-16b",
                                  "mamba2-2.7b", "hymba-1.5b",
                                  "whisper-small", "llava-next-mistral-7b"])
def test_forward_on_own_init(arch):
    """Each side's forward on its own init, no conversion between them:
    the logits agree within the forward tier."""
    jcfg, tcfg = jget(arch, smoke=True), tget(arch, smoke=True)
    jm, tm = JModel(jcfg), TModel(tcfg)
    jp = jm.init(jax.random.PRNGKey(1))
    tp = tm.init(seed=1, device="cpu")
    batch = _batch(tcfg, np.random.default_rng(0))
    want, _ = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got, _ = tm.loss(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), **FWD_TOL)
