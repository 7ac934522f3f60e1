"""The port's sampling against the JAX package's, on the CPU:
``core.threefry.gumbel``/``categorical`` against ``jax.random``'s,
``kernels.prng.categorical_step`` (the plain version of
``rt_threefry_categorical``) against the reference session's sampling
step, ``ServeSession`` and ``Engine.generate`` against the reference's
for the same key (greedy and sampled requests, every admission mode, a
preemption requeue), and the training launcher's multi-host flags on two
gloo ranks against ``torchrun``.

Tier: Gumbel noise within 1e-6 absolute (XLA's CPU ``log`` and the
port's differ by an ulp on part of the draws); tokens equal. A sampled
token may differ from the reference's only where the reference's top two
scores lie within 2e-6 of each other (the noise's tier on both); the
test checks that rule for every draw and prints the smallest margin.
Losses of the launcher runs equal.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models.model import Model as JModel
from repro.serve import Engine as JEngine
from repro.serve import Request as JRequest
from repro.serve import ServeSession as JSession
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.core import threefry as TF
from repro_torch.kernels import prng
from repro_torch.models.model import Model as TModel
from repro_torch.serve import Engine, Request, ServeSession

ROOT = Path(__file__).resolve().parents[1]
GUMBEL_ATOL = 1e-6
TIE_MARGIN = 2e-6
MIXED = [[5, 6, 7, 8], [9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19], [3, 14],
         [21, 22, 23, 24, 25], [7, 8, 9], list(range(30, 51)), [17]]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _margin(scores, token):
    """How far the reference's pick leads the runner-up (0 on a tie)."""
    s = np.sort(scores)[::-1]
    return float(s[0] - s[1]), float(scores[token])


def _check_tokens(got, want, scores):
    """Equal tokens, or a difference where the reference's top two scores
    lie within TIE_MARGIN; returns the smallest margin seen."""
    worst = np.inf
    for g, w, s in zip(np.atleast_1d(got), np.atleast_1d(want),
                       np.atleast_2d(scores)):
        m, _ = _margin(s, w)
        worst = min(worst, m)
        if g != w:
            assert m <= TIE_MARGIN, (g, w, m)
    return worst


@pytest.mark.parametrize("shape", [(1,), (5,), (1000,), (262144,),
                                   (3, 152064)])
def test_gumbel_matches_jax(shape):
    jk = jax.random.PRNGKey(9)
    want = np.asarray(jax.random.gumbel(jk, shape))
    got = TF.gumbel(TF.key_data(jk), shape).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=GUMBEL_ATOL)


@pytest.mark.parametrize("V", [7, 4099, 152064, 262144])
def test_categorical_matches_jax(V):
    rng = np.random.default_rng(V)
    worst = np.inf
    # unbatched, one key a draw
    for s in range(6):
        jk = jax.random.PRNGKey(s)
        lg = (rng.normal(size=V) * 3).astype(np.float32)
        want = int(jax.random.categorical(jk, lg))
        got = TF.categorical(TF.key_data(jk), torch.from_numpy(lg))
        assert got.shape == ()
        scores = np.asarray(jax.random.gumbel(jk, (V,))) + lg
        worst = min(worst, _check_tokens(int(got), want, scores))
    # batched: vmap over a table of keys
    ks = jax.random.split(jax.random.PRNGKey(V), 4)
    lg = (rng.normal(size=(4, V)) * 3).astype(np.float32)
    want = np.asarray(jax.vmap(jax.random.categorical)(ks, lg))
    got = TF.categorical(TF.key_data(ks), torch.from_numpy(lg)).numpy()
    scores = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (V,)))(ks)) \
        + lg
    worst = min(worst, _check_tokens(got, want, scores))
    print(f"V={V}: smallest top-two margin {worst:.3e}")
    with pytest.raises(ValueError):
        TF.categorical(TF.key_data(ks), torch.from_numpy(lg[:3]))


def _reference_step(rng, logits, temp):
    """The reference session's sampling step (``_build_step``)."""
    keys = jax.vmap(jax.random.split)(rng)
    hot = temp > 0.0
    scaled = logits / jnp.maximum(temp, 1e-6)[:, None]
    sampled = jax.vmap(jax.random.categorical)(keys[:, 1], scaled)
    greedy = jnp.argmax(logits, axis=-1)
    return (np.asarray(greedy), np.asarray(sampled), np.asarray(scaled),
            keys, np.asarray(jnp.where(hot[:, None], keys[:, 0], rng)))


def test_categorical_step_is_the_reference_step():
    """Greedy and sampled tokens, and the keys written back (hot slots
    only), over 16 steps from the same keys; ties planted in the logits
    go to the lower index."""
    B, V = 5, 3000
    rng = np.random.default_rng(0)
    temp = np.array([0.0, 0.7, 1.0, 0.0, 1e-9], np.float32)
    jrng = jax.random.split(jax.random.PRNGKey(4), B)
    trng = TF.key_data(jrng)
    worst = np.inf
    for step in range(16):
        lg = (rng.normal(size=(B, V)) * 2).astype(np.float32)
        lg[:, 10] = lg[:, 2000] = lg.max() + 1.0   # a planted greedy tie
        greedy, sampled, scaled, keys, nxt = _reference_step(
            jrng, jnp.asarray(lg), jnp.asarray(temp))
        tg, ts = prng.categorical_step(torch.from_numpy(lg),
                                       torch.from_numpy(temp), trng)
        assert tg.dtype == ts.dtype == torch.int32
        assert (tg.numpy() == greedy).all() and (greedy == 10).all()
        g = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (V,)))(
            keys[:, 1]))
        worst = min(worst, _check_tokens(ts.numpy(), sampled, g + scaled))
        assert (trng.numpy().view(np.uint32) == nxt).all()
        jrng = jnp.asarray(nxt)
    print(f"smallest top-two margin {worst:.3e}")
    with pytest.raises(ValueError):
        prng.categorical_step(torch.zeros(2, 3), torch.zeros(2),
                              torch.zeros(2, 2, dtype=torch.int64))


@pytest.fixture(scope="module")
def setup():
    jm = JModel(jget("yi-6b", smoke=True))
    tm = TModel(tget("yi-6b", smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, tm, jp, tp


def _run(session, requests):
    handles = [session.submit(r) for r in requests]
    results = session.drain()
    return [results[h].tokens for h in handles]


def _reqs(cls, max_new=6):
    return [cls(prompt=p, max_new_tokens=max_new,
                temperature=(0.0, 0.8, 1.3)[i % 3])
            for i, p in enumerate(MIXED)]


@pytest.mark.parametrize("mode", [
    dict(prefill="chunked", prefill_chunk=4),
    dict(prefill="whole"),
    dict(prefill="inject"),
    dict(prefill="chunked", paged=True, page_size=8),
    dict(prefill="inject", paged=True, page_size=8)],
    ids=["chunked", "whole", "inject", "chunked-paged", "inject-paged"])
def test_session_tokens_match_reference(setup, mode):
    """Every token of mixed greedy and hot requests equals the
    reference's, the same ``base_key`` on both sides (the reference's
    uint32 key given to both)."""
    jm, tm, jp, tp = setup
    key = jax.random.PRNGKey(17)
    js = JSession(jm, jp, slots=3, max_seq=48, base_key=key, **mode)
    ts = ServeSession(tm, tp, slots=3, max_seq=48, base_key=np.asarray(key),
                      device="cpu", **mode)
    want = _run(js, _reqs(JRequest))
    got = _run(ts, _reqs(Request))
    assert got == want
    # reseed restarts the key sequence: the same requests, the same tokens
    ts.reseed(TF.key_data(key))
    js.reseed(key)
    assert _run(ts, _reqs(Request)) == _run(js, _reqs(JRequest)) == want


def test_preempt_requeue_matches_reference(setup):
    """A hot batch-class request preempted by an interactive one and
    requeued replays its own stream: its tokens, and the interactive
    request's, are the reference's in the same schedule."""
    jm, tm, jp, tp = setup
    out = []
    for cls, make in ((JRequest, lambda: JSession(
            jm, jp, slots=1, max_seq=48, seed=5, paged=True, page_size=8,
            num_pages=12)), (Request, lambda: ServeSession(
            tm, tp, slots=1, max_seq=48, seed=5, paged=True, page_size=8,
            num_pages=12, device="cpu"))):
        sess = make()
        hb = sess.submit(cls(prompt=[5, 6, 7, 8], max_new_tokens=8,
                             temperature=0.7, slo="batch"))
        for _ in range(3):
            sess.step()
        hi = sess.submit(cls(prompt=[9, 10, 11], max_new_tokens=6,
                             temperature=0.9, slo="interactive"))
        res = sess.drain()
        assert sess.stats["preemptions"] == 1
        out.append((res[hb].tokens, res[hi].tokens))
    assert out[1] == out[0]


def test_engine_generate_key_matches_reference(setup):
    jm, tm, jp, tp = setup
    key = jax.random.PRNGKey(23)
    want = JEngine(jm, jp, max_seq=48).generate(_reqs(JRequest, 5)[:4],
                                                key=key)
    eng = Engine(tm, tp, max_seq=48, device="cpu")
    got = eng.generate(_reqs(Request, 5)[:4], key=np.asarray(key))
    assert [r.tokens for r in got] == [r.tokens for r in want]
    # no key: PRNGKey(0), as the reference's
    want0 = JEngine(jm, jp, max_seq=48).generate(_reqs(JRequest, 5)[:4])
    assert [r.tokens for r in eng.generate(_reqs(Request, 5)[:4])] == \
        [r.tokens for r in want0]


def test_session_key_forms_and_refusal(setup):
    """``base_key`` and ``reseed`` take the reference's uint32 words or
    the port's int32 key; other shapes raise the reference's error."""
    jm, tm, jp, tp = setup
    msg = None
    try:
        JSession(jm, jp, slots=1, max_seq=16,
                 base_key=np.zeros(3, np.uint32))
    except ValueError as e:
        msg = str(e)
    with pytest.raises(ValueError) as got:
        ServeSession(tm, tp, slots=1, max_seq=16,
                     base_key=np.zeros(3, np.uint32), device="cpu")
    assert str(got.value) == msg
    s = ServeSession(tm, tp, slots=1, max_seq=16, device="cpu")
    with pytest.raises(ValueError, match="2 uint32 words"):
        s.reseed(torch.zeros(4, dtype=torch.int32))
    a = ServeSession(tm, tp, slots=2, max_seq=48, seed=8, device="cpu")
    b = ServeSession(tm, tp, slots=2, max_seq=48, device="cpu",
                     base_key=TF.prng_key(8))
    assert _run(a, _reqs(Request)[:3]) == _run(b, _reqs(Request)[:3])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


LAUNCH = ["-m", "repro_torch.launch.train", "--arch", "yi-6b", "--smoke",
          "--device", "cpu", "--data", "2", "--steps", "3", "--seq", "32",
          "--global-batch", "4", "--log-every", "1", "--weight-bits", "7",
          "--weight-absolute"]


def _env():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    return env


def _losses(out: str):
    return [line.split()[3] for line in out.splitlines()
            if line.startswith("step ") and "loss" in line]


def test_multihost_flags_match_torchrun():
    """Two processes joined by ``--multihost --coordinator`` train the
    losses of a two-rank ``torchrun`` run; rank 0 prints them."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, *LAUNCH, "--multihost", "--coordinator",
         f"127.0.0.1:{port}", "--num-processes", "2", "--process-id",
         str(r)], env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in (1, 0)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ref = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", *LAUNCH], env=_env(), capture_output=True,
        text=True, timeout=240)
    assert ref.returncode == 0, ref.stderr[-3000:]
    got, want = _losses(outs[1]), _losses(ref.stdout)
    print(f"multihost losses {got}, torchrun {want}")
    assert len(got) == 3 and got == want
    assert "workers=2" in outs[1] and not _losses(outs[0])


def test_multihost_incomplete_flags_give_reference_error():
    out = subprocess.run([sys.executable, *LAUNCH, "--multihost",
                          "--coordinator", "127.0.0.1:1"], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert out.stderr.strip().splitlines()[-1].endswith(
        "error: --multihost requires --coordinator, --num-processes and "
        "--process-id")
