"""The port's ServeSession end to end against the JAX package's, on the
CPU, for yi-6b and gemma2-2b (tied head from codes, window 16 at smoke
size, which the longest prompt crosses): greedy tokens identical for a
paged, quantized, chunked-prefill session; no per-token host sync;
reproducible sampling; SLO admission and preemption; the Engine shim and
the launcher."""
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
from repro_torch.serve.engine import Engine
from repro_torch.serve.quantized import quantize_params
from repro_torch.serve.session import Request, ServeSession

MIXED = [[5, 6, 7, 8], [9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19], [3, 14],
         [21, 22, 23, 24, 25], [7, 8, 9],
         [2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24, 26],
         list(range(30, 51))]
SESSION = dict(slots=3, max_seq=48, paged=True, page_size=8, prefill_chunk=4)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The smoke models' tensors are small: one intra-op thread is faster,
    and the test processes of a parallel run share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch):
    jm = JModel(jget(arch, smoke=True))
    tm = TModel(tget(arch, smoke=True))
    jp = JQ.quantize_params(jm.init(jax.random.PRNGKey(0)), k_x=6,
                            min_numel=256, pack=True)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, tm, jp, tp


@pytest.fixture(scope="module")
def setup():
    return _setup("yi-6b")


def _programs(jm):
    """The reference's jitted chunk and step programs, one pair a model."""
    ctx = ShardCtx(param_gather=JQ.make_dequant_gather())
    chunk = jax.jit(lambda p, t, c, n: jm.decode_chunk(
        p, {"token": t}, c, jnp.asarray([0]), n, ctx))
    step = jax.jit(lambda p, t, c, pos: jm.decode_step(
        p, {"token": t}, c, pos, ctx))
    return chunk, step


def _min_top2_gap(jm, jp, prompt, tokens, programs):
    """Smallest top-1/top-2 logit gap (relative to the tolerance) along
    the reference's greedy path for one request."""
    chunk, step = programs
    cache = jm.init_cache(1, 48)
    pad = np.zeros((1, 24), np.int32)
    pad[0, :len(prompt)] = prompt
    lg, cache = chunk(jp, jnp.asarray(pad), cache, jnp.asarray([len(prompt)]))
    worst = np.inf
    for i, t in enumerate(tokens):
        top = np.sort(np.asarray(lg[0]))[-2:]
        tol = LOGIT_TOL["atol"] + LOGIT_TOL["rtol"] * abs(top[1])
        worst = min(worst, (top[1] - top[0]) / tol)
        assert int(np.argmax(np.asarray(lg[0]))) == t
        lg, cache = step(jp, jnp.asarray([[t]], jnp.int32), cache,
                         jnp.asarray([len(prompt) + i], jnp.int32))
    return worst


def test_greedy_tokens_identical_to_reference(setup):
    jm, tm, jp, tp = setup
    js = JSession(jm, jp, **SESSION)
    jh = [js.submit(JRequest(prompt=p, max_new_tokens=6)) for p in MIXED]
    jr = js.drain()
    want = [jr[h].tokens for h in jh]
    # a match is a real check only if no greedy choice sits within the
    # logits tolerance of the runner-up
    programs = _programs(jm)
    gaps = [_min_top2_gap(jm, jp, p, t, programs) for p, t in zip(MIXED, want)]
    assert min(gaps) > 1.0, gaps
    ts = ServeSession(tm, tp, device="cpu", **SESSION)
    th = [ts.submit(Request(prompt=p, max_new_tokens=6)) for p in MIXED]
    tr = ts.drain()
    assert [tr[h].tokens for h in th] == want
    assert [tr[h].finish_reason for h in th] == ["length"] * len(MIXED)
    assert ts.free_pages == ts.num_pages
    for key in ("dispatches", "syncs", "admitted", "preemptions",
                "chunk_dispatches", "max_inflight"):
        assert ts.stats[key] == js.stats[key], key


def test_fixed_lanes_and_inject_match_paged(setup):
    _, tm, _, tp = setup

    def run(**kw):
        s = ServeSession(tm, tp, slots=2, max_seq=48, device="cpu", **kw)
        hs = [s.submit(Request(prompt=p, max_new_tokens=5)) for p in MIXED]
        r = s.drain()
        return [r[h].tokens for h in hs]
    base = run(paged=True, page_size=8)
    assert run() == base
    assert run(prefill="inject") == base
    assert run(paged=True, page_size=8, num_pages=8, prefill_chunk=32) == base
    assert run(paged=True, page_size=8, fused_matmul=False) == base


class _HostReads:
    """Counts tensor-to-host reads (the CPU stand-in for device syncs)."""

    NAMES = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
             "__float__", "__index__")

    def __init__(self, monkeypatch):
        self.n = 0
        for name in self.NAMES:
            real = getattr(torch.Tensor, name)

            def counted(*a, _real=real, **kw):
                self.n += 1
                return _real(*a, **kw)
            monkeypatch.setattr(torch.Tensor, name, counted)


def test_steady_state_decode_never_reads_the_device(setup, monkeypatch):
    _, tm, _, tp = setup
    sess = ServeSession(tm, tp, slots=2, max_seq=64, paged=True, page_size=8,
                        device="cpu")
    for p in ([5, 6, 7, 8], [9, 10, 11, 12]):
        sess.submit(Request(prompt=p, max_new_tokens=30, temperature=0.5))
    sess.step()                              # prefill chunks land
    reads = _HostReads(monkeypatch)
    d0 = sess.stats["dispatches"]
    for _ in range(20):
        sess.step()
    assert reads.n == 0
    assert sess.stats["dispatches"] - d0 == 20 and sess.stats["syncs"] == 0
    monkeypatch.undo()
    res = sess.drain()
    assert all(len(r.tokens) == 30 for r in res.values())
    assert sess.stats["syncs"] <= 4


def test_sampling_reproducible_and_batch_independent(setup):
    _, tm, _, tp = setup
    reqs = [Request(prompt=p, max_new_tokens=6,
                    temperature=0.9 if i % 2 else 0.0)
            for i, p in enumerate(MIXED)]

    def run(slots, seed=3):
        s = ServeSession(tm, tp, slots=slots, max_seq=48, seed=seed,
                         device="cpu")
        hs = [s.submit(Request(**vars(r))) for r in reqs]
        res = s.drain()
        return [res[h].tokens for h in hs]
    a = run(3)
    assert a == run(3)
    assert a == run(1)                     # other batch mates, same draws
    assert a != run(3, seed=4)
    greedy = run(3, seed=4)
    assert [a[i] for i in (0, 2, 4)] == [greedy[i] for i in (0, 2, 4)]


def test_preempt_requeue_replays_exact_tokens(setup):
    _, tm, _, tp = setup
    r_batch = Request(prompt=[5, 6, 7, 8], max_new_tokens=8,
                      temperature=0.7, slo="batch")
    r_inter = Request(prompt=[9, 10, 11], max_new_tokens=6, slo="interactive")
    calm = ServeSession(tm, tp, slots=4, max_seq=48, seed=3, paged=True,
                        page_size=8, device="cpu")
    hc = [calm.submit(Request(**vars(r))) for r in (r_batch, r_inter)]
    cr = calm.drain()
    sess = ServeSession(tm, tp, slots=1, max_seq=48, seed=3, paged=True,
                        page_size=8, num_pages=12, device="cpu")
    hb = sess.submit(Request(**vars(r_batch)))
    for _ in range(3):
        sess.step()
    hi = sess.submit(Request(**vars(r_inter)))
    res = sess.drain()
    assert sess.stats["preemptions"] == 1
    assert res[hi].tokens == cr[hc[1]].tokens
    assert res[hb].tokens == cr[hc[0]].tokens


def test_preempt_kill_and_slo_order(setup):
    _, tm, _, tp = setup
    sess = ServeSession(tm, tp, slots=1, max_seq=48, seed=3, paged=True,
                        page_size=8, num_pages=12, preempt_mode="kill",
                        device="cpu")
    hb = sess.submit(Request(prompt=[5, 6, 7, 8], max_new_tokens=8,
                             slo="batch"))
    for _ in range(3):
        sess.step()
    b2 = sess.submit(Request(prompt=[1, 2], max_new_tokens=3, slo="batch"))
    hi = sess.submit(Request(prompt=[9, 10, 11], max_new_tokens=6,
                             slo="interactive"))
    assert sess._pending == [b2]
    res = sess.drain()
    assert res[hb].finish_reason == "preempted"
    assert 0 < len(res[hb].tokens) < 8
    assert res[hi].finish_reason == "length"
    assert len(res[b2].tokens) == 3
    with pytest.raises(ValueError):
        sess.submit(Request(prompt=list(range(1, 60)), max_new_tokens=8))


def test_engine_shim_and_launcher(setup, capsys):
    _, tm, _, tp = setup
    out = Engine(tm, tp, max_seq=48, device="cpu").generate(
        [Request(prompt=p, max_new_tokens=4) for p in MIXED[:2]])
    s = ServeSession(tm, tp, slots=2, max_seq=48, device="cpu")
    hs = [s.submit(Request(prompt=p, max_new_tokens=4)) for p in MIXED[:2]]
    res = s.drain()
    assert [r.tokens for r in out] == [res[h].tokens for h in hs]
    from repro_torch.launch import serve as launch
    results = launch.main(["--arch", tm.cfg.name, "--smoke", "--device", "cpu",
                           "--quantized", "--paged", "--requests", "3",
                           "--slots", "2", "--max-new", "4", "--k-x", "2"])
    assert all(len(r.tokens) == 4 for r in results.values())
    assert "resident codes" in capsys.readouterr().out
    params = quantize_params(tm.init(seed=1, device="cpu"), k_x=6)
    assert params["blocks"]["attn"]["q"].codes.dtype == torch.int8


def test_prefill_auto_is_the_reference_choice(setup):
    """``prefill="auto"`` is the default, as in the reference, and admits
    every prompt as the reference's ``_admission_mode`` chooses (chunked
    prefill for the dense family), fixed lanes and paged alike: each
    prompt of the mix goes out in ceil(plen / prefill_chunk) chunk
    dispatches, and the tokens are those of an explicit "chunked"."""
    import inspect
    jm, tm, jp, tp = setup
    assert inspect.signature(ServeSession).parameters["prefill"].default \
        == inspect.signature(JSession).parameters["prefill"].default \
        == "auto"
    for kw in (dict(), dict(paged=True, page_size=8)):
        js = JSession(jm, jp, slots=2, max_seq=48, prefill="auto", **kw)
        assert {js._admission_mode(len(p)) for p in MIXED} == {"chunked"}
    chunks = sum(-(-len(p) // SESSION["prefill_chunk"]) for p in MIXED)
    runs = []
    for sess_kw in (dict(paged=False), dict()):
        for kw in (dict(), dict(prefill="chunked")):
            s = ServeSession(tm, tp, device="cpu",
                             **dict(SESSION, **sess_kw, **kw))
            hs = [s.submit(Request(prompt=p, max_new_tokens=3))
                  for p in MIXED]
            r = s.drain()
            assert s.stats["preemptions"] == 0
            assert s.stats["chunk_dispatches"] == chunks
            runs.append([r[h].tokens for h in hs])
    assert runs[0] == runs[1] == runs[2] == runs[3]
    with pytest.raises(ValueError, match="unknown prefill"):
        ServeSession(tm, tp, device="cpu", prefill="eager")


class TestGemma2:
    """The checks that take ``setup``, on gemma2-2b."""

    @pytest.fixture(scope="class")
    def setup(self):
        return _setup("gemma2-2b")

    test_greedy_tokens_identical_to_reference = staticmethod(
        test_greedy_tokens_identical_to_reference)
    test_fixed_lanes_and_inject_match_paged = staticmethod(
        test_fixed_lanes_and_inject_match_paged)
    test_steady_state_decode_never_reads_the_device = staticmethod(
        test_steady_state_decode_never_reads_the_device)
    test_sampling_reproducible_and_batch_independent = staticmethod(
        test_sampling_reproducible_and_batch_independent)
    test_preempt_requeue_replays_exact_tokens = staticmethod(
        test_preempt_requeue_replays_exact_tokens)
    test_preempt_kill_and_slo_order = staticmethod(
        test_preempt_kill_and_slo_order)
    test_engine_shim_and_launcher = staticmethod(test_engine_shim_and_launcher)
    test_prefill_auto_is_the_reference_choice = staticmethod(
        test_prefill_auto_is_the_reference_choice)
