"""ServeSession's admission modes against the JAX package's, on the CPU:
``"whole"`` (one ``Model.prefill`` into the slot's fixed lane) and
``"inject"`` (the prompt through the decode step, fixed lanes and paged)
give the reference's greedy tokens for the mixed prompts, on yi-6b and
gemma3-4b (window 16 at smoke size, which the longest prompt crosses;
tied head from codes). Also the reference's refusals and fallbacks, the
sampled tokens of every admission mode against the reference's same
mode, and the package surface
(``repro_torch.serve.__all__``, ``comm.dequant_matmul``,
``repro_torch.dist``'s submodules).

Tier: greedy and sampled tokens identical (the reference's session runs
the same converted, quantized weights and the same keys).
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models.model import Model as JModel
from repro.serve import Request as JRequest
from repro.serve import ServeSession as JSession
from repro.serve import quantized as JQ
from repro_torch.configs import get_config as tget
from repro_torch.convert import params_from_numpy
from repro_torch.models.model import Model as TModel
from repro_torch.serve.session import Request, ServeSession

MIXED = [[5, 6, 7, 8], [9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19], [3, 14],
         [21, 22, 23, 24, 25], [7, 8, 9],
         [2, 4, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24, 26],
         list(range(30, 51)), [17]]
MODES = [dict(prefill="whole"), dict(prefill="inject"),
         dict(prefill="inject", paged=True, page_size=8)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The smoke models' tensors are small: one intra-op thread is faster,
    and the test processes of a parallel run share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_SETUPS = {}


def _setup(arch):
    if arch not in _SETUPS:
        jm = JModel(jget(arch, smoke=True))
        tm = TModel(tget(arch, smoke=True))
        jp = JQ.quantize_params(jm.init(jax.random.PRNGKey(0)), k_x=6,
                                min_numel=256, pack=True)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        _SETUPS[arch] = (jm, tm, jp, tp)
    return _SETUPS[arch]


def _run(session, requests):
    handles = [session.submit(r) for r in requests]
    results = session.drain()
    return [results[h] for h in handles]


@pytest.mark.parametrize("mode", MODES, ids=lambda m: "-".join(
    str(v) for v in m.values()))
@pytest.mark.parametrize("arch", ["yi-6b", "gemma3-4b"])
def test_admission_modes_match_reference(arch, mode):
    jm, tm, jp, tp = _setup(arch)
    js = JSession(jm, jp, slots=3, max_seq=48, **mode)
    want = _run(js, [JRequest(prompt=p, max_new_tokens=6) for p in MIXED])
    ts = ServeSession(tm, tp, slots=3, max_seq=48, device="cpu", **mode)
    got = _run(ts, [Request(prompt=p, max_new_tokens=6) for p in MIXED])
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.finish_reason for r in got] == [r.finish_reason for r in want]
    assert [r.prompt_len for r in got] == [len(p) for p in MIXED]
    for key in ("dispatches", "syncs", "admitted", "preemptions",
                "chunk_dispatches", "max_inflight"):
        assert ts.stats[key] == js.stats[key], key
    if ts.paged:
        assert ts.free_pages == ts.num_pages


def test_whole_refusals_and_fallback():
    _, tm, _, tp = _setup("yi-6b")
    with pytest.raises(ValueError, match="paged"):
        ServeSession(tm, tp, slots=2, max_seq=48, paged=True, page_size=8,
                     prefill="whole", device="cpu")
    with pytest.raises(ValueError, match="unknown prefill"):
        ServeSession(tm, tp, slots=2, max_seq=48, prefill="eager",
                     device="cpu")
    s = ServeSession(tm, tp, slots=2, max_seq=48, prefill="whole",
                     device="cpu")
    assert s._admission_mode(1) == "inject"
    assert s._admission_mode(2) == "whole"
    # a 1-token prompt injected beside a whole one gives the chunked tokens
    reqs = [Request(prompt=[17], max_new_tokens=5),
            Request(prompt=[3, 14, 15], max_new_tokens=5)]
    base = ServeSession(tm, tp, slots=2, max_seq=48, device="cpu")
    assert [r.tokens for r in _run(s, reqs)] == \
        [r.tokens for r in _run(base, reqs)]
    assert s.stats["chunk_dispatches"] == 0


def test_sampling_stream_is_independent_of_admission():
    """Each admission mode samples the reference's tokens in the same
    mode: a request's key is the reference's, its first token of a chunked
    or whole admission draws with ``split(key)[1]``, and an injected
    prompt's key advances on its in-prompt steps as the reference's does
    (so injected and chunked admission draw different streams, in both
    packages alike)."""
    jm, tm, jp, tp = _setup("gemma3-4b")
    reqs = [dict(prompt=p, max_new_tokens=6,
                 temperature=0.0 if i % 2 else 0.8)
            for i, p in enumerate(MIXED)]
    for mode in (dict(prefill="chunked"), *MODES):
        js = JSession(jm, jp, slots=3, max_seq=48, seed=3, **mode)
        want = _run(js, [JRequest(**r) for r in reqs])
        ts = ServeSession(tm, tp, slots=3, max_seq=48, seed=3,
                          device="cpu", **mode)
        got = _run(ts, [Request(**r) for r in reqs])
        assert [r.tokens for r in got] == [r.tokens for r in want], mode


def test_package_surface_matches_reference():
    import repro.serve
    import repro_torch.comm
    import repro_torch.dist
    import repro_torch.serve
    assert sorted(repro_torch.serve.__all__) == sorted(repro.serve.__all__)
    assert len(repro_torch.serve.__all__) == 13
    for name in repro_torch.serve.__all__:
        assert getattr(repro_torch.serve, name).__module__.startswith(
            "repro_torch.serve.")
    from repro_torch.comm.matmul import dequant_matmul
    assert repro_torch.comm.dequant_matmul is dequant_matmul
    for sub in ("sharding", "topology", "collectives", "modes", "step"):
        assert getattr(repro_torch.dist, sub).__name__ == \
            f"repro_torch.dist.{sub}"
    assert not torch.distributed.is_initialized()
