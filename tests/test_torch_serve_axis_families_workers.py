"""The sharded serving step on four gloo ranks for the SSM, hybrid and
MoE families: mamba2-2.7b (no KV cache: the SSM state and conv tail
whole on every model shard, which all run the same recurrence),
hymba-1.5b (the meta prefix counted on shard 0 only; the SSD lanes
beside a sequence-split KV cache) and deepseek-moe-16b (the experts
local, E / 2 a rank, tokens through ``collectives.expert_exchange``) on
``(data=2, model=2)``: the gates of
``tests/test_torch_serve_axis_workers.py`` (whose harness this is).
Tier 1.

MoE capacity: a decode step routes each worker's slots together, so the
reference decodes each worker's rows alone (the same tokens a call, the
same capacity); ``pytest -s`` prints how far the whole batch routed in
one call lands from it (nonzero where capacity dropped a pair). The
prefill runs at ``capacity_factor=16.0`` (no pair dropped), as the
reference's cp_equiv.py does: which pairs a shard drops depends on how
the sequence is split.
"""
import pytest

import test_torch_serve_axis_workers as S
from test_torch_serve_axis_workers import serve_body  # noqa: F401 (spawned)

MODULE = "test_torch_serve_axis_families_workers"
RUNS = {"hymba-1.5b@2x2": ("hymba-1.5b", (2, 2)),
        "mamba2-2.7b@2x2": ("mamba2-2.7b", (2, 2)),
        "deepseek-moe-16b@2x2": ("deepseek-moe-16b", (2, 2))}
PAGED = [n for n in RUNS if "mamba2" not in n]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    yield from S.start_serve(tmp_path_factory, MODULE, RUNS)


@pytest.mark.parametrize("name", list(RUNS))
def test_decode_matches_the_reference(served, name):
    ranks, ref = served
    S.check_decode(ranks, ref, name)


@pytest.mark.parametrize("name", PAGED)
def test_paged_mesh_decode_is_the_fixed_lane_decode(served, name):
    ranks, _ = served
    assert S.paged_equal(ranks, name, name.startswith("hymba"))


@pytest.mark.parametrize("name", PAGED)
def test_planted_fault_every_shard_counts_every_page(served, name):
    ranks, _ = served
    assert not S.paged_equal(ranks, name, name.startswith("hymba"),
                             "planted")


@pytest.mark.parametrize("name", list(RUNS))
def test_session_tokens_equal_the_batch_synchronous_loop(served, name):
    ranks, _ = served
    S.check_session(ranks, name)


@pytest.mark.parametrize("name", list(RUNS))
def test_prefill_matches_the_reference(served, name):
    ranks, ref = served
    S.check_prefill(ranks, ref, name)

