"""The port's model axis (context parallelism) at four ranks against the
JAX package: four gloo ranks on a ``(data=2, model=2)`` grid
(``launch.mesh.make_grid``) against the reference's ``make_train_step``
on a ``(data=2, model=2)`` mesh of four simulated CPU devices, both from
the reference's initial state (the harness of
``tests/test_torch_dist_hier_workers.py``). Each weight is split over the
two model shards (``sharding.shard_dim_for``), the sequence too, and the
forward gathers each layer's weights and the K/V of every shard.

  * ``dp_adam`` for the yi-6b, gemma2-2b (windows across the shards'
    boundary) and gemma3-4b (5:1 local:global, qk-norm) smoke models and
    ``qadam`` with ``model_gather_quant=8`` (the int8 gather) for yi-6b,
    three steps: losses within rel 2.3e-4 and the master within rel L2
    4e-6, the tiers of ``tests/test_torch_dist.py`` (the reference's own
    drift, ROADMAP.md queue 3);
  * a planted fault (the K/V gather with every shard's queries at
    positions from 0, without the global offset) fails the gate.

The port against itself and the checkpoints of a model-sharded run:
``tests/test_torch_model_axis_equiv_workers.py``.
"""
import pytest

import test_torch_dist_hier_workers as H
from test_torch_dist_hier_workers import BASE, Run

CP = dict(BASE, mode="dp_adam")
RUNS = {
    "cp_yi": Run("yi-6b", (0, 2, 2), CP),
    "cp_gemma2": Run("gemma2-2b", (0, 2, 2), CP),
    "cp_gemma3": Run("gemma3-4b", (0, 2, 2), CP),
    "cp_qadam_int8": Run("yi-6b", (0, 2, 2),
                         dict(BASE, model_gather_quant=8)),
}
MODULE = "test_torch_model_axis_workers"


def cp_body(rank, out_dir, init_dir):
    """The model-axis runs on this rank, each from the reference's
    initial state, and the planted fault."""
    from pathlib import Path

    from repro_torch.models import layers as L
    out = {}
    for name, run in RUNS.items():
        grid, art = H.make_step(run)
        init = Path(init_dir) / f"init_{name}.npz"
        state, losses = H.run_steps(art, H.port_state(init, grid), run)
        out[f"{name}:losses"] = losses
        out.update(H.state_arrays(state, name))
        if name == "cp_yi":
            index = L.ShardCtx.cp_index
            L.ShardCtx.cp_index = lambda self: 0      # the planted fault
            try:
                state, losses = H.run_steps(art, H.port_state(init, grid),
                                            run)
            finally:
                L.ShardCtx.cp_index = index
            out["fault:losses"] = losses
            out.update(H.state_arrays(state, "fault"))
    return out


@pytest.fixture(scope="module")
def cp(tmp_path_factory):
    gen = H.start_reference(tmp_path_factory, MODULE, tuple(RUNS))
    out, proc = next(gen)
    for name in RUNS:
        H.wait_for(out / f"init_{name}.npz", proc)
    work = tmp_path_factory.mktemp("port")
    ranks = H.spawn(MODULE, "cp_body", work, (str(out),))
    yield dict(out=out, proc=proc, ranks=ranks)
    for _ in gen:
        pass


@pytest.mark.parametrize("name", sorted(RUNS))
def test_model_axis_against_reference(cp, name):
    ok = H.gate(H.wait_for(cp["out"] / f"ref_{name}.npz", cp["proc"]),
                cp["ranks"], name)
    assert ok == (True, True)


def test_kv_gather_without_the_global_offset_fails_the_gate(cp):
    ok = H.gate(H.wait_for(cp["out"] / "ref_cp_yi.npz", cp["proc"]),
                cp["ranks"], "fault")
    assert ok != (True, True)
