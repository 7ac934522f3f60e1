"""TernGrad at two and four gloo workers against the JAX package, by
the machinery and at the tiers of ``tests/test_torch_dist_workers.py``:
each rank's ``draw_uniform`` replays the reference's draws (its key folded
per step, leaf and worker), so the stochastic codes are the reference's
and the trajectories agree to the trajectory tier.
"""
import pytest

from test_torch_dist_workers import (WIDTHS, check_against_reference,
                                     start_reference)


@pytest.fixture(scope="module")
def terngrad_reference(tmp_path_factory):
    yield from start_reference(tmp_path_factory, ("terngrad",))


@pytest.mark.parametrize("n_workers", WIDTHS)
def test_terngrad_workers_against_reference(terngrad_reference, tmp_path,
                                            n_workers):
    check_against_reference(terngrad_reference, tmp_path, "terngrad",
                            n_workers)
