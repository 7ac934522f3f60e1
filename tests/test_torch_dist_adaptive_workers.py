"""The port's ``adaptive`` mode at two workers against the JAX package:
gloo ranks in spawned processes against the reference on two simulated
CPU devices in a subprocess (``test_torch_dist_workers.py``'s harness),
from the reference's initial state, on a plan that puts every lane of
``repro_torch.adapt.WIDTH_SPECS`` on two leaves. Three steps: losses
within rel 2.3e-4 and the master within rel L2 4e-6 (the reference's own
drift, ROADMAP queue 3); every rank holds the same losses. The stats
rows are reduced across the ranks inside the step (an all-reduce MAX for
amax, a mean of the powers).
"""
import pytest

import test_torch_dist_workers as W


@pytest.fixture(scope="module")
def adaptive_reference(tmp_path_factory):
    yield from W.start_reference(tmp_path_factory, ("adaptive",), (2,))


def test_two_workers_against_reference(adaptive_reference, tmp_path):
    W.check_against_reference(adaptive_reference, tmp_path, "adaptive", 2)
