"""The error-feedback baselines ``ef_sgd`` (blockwise sign codes + EF)
and ``efadam`` (server-side EF on an amax-scaled weight broadcast) at
two and four gloo workers against the JAX package, by the machinery and
at the tiers of ``tests/test_torch_dist_workers.py``. ``ef_sgd`` runs the
smoke model with 501 tokens: its embedding and output head hold 64,128
elements, so at 2 and 4 workers the chunks (32,064 and 16,032) end
inside 256-element blocks and each worker rescales its codes by the
scale columns at its chunk's offset; every worker reading worker 0's
columns instead (a planted fault) fails the gate.
"""
import pytest

from test_torch_dist_workers import (WIDTHS, check_against_reference,
                                     start_reference)

NAMES = ("ef_sgd", "efadam")


@pytest.fixture(scope="module")
def ef_reference(tmp_path_factory):
    yield from start_reference(tmp_path_factory, NAMES)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("n_workers", WIDTHS)
def test_ef_baselines_against_reference(ef_reference, tmp_path, name,
                                        n_workers):
    check_against_reference(ef_reference, tmp_path, name, n_workers)
