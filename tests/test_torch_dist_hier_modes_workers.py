"""The port's hierarchical topology at 2x2 for the ``adaptive`` and
``terngrad`` modes against the JAX package (the grid harness of
``tests/test_torch_dist_hier_workers.py``: four gloo ranks on a
``(pod=2, data=2)`` grid against the reference's
``HierarchicalTopology(2, 2)`` on four simulated devices, from its
initial state, three steps).

  * ``adaptive`` with every lane of the plan on two leaves:
    ``verify_accounting`` holds the tiered bytes (the inter tier's
    ``n_inter`` rows a leaf, the intra tier's gradient gather and the
    broadcast's fan-out) against measured payloads on every rank, and
    the run passes the gate of ``tests/test_torch_dist.py`` (losses rel
    2.3e-4, master rel L2 4e-6);
  * ``terngrad`` with the reference's draws replayed, keyed as the
    reference's by the inter-tier worker index: the same gate, and a
    node's two devices encode the same codes (their draws are the
    same), where the two nodes' differ.
"""
import numpy as np
import pytest

import test_torch_dist_hier_workers as H

NAMES = ("hier_adaptive", "hier_terngrad")


@pytest.fixture(scope="module")
def hier(tmp_path_factory):
    yield from H.start_hier(tmp_path_factory, NAMES, False)


@pytest.mark.parametrize("name", NAMES)
def test_hierarchical_modes_against_reference(hier, name):
    out, proc, ranks = hier
    ok = H.gate(H.wait_for(out / f"ref_{name}.npz", proc), ranks, name)
    assert ok == (True, True)


def test_adaptive_accounting_is_exact(hier):
    _, _, ranks = hier
    assert all(r["adaptive:verified"][0] == 1 for r in ranks)


def test_terngrad_node_devices_draw_the_same_codes(hier):
    _, _, ranks = hier
    for node in (0, 1):
        np.testing.assert_array_equal(ranks[2 * node]["terngrad:sent"],
                                      ranks[2 * node + 1]["terngrad:sent"])
    assert not np.array_equal(ranks[0]["terngrad:sent"],
                              ranks[2]["terngrad:sent"])
