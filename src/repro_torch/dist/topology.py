"""Parameter-server topologies (port of ``repro/dist/topology.py``).

The paper's Algorithms 2+3 assume one flat worker-server wire; a real
cluster has fast links inside a node (NVLink) and slow ones between
nodes. A :class:`HierarchicalTopology` splits the worker axes into two
tiers:

  * **intra tier** (fast): every leaf's gradient is gathered in float32
    over the devices of a node and tree-averaged
    (``modes.base.tier_grad_mean``) before the update, so a node's
    devices hold bitwise the same moments, residuals and codes;
  * **inter tier** (slow): the quantized exchange and the first leg of
    the weight broadcast run across nodes only. A device all-to-alls the
    ``n_inter`` payload rows of its intra position instead of all
    ``n_workers`` rows, so the inter-node bytes fall by exactly
    ``1/devices_per_node``.

:class:`FlatTopology` resolves to one tier over every worker axis, where
every tiered path is the flat collective op for op.

Resolution (:meth:`HierarchicalTopology.tiers`): the node tier is a
prefix of the worker axes whose sizes multiply to ``nodes``, the rest
multiplies to ``devices_per_node`` (``sharding.split_worker_axes``); a
``(pod=2, data=4)`` grid with worker axes ``("pod", "data")`` is 2 nodes
of 4 devices. ``--topology NxD`` in ``repro_torch.launch.train`` lays
the grid out to match.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

from repro_torch.dist import sharding as SH


@dataclasses.dataclass(frozen=True)
class Tiers:
    """A topology resolved against the worker axes: the inter (exchange)
    tier and the intra (float32 reduce) tier, both in grid axis order.
    ``intra_axes == ()`` is flat."""

    inter_axes: Tuple[str, ...]
    inter_sizes: Tuple[int, ...]
    intra_axes: Tuple[str, ...]
    intra_sizes: Tuple[int, ...]

    @property
    def n_inter(self) -> int:
        return math.prod(int(s) for s in self.inter_sizes)

    @property
    def n_intra(self) -> int:
        return math.prod(int(s) for s in self.intra_sizes)

    @property
    def hierarchical(self) -> bool:
        return bool(self.intra_axes)


@dataclasses.dataclass(frozen=True)
class Topology:
    """How the worker axes map onto link tiers."""

    def tiers(self, worker_axes: Sequence[str],
              wsizes: Sequence[int]) -> Tiers:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FlatTopology(Topology):
    """One tier: every collective spans all workers."""

    def tiers(self, worker_axes, wsizes) -> Tiers:
        return Tiers(inter_axes=tuple(worker_axes),
                     inter_sizes=tuple(int(s) for s in wsizes),
                     intra_axes=(), intra_sizes=())


@dataclasses.dataclass(frozen=True)
class HierarchicalTopology(Topology):
    """``nodes`` groups of ``devices_per_node`` workers: a float32
    intra-node gradient reduce, the quantized exchange across nodes
    only."""

    nodes: int
    devices_per_node: int

    def tiers(self, worker_axes, wsizes) -> Tiers:
        inter_a, inter_s, intra_a, intra_s = SH.split_worker_axes(
            worker_axes, wsizes, self.nodes, self.devices_per_node)
        return Tiers(inter_axes=inter_a, inter_sizes=inter_s,
                     intra_axes=intra_a, intra_sizes=intra_s)


def flat_tiers(worker_axes: Sequence[str], wsizes: Sequence[int]) -> Tiers:
    """Single-tier resolution: what ``None``/absent topologies mean."""
    return FlatTopology().tiers(worker_axes, wsizes)


def parse_topology(spec) -> Topology:
    """``"flat"``/``None`` -> FlatTopology, ``"NxD"`` ->
    HierarchicalTopology(N, D); Topology instances pass through."""
    if spec is None or isinstance(spec, Topology):
        return spec if isinstance(spec, Topology) else FlatTopology()
    s = str(spec).strip().lower()
    if s in ("", "flat"):
        return FlatTopology()
    parts = s.split("x")
    if len(parts) == 2 and all(p.isdigit() for p in parts):
        return HierarchicalTopology(nodes=int(parts[0]),
                                    devices_per_node=int(parts[1]))
    raise ValueError(f"bad topology spec {spec!r}: expected 'flat' or "
                     f"'NxD' (e.g. '2x4')")
