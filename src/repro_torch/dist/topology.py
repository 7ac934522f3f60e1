"""Parameter-server topologies (port of ``repro/dist/topology.py``, the
flat topology).

The port runs the paper's flat wire: one tier, every collective spans
all workers. ``HierarchicalTopology`` (an fp intra-node gradient reduce
and a quantized exchange across nodes only) parses but raises until it
is ported (ROADMAP.md queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Tiers:
    """A topology resolved against the workers: the inter (exchange) tier
    and the intra (fp-reduce) tier. ``intra_sizes == ()`` is flat."""

    inter_axes: Tuple[str, ...]
    inter_sizes: Tuple[int, ...]
    intra_axes: Tuple[str, ...]
    intra_sizes: Tuple[int, ...]



@dataclasses.dataclass(frozen=True)
class Topology:
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
    """``nodes`` groups of ``devices_per_node`` workers (not ported)."""

    nodes: int
    devices_per_node: int

    def tiers(self, worker_axes, wsizes) -> Tiers:
        raise NotImplementedError(
            "HierarchicalTopology is not ported yet (ROADMAP.md queue 1); "
            "the port runs the flat topology")


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
