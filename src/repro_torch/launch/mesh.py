"""Process groups for the distributed step (the port's counterpart of
``repro/launch/mesh.py``): a ``torch.distributed`` group is the
reference's worker axis, a rank its worker, and a :class:`Grid` is its
``(pod, data, model)`` mesh: ranks laid out row-major over the axes, as
``jax.make_mesh`` lays out devices, with one process group for each set
of axes a collective spans.

NCCL for ``device="cuda"`` (one rank per card), gloo for
``device="cpu"``. Under ``torchrun`` the group comes from its
``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_ADDR``/``MASTER_PORT``;
given an ``init_method`` (``tcp://host:port``, the training launcher's
``--multihost --coordinator``), a rank and a world size, from those;
without either it is one rank over a local ``HashStore``. Nothing falls
back: a failing NCCL raises.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist


def make_process_group(device="cuda", *, store=None,
                       rank: Optional[int] = None,
                       world_size: Optional[int] = None,
                       init_method: Optional[str] = None):
    """Initialize the default process group and return it.

    ``init_method``, ``rank`` and ``world_size`` given: that rendezvous
    (one process a card; on CUDA the card is ``LOCAL_RANK`` where it is
    set, else ``rank % device_count``). ``store``/``rank``/``world_size``
    given: that group (tests pass a ``FileStore`` or ``HashStore``); else
    ``torchrun``'s environment; else one rank over a ``HashStore``. On
    CUDA the rank's card is ``LOCAL_RANK`` (0 alone) and becomes the
    current device."""
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if init_method is not None:
        if rank is None or world_size is None:
            raise ValueError("init_method needs a rank and a world size")
        local = int(os.environ.get("LOCAL_RANK", rank))
        if device.type == "cuda" and "LOCAL_RANK" not in os.environ:
            local = rank % torch.cuda.device_count()
        kw = dict(init_method=init_method)
    elif store is None and rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        kw = dict(init_method="env://")
    else:
        store = store if store is not None else dist.HashStore()
        rank = 0 if rank is None else rank
        world_size = 1 if world_size is None else world_size
        local = rank if device.index is None else device.index
        kw = dict(store=store)
    if device.type == "cuda":
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, rank=rank, world_size=world_size, **kw)
    return dist.group.WORLD


def rank_device(device="cuda") -> torch.device:
    """The device this rank computes on: its current card, or the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return device


def close_process_group() -> None:
    """Tear the default process group down (no-op when there is none)."""
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True, eq=False)
class Grid:
    """A rank's place on the ``axes`` (``("pod", "data", "model")`` or
    ``("data", "model")``) of ``sizes``: its ``coords``, and ``groups``,
    the process group of every set of axes (keyed by the axes in grid
    order) among the ranks that share this rank's other coordinates.
    A group of one rank is None where the grid spans more ranks (its
    collectives are local), and the whole grid's group where it spans
    one. ``world`` spans every rank of the grid."""

    axes: Tuple[str, ...]
    sizes: Tuple[int, ...]
    coords: Tuple[int, ...]
    groups: Dict[Tuple[str, ...], Any]
    world: Any

    def size(self, axis: str) -> int:
        return dict(zip(self.axes, self.sizes)).get(axis, 1)

    def index(self, axis: str) -> int:
        return dict(zip(self.axes, self.coords)).get(axis, 0)

    def index_over(self, axes) -> int:
        """This rank's row-major index over ``axes``."""
        idx = 0
        for a in self.axes:
            if a in axes:
                idx = idx * self.size(a) + self.index(a)
        return idx

    def group(self, axes) -> Any:
        """The process group over ``axes`` (any order) through this rank."""
        return self.groups[tuple(a for a in self.axes if a in axes)]

    @property
    def worker_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.axes if a != "model")

    @property
    def wsizes(self) -> Tuple[int, ...]:
        return tuple(self.size(a) for a in self.worker_axes)

    @property
    def n_workers(self) -> int:
        return math.prod(self.wsizes)

    @property
    def worker_index(self) -> int:
        return self.index_over(self.worker_axes)

    @property
    def workers(self) -> Any:
        """The worker group: the ranks of this rank's model shard."""
        return self.group(self.worker_axes)

    @property
    def n_shards(self) -> int:
        return self.size("model")

    @property
    def model_index(self) -> int:
        return self.index("model")

    @property
    def model(self) -> Any:
        """The model group: the shards of this rank's worker."""
        return self.group(("model",))

    @property
    def rank(self) -> int:
        """This rank's place in ``world`` (row-major over every axis)."""
        return self.index_over(self.axes)

    @classmethod
    def of_group(cls, group) -> "Grid":
        """A plain group as a grid: its ranks the data axis, one model
        shard (the flat call of ``make_train_step``)."""
        n, r = dist.get_world_size(group), dist.get_rank(group)
        return cls(axes=("data", "model"), sizes=(n, 1), coords=(r, 0),
                   groups={(): None, ("data",): group, ("model",): None,
                           ("data", "model"): group}, world=group)


def make_grid(pod: int = 0, data: Optional[int] = None, model: int = 1,
              device="cuda") -> Grid:
    """The ``(pod, data, model)`` grid over the default process group
    (made by :func:`make_process_group` first when there is none). ``pod``
    0 leaves the pod axis out; ``data`` None takes the ranks left. Every
    rank creates the same groups in the same order: for each set of axes
    (the worker group, the tiers' groups, the model group, ...) one
    ``dist.new_group`` per class of ranks sharing the other
    coordinates."""
    if not dist.is_initialized():
        make_process_group(device)
    world = dist.get_world_size()
    rank = dist.get_rank()
    axes = (("pod",) if pod else ()) + ("data", "model")
    lead = max(int(pod), 1) * int(model)
    if data is None:
        if world % lead:
            raise ValueError(f"{world} ranks do not split over pod={pod} "
                             f"x model={model}")
        data = world // lead
    sizes = ((int(pod),) if pod else ()) + (int(data), int(model))
    if math.prod(sizes) != world:
        raise ValueError(f"the grid {dict(zip(axes, sizes))} needs "
                         f"{math.prod(sizes)} ranks, {world} run")
    coords = tuple(int(c) for c in
                   _unravel(rank, sizes))
    all_coords = [tuple(_unravel(r, sizes)) for r in range(world)]
    groups: Dict[Tuple[str, ...], Any] = {}
    made: Dict[Tuple[int, ...], Any] = {}
    for k in range(len(axes) + 1):
        for sub in itertools.combinations(range(len(axes)), k):
            key = tuple(axes[i] for i in sub)
            fixed = [i for i in range(len(axes)) if i not in sub]
            classes: Dict[Tuple[int, ...], list] = {}
            for r, c in enumerate(all_coords):
                classes.setdefault(tuple(c[i] for i in fixed), []).append(r)
            mine = None
            for members in classes.values():
                members = tuple(members)
                if len(members) == world:
                    g = dist.group.WORLD
                elif len(members) == 1:
                    g = None
                elif members in made:
                    g = made[members]
                else:
                    g = made[members] = dist.new_group(list(members))
                if rank in members:
                    mine = g
            groups[key] = mine
    return Grid(axes=axes, sizes=sizes, coords=coords, groups=groups,
                world=dist.group.WORLD)


def _unravel(rank: int, sizes) -> Tuple[int, ...]:
    out = []
    for s in reversed(sizes):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


# ---------------------------------------------------------------------------
# the dry run's production grids and hardware model (launch.dryrun)
# ---------------------------------------------------------------------------

def production_grid_shape(*, multi_pod: bool = False):
    """The reference's production mesh by rank count: (data 16, model 16)
    = 256 ranks, or (pod 2, data 16, model 16) = 512; (sizes, axes)."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


# hardware model for the dry run's roofline, per card: the NVIDIA H100
# SXM5 80GB data sheet at its 700 W limit (dense rates). A model, not a
# measurement: the dry run runs no kernel.
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, bf16 tensor cores
HBM_BW = 3.35e12              # B/s
NVLINK_BW = 450e9             # B/s a direction, NVLink within a node
NIC_BW = 50e9                 # B/s a card across nodes (one 400 Gb/s NIC)
CARDS_PER_NODE = 8            # an HGX H100 node


def link_bw(ranks) -> float:
    """The slowest link a group of global ranks crosses: NVLink when
    every rank is on one node of CARDS_PER_NODE cards (ranks numbered
    node by node), else the NIC."""
    nodes = {int(r) // CARDS_PER_NODE for r in ranks}
    return NVLINK_BW if len(nodes) <= 1 else NIC_BW
