"""Process groups for the distributed step (the port's counterpart of
``repro/launch/mesh.py``): a ``torch.distributed`` group is the
reference's worker axis, a rank its worker.

NCCL for ``device="cuda"`` (one rank per card), gloo for
``device="cpu"``. Under ``torchrun`` the group comes from its
``RANK``/``WORLD_SIZE``/``LOCAL_RANK``/``MASTER_ADDR``/``MASTER_PORT``;
without them it is one rank over a local ``HashStore``. Nothing falls
back: a failing NCCL raises.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def make_process_group(device="cuda", *, store=None,
                       rank: Optional[int] = None,
                       world_size: Optional[int] = None):
    """Initialize the default process group and return it.

    ``store``/``rank``/``world_size`` given: that group (tests pass a
    ``FileStore`` or ``HashStore``); else ``torchrun``'s environment;
    else one rank over a ``HashStore``. On CUDA the rank's card is
    ``LOCAL_RANK`` (0 alone) and becomes the current device."""
    device = torch.device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if store is None and rank is None and "RANK" in os.environ:
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
