"""Backend policy and the uniform codec's lane choice (port of the parts
of ``repro/comm/codec.py`` that serving needs).

Backends: ``"torch"`` is the plain PyTorch version of a kernel (what the
CPU tests run, and the yardstick a kernel is held against on the card);
``"cuda"`` is the hand-written Hopper kernel. ``backend=None`` picks the
kernel for CUDA tensors and the plain version for CPU tensors. An
explicit backend always wins; ``"cuda"`` on a CPU tensor raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.comm import bits as B

BACKENDS = ("torch", "cuda")


def resolve_backend(backend: Optional[str], *tensors: torch.Tensor) -> str:
    """Pick the implementation for ``tensors`` (all on one device)."""
    on_cuda = all(t.is_cuda for t in tensors)
    if backend is None:
        return "cuda" if on_cuda else "torch"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; "
                         f"expected one of {BACKENDS}")
    if backend == "cuda" and not on_cuda:
        raise ValueError("backend='cuda' needs CUDA tensors")
    return backend


@dataclasses.dataclass(frozen=True)
class UniformCodec:
    """The paper's Q_x: uniform grid over [-scale, scale] (``absolute``:
    scale = 0.5, else a per-tensor amax scale). Codes reach +/- 2^k_x and
    pack exactly into the next lane up, the residency lane."""

    k_x: int = 7
    absolute: bool = True

    @property
    def bits(self) -> int:
        return B.lane_bits_for(2 ** self.k_x)

    @property
    def clip_abs(self) -> Optional[int]:
        top = 2 ** (self.bits - 1) - 1
        return top if 2 ** self.k_x > top else None
