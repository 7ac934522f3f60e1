"""Backend policy and the two grid codecs, log Q_g and uniform Q_x (port
of the parts of ``repro/comm/codec.py`` that serving and the
single-machine optimizer need: scales, quantize, dequantize and lane
widths; the wire encode/decode, ``WireBuffer`` and the spec registry wait
for the distributed slice, ROADMAP queue 1).

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
from repro_torch.opt import grids

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


def _amax_scale(x: torch.Tensor, backend: Optional[str]) -> torch.Tensor:
    """The reference's per-tensor amax scale, ``where(amax > 0, amax, 1)``
    (``grids.amax_scale``), its amax from K3; a 0-d float32 tensor. (The
    kernel modules import this one for ``resolve_backend``, hence the
    imports inside the functions.)"""
    from repro_torch.comm import kernels as K
    from repro_torch.opt import engine
    amax = K.amax_rows(x.to(torch.float32).reshape(1, -1), backend=backend)
    return engine.amax_scale(amax[0])


@dataclasses.dataclass(frozen=True)
class LogCodec:
    """The paper's Q_g: log grid, per-tensor amax scale. Codes live in
    [-(k_g+1), k_g+1] and pack to the smallest lane holding them."""

    k_g: int = 6
    kind = "log"

    @property
    def bits(self) -> int:
        return B.lane_bits_for(self.k_g + 1)

    def compute_scale(self, x: torch.Tensor,
                      backend: Optional[str] = None) -> torch.Tensor:
        return _amax_scale(x, backend)

    def quantize(self, x: torch.Tensor, scale: torch.Tensor,
                 backend: Optional[str] = None) -> torch.Tensor:
        """Log-grid int8 codes given a scale. Its TPU kernel
        (``log_quantize_pallas``) is not ported yet (ROADMAP queue 2), so
        CUDA tensors raise; the update path quantizes inside K16."""
        if resolve_backend(backend, x) == "cuda":
            raise NotImplementedError(
                "log_quantize has no CUDA kernel yet (ROADMAP.md queue 2); "
                "the optimizer's Q_g quantizes inside K16 "
                "(engine.adam_ef_step)")
        return grids.log_quantize(x, scale, self.k_g)

    def dequantize(self, codes: torch.Tensor, scale: torch.Tensor,
                   backend: Optional[str] = None) -> torch.Tensor:
        from repro_torch.opt import engine
        return engine.dequantize_log(codes, scale, self.k_g, backend=backend)


@dataclasses.dataclass(frozen=True)
class UniformCodec:
    """The paper's Q_x: uniform grid over [-scale, scale] (``absolute``:
    scale = 0.5, else a per-tensor amax scale). Codes reach +/- 2^k_x and
    pack exactly into the next lane up, the residency lane."""

    k_x: int = 7
    absolute: bool = True
    kind = "uniform"

    @property
    def bits(self) -> int:
        return B.lane_bits_for(2 ** self.k_x)

    @property
    def clip_abs(self) -> Optional[int]:
        top = 2 ** (self.bits - 1) - 1
        return top if 2 ** self.k_x > top else None

    def compute_scale(self, x: torch.Tensor,
                      backend: Optional[str] = None) -> torch.Tensor:
        """0.5 for the absolute grid, else ``grids.amax_scale`` (zero
        guard 1, not the 1e-30 floor of ``engine.quantize_uniform``)."""
        if self.absolute:
            return torch.full((), 0.5, dtype=torch.float32, device=x.device)
        return _amax_scale(x, backend)

    def quantize(self, x: torch.Tensor, scale: torch.Tensor,
                 backend: Optional[str] = None) -> torch.Tensor:
        """Codes of the whole tensor against one scale (K4)."""
        from repro_torch.comm import kernels as K
        codes = K.uniform_quantize_rows(
            x.to(torch.float32).reshape(1, -1), scale.reshape(1), self.k_x,
            backend=backend)
        return codes.reshape(x.shape)

    def dequantize(self, codes: torch.Tensor, scale: torch.Tensor,
                   backend: Optional[str] = None) -> torch.Tensor:
        from repro_torch.opt import engine
        return engine.dequantize_uniform(codes, scale, self.k_x,
                                         backend=backend)
