"""The paper's quantization operators and the baselines' (port of
``repro/core/quantizers.py``): thin shims over the codecs of
``repro_torch.comm.codec``.

  Q_g(g) = ||g||_inf * argmin_{ghat in G^d} || g/||g||_inf - ghat ||,
      G = {-1, ..., -2^{-k_g}, 0, 2^{-k_g}, ..., 1}            (log grid)

  Q_x(x) = 0.5 * argmin_{xhat in X} || 2x - xhat ||,
      X = {-1, ..., -1/2^{k_x}, 0, 1/2^{k_x}, ..., 1}          (uniform grid)

Baselines: TernGrad (Wen et al. '17; #13 on uniforms drawn outside the
kernel) and blockwise sign (Zheng et al. '19; #14). ``QTensor`` holds
the unpacked integer codes and the scale(s). Every function takes
``backend=`` ("cuda", "torch" or None by the tensors' device). The
stochastic operator takes its uniforms ``u=`` (float32, x's shape);
``TernGradQuantizer.encode`` may draw them from a ``generator=`` instead.
The reference takes a ``key=``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.comm import codec as CD
from repro_torch.comm.bits import lane_bits_for, payload_nbytes
from repro_torch.opt import engine, grids


@dataclasses.dataclass
class QTensor:
    """Integer codes + scale, before bit-packing: int8 codes (int16 for
    wide uniform grids), a 0-d scale per tensor or (nb,) per block."""

    codes: torch.Tensor
    scale: torch.Tensor
    kind: str
    bits: int
    shape: tuple

    @property
    def nbytes_wire(self) -> int:
        """Exact bytes on the wire: the packed payload and the float32
        scale bytes."""
        numel = math.prod(self.shape)
        scale_bytes = (self.scale.numel() * 4
                       if isinstance(self.scale, torch.Tensor) else 4)
        return payload_nbytes(numel, self.bits) + scale_bytes


# ---------------------------------------------------------------------------
# the functional operators
# ---------------------------------------------------------------------------

def log_bits(k_g: int) -> int:
    """Packed lane bits of the log grid (codes in [-(k_g+1), k_g+1])."""
    return lane_bits_for(k_g + 1)


def log_encode(g: torch.Tensor, k_g: int,
               backend: Optional[str] = None) -> QTensor:
    """Nearest-in-linear-space log-grid codes against the per-tensor
    amax scale (K3, then #10)."""
    cd = CD.LogCodec(k_g=k_g)
    g = g.to(torch.float32)
    scale = cd.compute_scale(g, backend=backend)
    return QTensor(codes=cd.quantize(g, scale, backend=backend),
                   scale=scale, kind="log", bits=cd.bits,
                   shape=tuple(g.shape))


def log_decode(qt: QTensor, k_g: int,
               backend: Optional[str] = None) -> torch.Tensor:
    return CD.LogCodec(k_g=k_g).dequantize(qt.codes, qt.scale,
                                           backend=backend)


def uniform_encode(x: torch.Tensor, k_x: int, absolute: bool = True,
                   backend: Optional[str] = None) -> QTensor:
    """The uniform grid: over [-0.5, 0.5] (``absolute``, the paper's Q_x)
    or scaled by the tensor's amax (K3); codes from K4."""
    cd = CD.UniformCodec(k_x=k_x, absolute=absolute)
    x = x.to(torch.float32)
    scale = cd.compute_scale(x, backend=backend)
    return QTensor(codes=cd.quantize(x, scale, backend=backend),
                   scale=scale, kind="uniform", bits=cd.bits,
                   shape=tuple(x.shape))


def uniform_decode(qt: QTensor, k_x: int,
                   backend: Optional[str] = None) -> torch.Tensor:
    return CD.UniformCodec(k_x=k_x).dequantize(qt.codes, qt.scale,
                                               backend=backend)


def ternary_encode(g: torch.Tensor, u: torch.Tensor,
                   backend: Optional[str] = None) -> QTensor:
    """TernGrad codes against the amax scale (``engine.quantize_ternary``:
    K3, the zero guard, then #13) from the uniforms ``u`` of g's shape."""
    codes, scale = engine.quantize_ternary(g, u, backend=backend)
    return QTensor(codes=codes, scale=scale, kind="ternary",
                   bits=CD.TernaryCodec.bits, shape=tuple(g.shape))


def ternary_decode(qt: QTensor) -> torch.Tensor:
    return CD.TernaryCodec().dequantize(qt.codes, qt.scale)


def blockwise_encode(g: torch.Tensor, block: int = 256,
                     backend: Optional[str] = None) -> QTensor:
    """Sign codes (nb, block) and per-block mean |g| scales (nb,) over
    flat blocks, the tail zero-padded (#14)."""
    codes, scale = engine.quantize_blockwise(g, block, backend=backend)
    return QTensor(codes=codes, scale=scale, kind="blockwise", bits=1,
                   shape=tuple(g.shape))


def blockwise_decode(qt: QTensor) -> torch.Tensor:
    vals = grids.blockwise_dequantize(qt.codes, qt.scale)
    return vals.reshape(-1)[:math.prod(qt.shape)].reshape(qt.shape)


# ---------------------------------------------------------------------------
# the operator objects
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Quantizer:
    """A named quantization operator Q(.)."""

    name: str

    def encode(self, x: torch.Tensor, backend: Optional[str] = None, *,
               u: Optional[torch.Tensor] = None) -> QTensor:
        raise NotImplementedError

    def decode(self, qt: QTensor,
               backend: Optional[str] = None) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, x: torch.Tensor, backend: Optional[str] = None, *,
                 u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """decode(encode(x)); ``backend`` picks the codec's kernels or
        their plain versions (``repro_torch.comm.codec``)."""
        return self.decode(self.encode(x, backend, u=u), backend)

    @property
    def codec(self) -> CD.Codec:
        """The registry codec behind this operator."""
        raise NotImplementedError

    @property
    def wire_bits(self) -> float:
        """Average payload bits per element (scales excluded)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class IdentityQuantizer(Quantizer):
    name: str = "identity"

    def encode(self, x, backend=None, *, u=None):
        return QTensor(codes=x, scale=torch.ones((), device=x.device),
                       kind="identity", bits=x.element_size() * 8,
                       shape=tuple(x.shape))

    def decode(self, qt, backend=None):
        return qt.codes

    def __call__(self, x, backend=None, *, u=None):
        return x

    @property
    def codec(self):
        return CD.IdentityCodec()

    @property
    def wire_bits(self):
        return 32.0


@dataclasses.dataclass(frozen=True)
class LogGradQuantizer(Quantizer):
    """The paper's Q_g."""

    k_g: int = 6
    name: str = "log"

    def encode(self, x, backend=None, *, u=None):
        return log_encode(x, self.k_g, backend)

    def decode(self, qt, backend=None):
        return log_decode(qt, self.k_g, backend)

    @property
    def codec(self):
        return CD.LogCodec(k_g=self.k_g)

    @property
    def wire_bits(self):
        return float(log_bits(self.k_g))


@dataclasses.dataclass(frozen=True)
class UniformWeightQuantizer(Quantizer):
    """The paper's Q_x. ``absolute=True`` is the grid over [-0.5, 0.5];
    ``absolute=False`` scales it by the tensor's amax."""

    k_x: int = 7
    absolute: bool = True
    name: str = "uniform"

    def encode(self, x, backend=None, *, u=None):
        return uniform_encode(x, self.k_x, self.absolute, backend)

    def decode(self, qt, backend=None):
        return uniform_decode(qt, self.k_x, backend)

    @property
    def codec(self):
        return CD.UniformCodec(k_x=self.k_x, absolute=self.absolute)

    @property
    def wire_bits(self):
        return float(self.codec.bits)


@dataclasses.dataclass(frozen=True)
class TernGradQuantizer(Quantizer):
    """TernGrad: unbiased stochastic ternary codes; ``encode`` needs the
    uniforms ``u=`` or a ``generator=`` to draw them from (the reference
    asserts on its ``key=``)."""

    name: str = "terngrad"

    def encode(self, x, backend=None, *, u=None,
               generator: Optional[torch.Generator] = None):
        if u is None:
            if generator is None:
                raise ValueError("TernGrad is stochastic; pass u= or "
                                 "generator=")
            u = torch.rand(x.shape, generator=generator, device=x.device)
        return ternary_encode(x, u, backend)

    def decode(self, qt, backend=None):
        return ternary_decode(qt)

    @property
    def codec(self):
        return CD.TernaryCodec()

    @property
    def wire_bits(self):
        return 2.0


@dataclasses.dataclass(frozen=True)
class BlockwiseQuantizer(Quantizer):
    """Blockwise sign codes with per-block mean |x| scales."""

    block: int = 256
    name: str = "blockwise"

    def encode(self, x, backend=None, *, u=None):
        return blockwise_encode(x, self.block, backend)

    def decode(self, qt, backend=None):
        return blockwise_decode(qt)

    @property
    def codec(self):
        return CD.BlockwiseCodec(block=self.block)

    @property
    def wire_bits(self):
        return 1.0 + 32.0 / self.block


def get_quantizer(spec: Optional[str]) -> Quantizer:
    """Parse a quantizer spec string (the reference's grammar): 'none',
    'log:k', 'uniform:k', 'uniform_amax:k', 'terngrad', 'blockwise:b'."""
    if spec is None or spec in ("none", "identity", "fp32"):
        return IdentityQuantizer()
    head, _, arg = spec.partition(":")
    if head == "log":
        return LogGradQuantizer(k_g=int(arg or 6))
    if head == "uniform":
        return UniformWeightQuantizer(k_x=int(arg or 7), absolute=True)
    if head == "uniform_amax":
        return UniformWeightQuantizer(k_x=int(arg or 7), absolute=False)
    if head == "terngrad":
        return TernGradQuantizer()
    if head == "blockwise":
        return BlockwiseQuantizer(block=int(arg or 256))
    raise ValueError(f"unknown quantizer spec: {spec}")
