"""The paper's quantization operators Q_g and Q_x (port of
``repro/core/quantizers.py``, the operators the single-machine optimizer
uses).

  Q_g(g) = ||g||_inf * argmin_{ghat in G^d} || g/||g||_inf - ghat ||,
      G = {-1, ..., -2^{-k_g}, 0, 2^{-k_g}, ..., 1}            (log grid)

  Q_x(x) = 0.5 * argmin_{xhat in X} || 2x - xhat ||,
      X = {-1, ..., -1/2^{k_x}, 0, 1/2^{k_x}, ..., 1}          (uniform grid)

Each operator wraps a codec of ``repro_torch.comm.codec``; ``QTensor``
holds the unpacked integer codes and the scale. The Algorithm 1
baselines' operators (TernGrad, blockwise sign) are not ported yet
(ROADMAP.md queue 1; the codecs of those names are, for the distributed
baselines).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.comm.codec import LogCodec, UniformCodec


@dataclasses.dataclass
class QTensor:
    """Integer codes + scale, before bit-packing."""

    codes: torch.Tensor
    scale: torch.Tensor
    kind: str
    bits: int
    shape: tuple


@dataclasses.dataclass(frozen=True)
class Quantizer:
    """A named quantization operator Q(.)."""

    name: str

    def encode(self, x: torch.Tensor,
               backend: Optional[str] = None) -> QTensor:
        raise NotImplementedError

    def decode(self, qt: QTensor,
               backend: Optional[str] = None) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, x: torch.Tensor,
                 backend: Optional[str] = None) -> torch.Tensor:
        """decode(encode(x)); ``backend`` picks the codec's kernels or
        their plain versions (``repro_torch.comm.codec``)."""
        return self.decode(self.encode(x, backend), backend)


@dataclasses.dataclass(frozen=True)
class IdentityQuantizer(Quantizer):
    name: str = "identity"

    def __call__(self, x, backend=None):
        return x


@dataclasses.dataclass(frozen=True)
class LogGradQuantizer(Quantizer):
    """The paper's Q_g."""

    k_g: int = 6
    name: str = "log"

    @property
    def codec(self) -> LogCodec:
        return LogCodec(k_g=self.k_g)

    def encode(self, x, backend=None):
        cd = self.codec
        x = x.to(torch.float32)
        scale = cd.compute_scale(x, backend)
        return QTensor(codes=cd.quantize(x, scale, backend), scale=scale,
                       kind="log", bits=cd.bits, shape=tuple(x.shape))

    def decode(self, qt, backend=None):
        return self.codec.dequantize(qt.codes, qt.scale, backend)


@dataclasses.dataclass(frozen=True)
class UniformWeightQuantizer(Quantizer):
    """The paper's Q_x. ``absolute=True`` is the grid over [-0.5, 0.5];
    ``absolute=False`` scales it by the tensor's amax."""

    k_x: int = 7
    absolute: bool = True
    name: str = "uniform"

    @property
    def codec(self) -> UniformCodec:
        return UniformCodec(k_x=self.k_x, absolute=self.absolute)

    def encode(self, x, backend=None):
        cd = self.codec
        x = x.to(torch.float32)
        scale = cd.compute_scale(x, backend)
        return QTensor(codes=cd.quantize(x, scale, backend), scale=scale,
                       kind="uniform", bits=cd.bits, shape=tuple(x.shape))

    def decode(self, qt, backend=None):
        return self.codec.dequantize(qt.codes, qt.scale, backend)


def get_quantizer(spec: Optional[str]) -> Quantizer:
    """Parse a quantizer spec string: 'none', 'log:k', 'uniform:k',
    'uniform_amax:k' (the reference's grammar; its 'terngrad' and
    'blockwise:b' are not ported yet)."""
    if spec is None or spec in ("none", "identity", "fp32"):
        return IdentityQuantizer()
    head, _, arg = spec.partition(":")
    if head == "log":
        return LogGradQuantizer(k_g=int(arg or 6))
    if head == "uniform":
        return UniformWeightQuantizer(k_x=int(arg or 7), absolute=True)
    if head == "uniform_amax":
        return UniformWeightQuantizer(k_x=int(arg or 7), absolute=False)
    raise NotImplementedError(
        f"quantizer spec {spec!r} is not ported (the port has 'none', "
        "'log:k', 'uniform:k' and 'uniform_amax:k'; the baselines' "
        "'terngrad' and 'blockwise:b' are queued in ROADMAP.md)")
