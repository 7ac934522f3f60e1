"""Bit-packing of quantization codes (port of ``repro/core/packing.py``):
the flat form of the lane packer, one payload row, through #9
(``repro_torch.comm.kernels`` ``pack_rows``/``unpack_rows``) on CUDA
tensors. The byte layout is ``repro_torch.comm.bits``'s."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.comm import kernels as K
from repro_torch.comm.bits import (  # noqa: F401
    SUPPORTED_BITS,
    packed_nbytes,
)


def pack_codes(codes: torch.Tensor, bits: int,
               backend: Optional[str] = None) -> torch.Tensor:
    """Signed int codes of any shape -> a flat uint8 payload of
    ``packed_nbytes(numel, bits)`` bytes."""
    return K.pack_rows(codes.reshape(1, -1), bits, backend=backend)[0]


def unpack_codes(packed: torch.Tensor, bits: int, numel: int,
                 backend: Optional[str] = None) -> torch.Tensor:
    """Inverse of :func:`pack_codes` -> (numel,) codes (int8; int16 for
    16-bit lanes)."""
    return K.unpack_rows(packed.reshape(1, -1), bits, numel,
                         backend=backend)[0]
