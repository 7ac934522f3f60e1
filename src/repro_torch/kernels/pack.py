"""The lane pack and unpack kernel, #9 (port of ``repro/kernels/pack.py``,
a re-export surface over ``repro_torch.comm.kernels``).

``pack_rows``/``unpack_rows`` take any (rows, c) codes in the lane layout
of ``comm/bits.py`` (2/3/4/6/8/16-bit lanes); ``pack4``/``unpack4`` keep
the reference's 4-bit surface (two signed nibbles a byte). Each takes
``backend=`` where the reference took ``interpret=``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.comm.kernels import pack_rows, unpack_rows  # noqa: F401


def pack4(codes2d: torch.Tensor,
          backend: Optional[str] = None) -> torch.Tensor:
    """(R, c) codes in [-8, 7] -> (R, ceil(c / 2)) uint8."""
    return pack_rows(codes2d, 4, backend=backend)


def unpack4(packed2d: torch.Tensor,
            backend: Optional[str] = None) -> torch.Tensor:
    """(R, nbytes) uint8 -> (R, 2 * nbytes) int8 codes."""
    return unpack_rows(packed2d, 4, 2 * packed2d.shape[1], backend=backend)
