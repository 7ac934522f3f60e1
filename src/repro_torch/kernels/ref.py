"""The plain grid and update math (port of ``repro/kernels/ref.py``, a
re-export of ``repro_torch.opt.grids``): the functions every kernel is
held against."""
from __future__ import annotations

from repro_torch.opt.grids import (  # noqa: F401
    adam_ef_moments,
    adam_ef_quantize,
    block_amax,
    log_dequantize,
    log_quantize,
    ternary_quantize,
    uniform_dequantize,
    uniform_quantize,
)
