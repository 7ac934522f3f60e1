"""The quantizer kernels' wrappers (port of ``repro/kernels/quantize.py``,
a re-export surface). The kernels and their plain versions live in
``repro_torch.comm.kernels``: K3 ``amax_rows``, K4
``uniform_quantize_rows``, K12 ``uniform_dequantize_rows``, #10
``log_quantize``, K11 ``log_dequantize``, #13 ``ternary_quantize`` and
#14 ``blockwise_quantize``. Each takes ``backend=`` ("cuda", "torch" or
None by the tensors' device) where the reference took ``interpret=``.
"""
from __future__ import annotations

from repro_torch.comm.kernels import (  # noqa: F401
    BLOCK,
    amax_rows,
    blockwise_quantize,
    log_dequantize,
    log_quantize,
    ternary_quantize,
    uniform_dequantize_rows,
    uniform_quantize_rows,
)
