"""The paper's uniform weight grid Q_x (port of ``repro/opt/grids.py``,
uniform part).

Plain tensor functions with explicit scales (pass 1 amax, pass 2
quantize). Each matches the reference's float32 arithmetic step for
step, so codes and dequantized values are bitwise equal to it for the
same input and scale.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def block_amax(x: torch.Tensor) -> torch.Tensor:
    """Per-call global amax (the scale pass)."""
    return x.to(torch.float32).abs().amax()


def amax_scale(x: torch.Tensor) -> torch.Tensor:
    """Amax scale with the zero guard every channel shares."""
    amax = block_amax(x)
    return torch.where(amax > 0, amax, torch.ones_like(amax))


def uniform_code_dtype(k_x: int) -> torch.dtype:
    """Codes live in [-2^k, 2^k]: int8 holds k_x <= 6, int16 k_x <= 14."""
    if k_x <= 6:
        return torch.int8
    return torch.int16 if k_x <= 14 else torch.int32


def uniform_quantize(x: torch.Tensor, scale, k_x: int) -> torch.Tensor:
    """``round(clip(x / max(scale, 1e-30), -1, 1) * 2^k)``; ``round``
    is half to even, as ``jnp.round``. ``scale`` broadcasts against x."""
    n = float(2 ** k_x)
    s = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    y = torch.clamp(x.to(torch.float32) / torch.clamp_min(s, 1e-30), -1.0, 1.0)
    return torch.round(y * n).to(uniform_code_dtype(k_x))


def uniform_dequantize(codes: torch.Tensor, scale, k_x: int) -> torch.Tensor:
    """``codes / 2^k * scale`` in float32 (the division is exact)."""
    n = float(2 ** k_x)
    s = torch.as_tensor(scale, dtype=torch.float32, device=codes.device)
    return codes.to(torch.float32) / n * s


@functools.lru_cache(maxsize=None)
def uniform_dequant_table(k_x: int, bits: int) -> np.ndarray:
    """Scale-1 dequant values per ``bits``-wide lane code, ordered by raw
    lane value (index = code + 2^{bits-1}), built by evaluating
    :func:`uniform_dequantize` itself."""
    n = 1 << bits
    codes = torch.arange(-(n // 2), n // 2, dtype=torch.int32)
    return uniform_dequantize(codes, 1.0, k_x).numpy()
