"""K3 per-row amax and K4 per-row uniform quantize: the Q_x residency
passes behind ``quantize_params``.

Replace ``repro/comm/kernels.py`` ``amax_pallas`` and
``uniform_quantize_pallas``. The kernels live in ``csrc/quantize.cu``
(design notes there): both are bound by bytes, one launch covers every
row of a ``(rows, n)`` view, so a stacked ``(L, ...)`` leaf gets its L
per-layer scales (the reference's vmap over layers) in one launch.

Beside each kernel: its plain PyTorch version (``_amax_rows_torch``,
``_uniform_quantize_torch``), which a wrapper runs only for CPU tensors
or when asked with ``backend="torch"``, and plain-int launch counters.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import build
from repro_torch.comm.codec import resolve_backend
from repro_torch.opt import grids

amax_launches = 0          # K3 kernel launches
quantize_launches = 0      # K4 kernel launches
plain_on_cuda = 0          # plain versions run on CUDA tensors


def _check_rows(x2d: torch.Tensor) -> None:
    if x2d.dim() != 2 or x2d.dtype != torch.float32:
        raise ValueError(f"need a (rows, n) float32 tensor, got "
                         f"{tuple(x2d.shape)} {x2d.dtype}")
    if not 1 <= x2d.shape[0] <= 65535:
        raise ValueError(f"rows={x2d.shape[0]} outside [1, 65535]")


def _amax_rows_torch(x2d: torch.Tensor) -> torch.Tensor:
    return x2d.abs().amax(dim=1)


def _amax_rows_cuda(x2d: torch.Tensor) -> torch.Tensor:
    global amax_launches
    lib = build.library()
    x2d = x2d.contiguous()
    out = torch.zeros(x2d.shape[0], dtype=torch.float32, device=x2d.device)
    err = lib.rt_amax_rows(build.ptr(x2d), build.ptr(out), x2d.shape[0],
                           x2d.shape[1], build.stream_ptr(x2d.device))
    build.check(err, "amax_rows")
    amax_launches += 1
    return out


def amax_rows(x2d: torch.Tensor, backend: Optional[str] = None) -> torch.Tensor:
    """max|x| of every row of a (rows, n) float32 tensor -> (rows,)."""
    global plain_on_cuda
    _check_rows(x2d)
    if resolve_backend(backend, x2d) == "cuda":
        return _amax_rows_cuda(x2d)
    plain_on_cuda += x2d.is_cuda
    return _amax_rows_torch(x2d)


def _uniform_quantize_torch(x2d, scale, k_x):
    return grids.uniform_quantize(x2d, scale[:, None], k_x)


def _uniform_quantize_cuda(x2d, scale, k_x):
    global quantize_launches
    dtype = grids.uniform_code_dtype(k_x)
    if dtype not in (torch.int8, torch.int16):
        raise ValueError(f"k_x={k_x}: the kernel writes int8/int16 codes")
    lib = build.library()
    x2d = x2d.contiguous()
    scale = scale.to(torch.float32).contiguous()
    codes = torch.empty(x2d.shape, dtype=dtype, device=x2d.device)
    err = lib.rt_uniform_quantize_rows(
        build.ptr(x2d), build.ptr(scale), build.ptr(codes), x2d.shape[0],
        x2d.shape[1], k_x, codes.element_size(), build.stream_ptr(x2d.device))
    build.check(err, "uniform_quantize_rows")
    quantize_launches += 1
    return codes


def uniform_quantize_rows(x2d: torch.Tensor, scale: torch.Tensor, k_x: int,
                          backend: Optional[str] = None) -> torch.Tensor:
    """Uniform Q_x codes of a (rows, n) float32 tensor against one scale
    per row ((rows,) float32). int8 for k_x <= 6, int16 above."""
    global plain_on_cuda
    _check_rows(x2d)
    if scale.shape != (x2d.shape[0],):
        raise ValueError(f"scale {tuple(scale.shape)} != ({x2d.shape[0]},)")
    if resolve_backend(backend, x2d, scale) == "cuda":
        return _uniform_quantize_cuda(x2d, scale, k_x)
    plain_on_cuda += x2d.is_cuda
    return _uniform_quantize_torch(x2d, scale, k_x)
