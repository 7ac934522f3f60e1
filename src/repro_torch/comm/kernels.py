"""K3 per-row amax, K4 per-row uniform quantize, K12 per-row uniform
dequantize and K11 log-grid dequantize: the Q_x passes behind
``quantize_params`` and the training forward copy, and the Q_g decode of
the update.

Replace ``repro/comm/kernels.py`` ``amax_pallas``,
``uniform_quantize_pallas``, ``uniform_dequantize_pallas`` and
``log_dequantize_pallas``. The kernels live in ``csrc/quantize.cu`` and
``csrc/dequantize.cu`` (design notes there): all are bound by bytes. One
launch covers every row of a ``(rows, n)`` view, so a stacked
``(L, ...)`` leaf gets its L per-layer scales (the reference's vmap over
layers) in one launch, and a whole leaf its one scale with rows = 1.

Beside each kernel: its plain PyTorch version, which a wrapper runs only
for CPU tensors or when asked with ``backend="torch"``, and plain-int
launch counters.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import build
from repro_torch.comm import bits as B
from repro_torch.comm.codec import resolve_backend
from repro_torch.opt import grids

amax_launches = 0          # K3 kernel launches
quantize_launches = 0      # K4 kernel launches
dequantize_launches = 0    # K12 kernel launches
log_dequantize_launches = 0  # K11 kernel launches
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


def _uniform_dequantize_cuda(codes2d, scale, k_x):
    global dequantize_launches
    if codes2d.dtype not in (torch.int8, torch.int16):
        raise ValueError(f"the kernel reads int8/int16 codes, got "
                         f"{codes2d.dtype}")
    lib = build.library()
    codes2d = codes2d.contiguous()
    scale = scale.to(torch.float32).contiguous()
    out = torch.empty(codes2d.shape, dtype=torch.float32,
                      device=codes2d.device)
    err = lib.rt_uniform_dequantize_rows(
        build.ptr(codes2d), build.ptr(scale), build.ptr(out),
        codes2d.shape[0], codes2d.shape[1], k_x, codes2d.element_size(),
        build.stream_ptr(codes2d.device))
    build.check(err, "uniform_dequantize_rows")
    dequantize_launches += 1
    return out


def uniform_dequantize_rows(codes2d: torch.Tensor, scale: torch.Tensor,
                            k_x: int, backend: Optional[str] = None
                            ) -> torch.Tensor:
    """``codes / 2^k_x * scale`` in float32 for a (rows, n) code tensor
    and one scale per row ((rows,) float32)."""
    global plain_on_cuda
    if codes2d.dim() != 2 or not 1 <= codes2d.shape[0] <= 65535:
        raise ValueError(f"need (rows, n) codes with 1 <= rows <= 65535, "
                         f"got {tuple(codes2d.shape)}")
    if scale.shape != (codes2d.shape[0],):
        raise ValueError(f"scale {tuple(scale.shape)} != "
                         f"({codes2d.shape[0]},)")
    if resolve_backend(backend, codes2d, scale) == "cuda":
        return _uniform_dequantize_cuda(codes2d, scale, k_x)
    plain_on_cuda += codes2d.is_cuda
    return grids.uniform_dequantize(codes2d, scale[:, None], k_x)


_log_tables = {}   # (k_g, device) -> the lane table on that device


def _log_table(k_g: int, device) -> torch.Tensor:
    key = (k_g, str(device))
    if key not in _log_tables:
        bits = B.lane_bits_for(k_g + 1)
        _log_tables[key] = torch.from_numpy(
            grids.log_dequant_table(k_g, bits)).to(device)
    return _log_tables[key]


def _log_dequantize_cuda(codes, scale, k_g):
    global log_dequantize_launches
    lib = build.library()
    codes = codes.contiguous()
    scale = scale.reshape(1).contiguous()
    table = _log_table(k_g, codes.device)
    out = torch.empty(codes.shape, dtype=torch.float32, device=codes.device)
    err = lib.rt_log_dequantize(build.ptr(codes), build.ptr(scale),
                                build.ptr(table), table.shape[0] // 2,
                                build.ptr(out), codes.numel(),
                                build.stream_ptr(codes.device))
    build.check(err, "log_dequantize")
    log_dequantize_launches += 1
    return out


def log_dequantize(codes: torch.Tensor, scale: torch.Tensor, k_g: int,
                   backend: Optional[str] = None) -> torch.Tensor:
    """Q_g decode: int8 log-grid codes of any shape and one float32
    scale -> ``sign(c) * 2^(|c|-k_g-1) * scale`` in float32."""
    global plain_on_cuda
    if codes.dtype != torch.int8:
        raise ValueError(f"need int8 codes, got {codes.dtype}")
    if scale.numel() != 1 or scale.dtype != torch.float32:
        raise ValueError("scale must be one float32 value")
    if not 0 <= k_g <= 30:
        raise ValueError(f"k_g={k_g} outside [0, 30]")
    if resolve_backend(backend, codes, scale) == "cuda":
        return _log_dequantize_cuda(codes, scale, k_g)
    plain_on_cuda += codes.is_cuda
    return grids.log_dequantize(codes, scale.reshape(()), k_g)
