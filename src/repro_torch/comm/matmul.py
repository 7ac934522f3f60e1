"""K1 fused dequant-matmul for code-resident Q_x weights (the serving hot
path; port of ``repro/comm/matmul.py``).

Replaces ``_matmul_pallas``: ``_mm_body``/``_mm_lut_body`` (K1,
``x @ W``) and the transposed branch ``_mm_t_body`` (K1t, ``x @ W.T``
from code rows, the tied logit head). Both kernels live in
``csrc/dequant_matmul.cu`` (design notes there): they read the codes
once per M-tile, dequantize in registers with the reference's exact
cast chain, and accumulate in fp32; they are bound by the bytes of
codes they stream at decode and chunk sizes. They cover every M, K, N
(and every number of code rows) by masking the ragged edges, so the
TPU tiling knobs (``mm_cols``, ``_MAX_FUSED_ROWS``, ``_pallas_covers``)
have no counterpart here.

The plain version ``_matmul_torch`` is dequantize-then-matmul with the
product taken in float32 and rounded once to the output dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import build
from repro_torch.comm import bits as B
from repro_torch.comm.codec import resolve_backend
from repro_torch.opt import grids

launches = 0        # K1 kernel launches
t_launches = 0      # K1t (transposed) kernel launches
plain_on_cuda = 0   # plain versions run on CUDA tensors

_FLOATS = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(name: str) -> torch.dtype:
    if name not in _FLOATS:
        raise ValueError(f"dtype {name!r} not in {sorted(_FLOATS)}")
    return _FLOATS[name]


def dequant_codes(codes, scale, *, k_x, n, pack_bits, w_dtype, cast_dtype):
    """Codes (K, payload|n) -> weights, replicating the unfused cast chain
    ``dequantize() -> .astype(leaf dtype) -> .astype(cast dtype)``."""
    full = B.unpack_rows(codes, pack_bits, n) if pack_bits else codes
    w = grids.uniform_dequantize(full, scale, k_x).to(_dtype(w_dtype))
    if cast_dtype is not None:
        w = w.to(_dtype(cast_dtype))
    return w


def _out_dtype(x_dtype, w_dtype, cast_dtype):
    return torch.promote_types(x_dtype, _dtype(cast_dtype or w_dtype))


def _matmul_torch(x2, codes, scale, *, k_x, n, pack_bits, w_dtype,
                  cast_dtype, transpose=False):
    w = dequant_codes(codes, scale, k_x=k_x, n=n, pack_bits=pack_bits,
                      w_dtype=w_dtype, cast_dtype=cast_dtype).to(torch.float32)
    out = x2.to(torch.float32) @ (w.T if transpose else w)
    return out.to(_out_dtype(x2.dtype, w_dtype, cast_dtype))


def _matmul_cuda(x2, codes, scale, *, k_x, n, pack_bits, w_dtype,
                 cast_dtype, transpose=False):
    """K1 (``x @ W``, codes (K, n)) or, with ``transpose``, K1t
    (``x @ W.T``, codes (rows, n) contracted along n)."""
    global launches, t_launches
    M, K = x2.shape
    rows = codes.shape[0]
    if transpose and K != n:
        raise ValueError(f"x width {K} != code row width {n}")
    if transpose and M > 4 * 65535:
        raise ValueError(f"{M} activation rows > {4 * 65535} (grid rows)")
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"activation dtype {x2.dtype} not float32/bfloat16")
    if pack_bits:
        if pack_bits not in (2, 3, 4, 6) or codes.dtype != torch.uint8:
            raise ValueError(f"packed codes need uint8 2/3/4/6-bit lanes, "
                             f"got {codes.dtype} at {pack_bits} bits")
        code_bits, width = pack_bits, B.payload_nbytes(n, pack_bits)
    elif codes.dtype == torch.int8:
        code_bits, width = 8, n
    elif codes.dtype == torch.int16:
        code_bits, width = 16, n
    else:
        raise ValueError(f"codes dtype {codes.dtype} not int8/int16/uint8")
    if codes.dim() != 2 or codes.shape[1] != width or (
            not transpose and rows != K):
        raise ValueError(f"codes {tuple(codes.shape)} != "
                         f"({'rows' if transpose else K}, {width})")
    if k_x > 14:
        raise ValueError(f"k_x={k_x} > 14")
    out_dtype = _out_dtype(x2.dtype, w_dtype, cast_dtype)
    if x2.dtype == torch.float32 and out_dtype != torch.float32:
        raise ValueError("float32 activations give float32 outputs")
    lib = build.library()
    x2 = x2.contiguous()
    codes = codes.contiguous()
    scale = scale.to(torch.float32).reshape(()).contiguous()
    flags = (code_bits, k_x, int(x2.dtype == torch.bfloat16),
             int(_dtype(w_dtype) == torch.bfloat16),
             int(cast_dtype is not None
                 and _dtype(cast_dtype) == torch.bfloat16),
             int(out_dtype == torch.bfloat16), build.stream_ptr(x2.device))
    if transpose:
        out = torch.empty((M, rows), dtype=out_dtype, device=x2.device)
        err = lib.rt_dequant_matmul_t(
            build.ptr(x2), build.ptr(codes), build.ptr(scale),
            build.ptr(out), M, n, rows, *flags)
        build.check(err, "dequant_matmul_t")
        t_launches += 1
        return out
    out = torch.empty((M, n), dtype=out_dtype, device=x2.device)
    err = lib.rt_dequant_matmul(
        build.ptr(x2), build.ptr(codes), build.ptr(scale), build.ptr(out),
        M, K, n, *flags)
    build.check(err, "dequant_matmul")
    launches += 1
    return out


def dequant_matmul(x, codes, scale, *, k_x: int, n: int, pack_bits: int = 0,
                   w_dtype: str = "float32", cast_dtype: Optional[str] = None,
                   transpose: bool = False,
                   backend: Optional[str] = None) -> torch.Tensor:
    """``x @ W`` (or ``x @ W.T``) where W exists only as integer codes.

    x: (..., K) activations ((..., n) against code rows for
    ``transpose``). codes: (K, n) int8/int16 codes, or packed uint8 rows
    (K, payload_nbytes(n, pack_bits)); for ``transpose`` (rows, n) or
    (rows, payload), contracted along their unpacked width n, giving
    (..., rows). scale: the per-tensor f32 scale (a 0-d tensor; a
    stacked leaf's caller passes one layer's). n: the logical width of a
    code row. w_dtype / cast_dtype: the leaf's dtype and the pending
    ``astype`` target, replicated in that order.
    """
    global plain_on_cuda
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    kw = dict(k_x=k_x, n=n, pack_bits=pack_bits, w_dtype=w_dtype,
              cast_dtype=cast_dtype, transpose=transpose)
    if resolve_backend(backend, x2, codes) == "cuda":
        out2 = _matmul_cuda(x2, codes, scale, **kw)
    else:
        plain_on_cuda += x2.is_cuda
        out2 = _matmul_torch(x2, codes, scale, **kw)
    return out2.reshape(lead + (out2.shape[-1],))
