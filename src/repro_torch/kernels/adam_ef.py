"""K15 Adam+EF moments and K16 EF quantize: the two passes of the
paper's leaf update (Algorithm 1 lines 3-6).

Replace ``repro/kernels/adam_ef.py`` ``adam_moments_pallas`` and
``ef_quantize_pallas``. The kernels live in ``csrc/adam_ef.cu`` (design
notes there). Both are bound by bytes: K15 moves 28 bytes per element
(reads g, m, v, e; writes m', v', Delta+e) and folds max|Delta+e| into
one device word; K16 moves 9 (reads Delta+e; writes int8 codes and the
new residual). They take flat tensors of any length: the reference's
(R, 128) tiling and padding has no counterpart here.

Beside each kernel: its plain PyTorch version (``repro_torch.opt.grids``
``adam_ef_moments`` / ``adam_ef_quantize``), which a wrapper runs only
for CPU tensors or when asked with ``backend="torch"``, and plain-int
launch counters. The kernel and its plain version are bitwise equal.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import build
from repro_torch.comm.codec import resolve_backend
from repro_torch.opt import grids

moments_launches = 0       # K15 kernel launches
ef_quantize_launches = 0   # K16 kernel launches
plain_on_cuda = 0          # plain versions run on CUDA tensors


def _check_f32(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype != torch.float32 or t.shape != ts[0].shape:
            raise ValueError(f"need float32 tensors of one shape, got "
                             f"{tuple(t.shape)} {t.dtype}")


def _moments_cuda(g, m, v, e, hp, out):
    global moments_launches
    lib = build.library()
    g, m, v, e = (t.contiguous() for t in (g, m, v, e))
    hp = hp.contiguous()
    m_new, v_new = out if out is not None else (torch.empty_like(g),
                                                torch.empty_like(g))
    de = torch.empty_like(g)
    amax = torch.zeros((), dtype=torch.int32, device=g.device)
    err = lib.rt_adam_moments(
        build.ptr(g), build.ptr(m), build.ptr(v), build.ptr(e), build.ptr(hp),
        build.ptr(m_new), build.ptr(v_new), build.ptr(de), build.ptr(amax),
        g.numel(), build.stream_ptr(g.device))
    build.check(err, "adam_moments")
    moments_launches += 1
    return m_new, v_new, de, amax.view(torch.float32)


def _check_out(out, like: torch.Tensor, n: int):
    if out is not None:
        if len(out) != n:
            raise ValueError(f"out must hold {n} tensors")
        _check_f32(like, *out)
        if not all(t.is_contiguous() for t in out):
            raise ValueError("out tensors must be contiguous")


def adam_moments(g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                 e: torch.Tensor, hp: torch.Tensor,
                 backend: Optional[str] = None, out=None):
    """One pass over (g, m, v, e), float32 of one shape: returns (m', v',
    Delta+e, max|Delta+e| as a 0-d float32 tensor). ``hp`` is the (4,)
    float32 tensor [alpha_t, beta, theta_t, eps] on the same device.
    ``out=(m_out, v_out)`` receives m' and v' (they may be m and v, to
    update in place); otherwise they are new tensors."""
    global plain_on_cuda
    _check_f32(g, m, v, e)
    _check_out(out, g, 2)
    if hp.shape != (4,) or hp.dtype != torch.float32:
        raise ValueError(f"hp must be (4,) float32, got {tuple(hp.shape)} "
                         f"{hp.dtype}")
    if resolve_backend(backend, g, m, v, e, hp) == "cuda":
        return _moments_cuda(g, m, v, e, hp, out)
    plain_on_cuda += g.is_cuda
    m_new, v_new, de = grids.adam_ef_moments(g, m, v, e, hp)
    if out is not None:
        m_new, v_new = out[0].copy_(m_new), out[1].copy_(v_new)
    return m_new, v_new, de, grids.block_amax(de)


def _ef_quantize_cuda(de, scale, k_g, out):
    global ef_quantize_launches
    lib = build.library()
    de = de.contiguous()
    scale = scale.reshape(1).contiguous()
    codes = torch.empty(de.shape, dtype=torch.int8, device=de.device)
    e_new = out if out is not None else torch.empty_like(de)
    table = grids.log_table_on(k_g, de.device)
    err = lib.rt_ef_quantize(build.ptr(de), build.ptr(scale),
                             build.ptr(grids.log_grid_on(de.device)),
                             build.ptr(table), table.shape[0] // 2,
                             build.ptr(codes), build.ptr(e_new), de.numel(),
                             k_g, build.stream_ptr(de.device))
    build.check(err, "ef_quantize")
    ef_quantize_launches += 1
    return codes, e_new


def ef_quantize(de: torch.Tensor, scale: torch.Tensor, k_g: int,
                backend: Optional[str] = None, out=None):
    """Log-grid int8 codes of Delta+e against ``scale`` (a 0-d float32
    tensor on the same device) and the new EF residual
    e' = Delta+e - log_dequantize(codes, scale), written into ``out``
    when given (the old residual's buffer, to update in place)."""
    global plain_on_cuda
    _check_f32(de)
    _check_out(None if out is None else (out,), de, 1)
    if scale.numel() != 1 or scale.dtype != torch.float32:
        raise ValueError("scale must be one float32 value")
    if not 0 <= k_g <= grids.MAX_LOG_K:
        raise ValueError(f"k_g={k_g} outside [0, {grids.MAX_LOG_K}]")
    if resolve_backend(backend, de, scale) == "cuda":
        return _ef_quantize_cuda(de, scale, k_g, out)
    plain_on_cuda += de.is_cuda
    codes, e_new = grids.adam_ef_quantize(de, scale.reshape(()), k_g)
    return codes, (e_new if out is None else out.copy_(e_new))
