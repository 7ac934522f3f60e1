"""#17 flash attention, forward (port of ``repro/kernels/flash_attention.py``).

Replaces ``flash_attention`` (``_flash_fwd_kernel``): online-softmax
attention of q (B, Sq, H, hd) against k, v (B, Skv, K, hd), GQA (query
head h reads KV head h // (H // K)), causal, a sliding window, a logit
softcap and a query position offset, out (B, Sq, H, hd) in q's dtype.
The kernels live in ``csrc/flash_attention.cu`` (design notes there);
both run on the tensor cores and visit only the K/V tiles some query of
a block can see. Two routes, picked by dtype (:func:`route`), each with
its own launch counter:

- ``"tc"``, bfloat16 (``launches_tc``): wgmma, two warpgroups over one
  stream of K/V tiles, P fed to the MMA as two bf16 terms so the bf16
  tier holds.
- ``"tc32"``, float32 (``launches_tc32``): mma.sync in 3xTF32 (each
  operand split into two TF32 terms, three products), which holds
  rtol 1e-4 where one TF32 pass would not.

``launches`` counts both; neither route falls back to the other. They
take hd in {32, 64, 128, 256} and any Sq, Skv; the TPU kernel's
``Sq % 128 == Skv % 128 == 0`` has no counterpart here.

As in the JAX package, no model calls it: the models' attention is
``repro_torch.models.layers``. It is an entry point of its own.

The plain version ``_flash_torch`` spells the TPU kernel's definition
in one pass: q * (1/sqrt(hd)) in float32, then q k^T, then the softcap,
masked scores set to -1e30, p = exp(s - rowmax) with masked p = 0,
``(p @ v) / max(sum p, 1e-30)``, rounded once to q's dtype. For a query
that sees some key this is what the TPU kernel's online softmax gives
(its masked p are exp(-1e30 - m) = 0); a query that sees no key gets
zeros (the TPU kernel gives the mean of the tiles it streamed).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import build
from repro_torch.comm.codec import resolve_backend

launches = 0        # #17 launches, either route
launches_tc = 0     # #17 on tensor cores in bfloat16 (route "tc")
launches_tc32 = 0   # #17 on tensor cores in float32, 3xTF32 (route "tc32")
plain_on_cuda = 0   # plain versions run on CUDA tensors

HEAD_DIMS = (32, 64, 128, 256)
NEG_INF = -1e30


def _visible(Sq, Skv, *, causal, window, q_offset, device):
    """(Sq, Skv) mask of the keys each query sees."""
    qp = q_offset + torch.arange(Sq, device=device)[:, None]
    kp = torch.arange(Skv, device=device)[None, :]
    vis = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        vis = vis & (qp >= kp)
    if window:
        vis = vis & (kp > qp - window)
    return vis


def _flash_torch(q, k, v, *, causal, window, softcap, q_offset):
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    qs = q.to(torch.float32) * (1.0 / math.sqrt(hd))   # scale rounded to f32
    qr = qs.reshape(B, Sq, K, H // K, hd)
    s = torch.einsum("bqkrd,bskd->bkrqs", qr, k.to(torch.float32))
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    vis = _visible(Sq, Skv, causal=causal, window=window, q_offset=q_offset,
                   device=q.device)
    s = torch.where(vis, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(vis, torch.exp(s - m), 0.0)
    den = torch.sum(p, dim=-1)                              # (B,K,rep,Sq)
    o = torch.einsum("bkrqs,bskd->bqkrd", p, v.to(torch.float32))
    out = o / torch.clamp_min(torch.movedim(den, -1, 1)[..., None], 1e-30)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    return t if t.data_ptr() % 16 == 0 else t.clone()


def route(dtype: torch.dtype) -> str:
    """Which kernel computes #17 on CUDA tensors: ``"tc"`` (bf16 MMAs) for
    bfloat16 inputs, ``"tc32"`` (3xTF32 MMAs) for float32, whose rtol
    1e-4 neither bf16 operands nor one TF32 pass can hold."""
    if dtype == torch.bfloat16:
        return "tc"
    if dtype == torch.float32:
        return "tc32"
    raise ValueError(f"dtype {dtype}: need float32 or bfloat16")


def _flash_cuda(q, k, v, *, causal, window, softcap, q_offset):
    global launches, launches_tc, launches_tc32
    B, Sq, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if B * H > 65535:
        raise ValueError(f"B * H = {B * H} > 65535")
    which = route(q.dtype)
    # the kernels copy 16-byte row chunks: an unaligned view is copied
    q, k, v = (_aligned(t.contiguous()) for t in (q, k, v))
    out = torch.empty_like(q)
    fn = build.library().rt_flash_attention_tc if which == "tc" else \
        build.library().rt_flash_attention_tc32
    err = fn(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out), B, Sq,
             Skv, H, K, hd, int(causal), int(window), int(q_offset),
             float(softcap or 0.0), 1.0 / math.sqrt(hd),
             build.stream_ptr(q.device))
    build.check(err, f"flash_attention ({which})")
    launches += 1
    if which == "tc":
        launches_tc += 1
    else:
        launches_tc32 += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: Optional[float] = None, q_offset: int = 0,
                    backend: Optional[str] = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Skv, K, hd) with H % K == 0, all of
    one dtype (float32 or bfloat16). Query i sits at position
    ``q_offset + i``, key j at j; ``window`` 0 is global attention,
    otherwise a query at p sees keys at ``> p - window``. Returns
    (B, Sq, H, hd) in q's dtype."""
    global plain_on_cuda
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: need (B, S, heads, hd)")
    B, Sq, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"k/v {tuple(k.shape)} do not serve q "
                         f"{tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise ValueError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: need "
                         f"one of float32, bfloat16")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap {softcap} must be positive")
    kw = dict(causal=causal, window=int(window), softcap=softcap,
              q_offset=int(q_offset))
    if resolve_backend(backend, q, k, v) == "cuda":
        return _flash_cuda(q, k, v, **kw)
    plain_on_cuda += q.is_cuda
    return _flash_torch(q, k, v, **kw)
