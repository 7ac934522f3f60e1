"""The quantizer passes and the Adam+EF step under the reference's names
(port of ``repro/kernels/ops.py``, a shim over ``repro_torch.opt.engine``).
``backend=`` ("cuda", "torch" or None by the tensors' device) takes the
place of the reference's ``use_pallas``."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.opt import engine


def quantize_log(x: torch.Tensor, k_g: int = 6,
                 backend: Optional[str] = None):
    return engine.quantize_log(x, k_g, backend=backend)


def dequantize_log(codes: torch.Tensor, scale: torch.Tensor, k_g: int = 6,
                   backend: Optional[str] = None):
    return engine.dequantize_log(codes, scale, k_g, backend=backend)


def quantize_uniform(x: torch.Tensor, k_x: int = 7, absolute: bool = True,
                     backend: Optional[str] = None):
    return engine.quantize_uniform(x, k_x, absolute=absolute,
                                   backend=backend)


def dequantize_uniform(codes: torch.Tensor, scale: torch.Tensor,
                       k_x: int = 7, backend: Optional[str] = None):
    return engine.dequantize_uniform(codes, scale, k_x, backend=backend)


def adam_ef_step(g, m, v, e, alpha_t, beta, theta_t, eps, k_g: int = 6,
                 backend: Optional[str] = None):
    """The worker's inner loop of Algorithm 3 (K15, K16): returns (m', v',
    codes, scale, e'), m, v and e updated in place
    (``engine.adam_ef_step``)."""
    hp = engine.hyperparams(alpha_t, beta, theta_t, eps, g.device)
    return engine.adam_ef_step(g, m, v, e, hp, k_g=k_g, backend=backend)
