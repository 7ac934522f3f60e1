"""Backend-dispatched Q_x encode (port of ``repro/opt/engine.py``
``quantize_uniform``).

``backend="torch"`` runs the plain ``grids`` math, ``"cuda"`` the K3/K4
kernels of ``repro_torch.comm.kernels``; ``None`` follows the tensor's
device. Codes and scales are bitwise equal across backends.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.comm import kernels as K


def quantize_uniform(x: torch.Tensor, k_x: int = 7, absolute: bool = True,
                     backend: Optional[str] = None, per_layer: bool = False):
    """Paper's Q_x encode -> (codes, scale). Codes are int8 for k_x <= 6,
    int16 above (codes reach +/- 2^k_x).

    ``absolute`` pins the scale to 0.5; otherwise it is
    ``max(amax, 1e-30)``. ``per_layer`` treats dim 0 as a stack of layers
    and gives each its own scale, shape (L,) (the reference vmaps over
    that dim); otherwise one scale, shape ().
    """
    x32 = x.to(torch.float32)
    rows = x.shape[0] if per_layer else 1
    x2d = x32.reshape(rows, -1)
    if absolute:
        scale = torch.full((rows,), 0.5, dtype=torch.float32, device=x.device)
    else:
        scale = torch.clamp_min(K.amax_rows(x2d, backend=backend), 1e-30)
    codes = K.uniform_quantize_rows(x2d, scale, k_x, backend=backend)
    return codes.reshape(x.shape), (scale if per_layer else scale[0])
