"""Backend-dispatched quantizer passes and the Adam+EF update core (port
of ``repro/opt/engine.py``).

``backend="torch"`` runs the plain ``grids`` math, ``"cuda"`` the
hand-written kernels (K3/K4 Q_x encode, K12 Q_x decode, K3/#10 Q_g
encode, K11 Q_g decode, K3/#13 TernGrad codes, #14 blockwise quantize in
``repro_torch.comm.kernels``; K15/K16 Adam+EF in
``repro_torch.kernels.adam_ef``); ``None`` follows the tensors' device.
Codes, scales, moments and residuals are bitwise equal across backends.
The kernels take flat tensors of any length, so the reference's
(R, 128) tiling and padding (``_to_tiles``) has no counterpart.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.comm import kernels as K
from repro_torch.kernels import adam_ef as AK


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


def dequantize_uniform(codes: torch.Tensor, scale: torch.Tensor,
                       k_x: int = 7, backend: Optional[str] = None):
    """Q_x decode of a whole tensor against one scale: ``codes / 2^k_x *
    scale`` in float32 (K12)."""
    out = K.uniform_dequantize_rows(codes.reshape(1, -1),
                                    scale.reshape(1).to(torch.float32), k_x,
                                    backend=backend)
    return out.reshape(codes.shape)


def quantize_log(x: torch.Tensor, k_g: int = 6,
                 backend: Optional[str] = None):
    """Paper's Q_g encode -> (int8 codes, scale): the per-tensor amax (K3)
    under the reference's ``max(amax, 1e-30)`` floor (not the zero guard
    1 of ``amax_scale``), then the log-grid codes (#10). The scale is a
    0-d float32 tensor on x's device."""
    x32 = x.to(torch.float32)
    amax = K.amax_rows(x32.reshape(1, -1), backend=backend)
    scale = torch.clamp_min(amax[0], 1e-30)
    return K.log_quantize(x32, scale, k_g, backend=backend), scale


def dequantize_log(codes: torch.Tensor, scale: torch.Tensor, k_g: int = 6,
                   backend: Optional[str] = None):
    """Q_g decode (K11): ``sign(c) * 2^(|c|-k_g-1) * scale``, float32."""
    return K.log_dequantize(codes, scale, k_g, backend=backend)


def quantize_ternary(x: torch.Tensor, u: torch.Tensor,
                     backend: Optional[str] = None):
    """Unbiased stochastic ternary codes + amax scale -> (int8 codes,
    scale): the scale ``where(amax > 0, amax, 1)`` (K3's amax), then #13
    on the uniforms ``u`` (x's numel, in [0, 1)), drawn outside the kernel
    as the reference draws them outside its kernel (here by the caller,
    ``core.uniforms``: the reference's threefry draws)."""
    x32 = x.to(torch.float32)
    scale = amax_scale(K.amax_rows(x32.reshape(1, -1), backend=backend)[0])
    return K.ternary_quantize(x32, u, scale, backend=backend), scale


def quantize_blockwise(x: torch.Tensor, block: int = 256,
                       backend: Optional[str] = None):
    """Sign codes + per-block mean |x| scales over flat blocks of
    ``block`` elements (the tail zero-padded), #14. Returns ((nb, block)
    int8, (nb,) float32). The reference's ``BLOCKWISE_ROWS`` padding of
    its tiling never reaches its output and has no counterpart."""
    return K.blockwise_quantize(x.to(torch.float32), block, backend=backend)


# ---------------------------------------------------------------------------
# Adam+EF update core (Algorithm 1 lines 3-6)
# ---------------------------------------------------------------------------

def _host_rows(rows) -> torch.Tensor:
    """Rows of [alpha_t, beta, theta_t, eps], each value rounded once to
    float32 on the host."""
    return torch.from_numpy(np.array(rows, dtype=np.float32))


class HyperparamTable:
    """A static (K, 4) float32 table of [alpha_t, beta, theta_t, eps] rows
    on the device, for K steps in one dispatch, and beside it a (K,)
    int64 table of the steps' counts t: the host fills the rows and
    counts of the next steps before the dispatch (non-blocking copies
    from pinned memory on the current stream, outside any graph), and
    step i of the dispatch is given ``table[i]`` as its ``hp`` and
    ``table.step(i)`` as its device t (what the distributed chain's
    threefry keys fold, ``core.uniforms.step_keys``). A CUDA graph of the
    K steps captures the addresses, never the values, so each replay
    reads the values the host filled for it."""

    def __init__(self, k: int, device):
        self.device = torch.device(device)
        self.table = torch.zeros((k, 4), dtype=torch.float32,
                                 device=self.device)
        self.steps = torch.zeros((k,), dtype=torch.int64, device=self.device)

    def fill(self, rows, steps) -> None:
        """Rows 0 .. len(rows)-1 from the host, the same float32 roundings
        as :func:`hyperparams`, and their steps' counts."""
        hp = _host_rows(rows)
        ts = torch.tensor(steps, dtype=torch.int64)
        if self.device.type == "cuda":
            hp, ts = hp.pin_memory(), ts.pin_memory()
        self.table[:len(rows)].copy_(hp, non_blocking=True)
        self.steps[:len(ts)].copy_(ts, non_blocking=True)

    def __getitem__(self, i: int) -> torch.Tensor:
        return self.table[i]

    def step(self, i: int) -> torch.Tensor:
        """Step i's count t, a (1,) int64 view on the device."""
        return self.steps[i:i + 1]


def hyperparams(alpha_t, beta, theta_t, eps, device) -> torch.Tensor:
    """The (4,) float32 tensor [alpha_t, beta, theta_t, eps] on
    ``device``, each value rounded once to float32 on the host. On a GPU
    the copy is staged through pinned memory and does not wait for the
    device."""
    hp = _host_rows([alpha_t, beta, theta_t, eps])
    device = torch.device(device)
    if device.type == "cuda":
        return hp.pin_memory().to(device, non_blocking=True)
    return hp.to(device)


def amax_scale(amax: torch.Tensor) -> torch.Tensor:
    """The Q_g scale with the reference's zero guard, on the device:
    ``where(amax > 0, amax, 1)`` (a NaN amax also gives 1)."""
    return torch.where(amax > 0, amax, torch.ones_like(amax))


def adam_ef_moments(g, m, v, e, hp, backend: Optional[str] = None,
                    out=None):
    """Pass A (K15): moment updates and the full-precision Delta_t + e_t.
    Returns (m', v', Delta+e); ``out=(m_out, v_out)`` receives m' and v'
    (they may be m and v)."""
    m2, v2, de, _ = AK.adam_moments(g, m, v, e, hp, backend=backend, out=out)
    return m2, v2, de


def adam_ef_delta(g, m, v, e, hp, backend: Optional[str] = None):
    """Pass A (K15) in place, m' and v' written over m and v: returns
    (Delta+e, scale), the scale being K15's folded max|Delta+e| under the
    zero guard, on the device (bitwise ``grids.amax_scale(Delta+e)``; no
    extra amax pass). The distributed updater's first half."""
    _, _, de, amax = AK.adam_moments(g, m, v, e, hp, backend=backend,
                                     out=(m, v))
    return de, amax_scale(amax)


def ef_quantize(de, scale, k_g: int, backend: Optional[str] = None):
    """Pass B (K16): log-grid codes and the new EF residual
    e' = Delta+e - deq(codes)."""
    return AK.ef_quantize(de, scale, k_g, backend=backend)


def adam_ef_step(g, m, v, e, hp, k_g: int = 6,
                 backend: Optional[str] = None):
    """K15 then K16 on one leaf, the state updated in place: K15 writes
    m' and v' over m and v, K16 writes e' over e (which K15 has read).
    Returns (m', v', codes, scale, e'), m', v' and e' being the tensors
    m, v and e. The scale is K15's folded max|Delta+e| under the zero
    guard, on the device. The reference donates these buffers to its
    step, which amounts to the same."""
    de, scale = adam_ef_delta(g, m, v, e, hp, backend=backend)
    codes, _ = AK.ef_quantize(de, scale, k_g, backend=backend, out=e)
    return m, v, codes, scale, e


def adam_ef_update(g, m, v, e, hp, k_g: int, error_feedback: bool = True,
                   backend: Optional[str] = None):
    """The complete single-machine Algorithm 1 leaf update, the state
    updated in place (:func:`adam_ef_step`): returns (update, m', v', e').
    The update is -Q_g(Delta_t + e_t), the reference's ``-delta_deq``: K11
    (a separate launch after K16, as in the reference) decodes the codes
    against -scale, which gives -deq bit for bit (the rounding is
    symmetric). ``error_feedback=False`` zeroes e'."""
    m, v, codes, scale, e = adam_ef_step(g, m, v, e, hp, k_g=k_g,
                                         backend=backend)
    upd = dequantize_log(codes, -scale, k_g, backend=backend)
    if not error_feedback:
        e.zero_()
    return upd, m, v, e
