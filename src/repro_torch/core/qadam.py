"""Quantized Generic Adam with Error Feedback, Algorithm 1, and the
baselines the paper compares it with (port of ``repro/core/qadam.py``).

    opt = qadam(QAdamConfig(alpha=1e-3, grad_q="log:6",
                            weight_q="uniform_amax:7"))
    state = opt.init(params)
    qparams = opt.forward_params(params, state)   # Q_x(x_t): fwd/bwd on these
    updates, state = opt.update(grads, state)     # quantized delta, EF applied
    params = apply_updates(params, updates)

theta_t = 1 - theta/t, alpha_t per ``schedule`` ("constant", "sqrt":
alpha/sqrt(t), "halving:K": halve every K steps), beta constant. Both
come from the host's step count in float32, as the reference computes
them, so no step reads the device.

On CUDA tensors ``update`` launches per leaf K15 (moments), K16 (codes
and residual) and K11 (decode), and ``forward_params`` K3, K4 and K12
(the Q_x round trip) per quantized leaf. Other gradient quantizers run
their own kernels: TernGrad K3 and #13, blockwise sign #14. ``update``
consumes its state: m, v and e are updated in place and the returned
state holds the same tensors (the reference donates these buffers to its
step; a full-width model's state would not fit twice on one card).

The baselines: ``ef_sgdm`` (blockwise-compressed momentum SGD with error
feedback, Zheng et al. '19), ``terngrad_sgd`` (Wen et al. '17) and
``wquan`` (the weights quantized once, after training).

The state holds the reference's PRNG key (``key``, a (2,) int32 tensor on
the device, ``core.threefry``), initialised to ``PRNGKey(seed)``. Every
update does the reference's ``key, sub = split(key)``, the key written
over in place (one launch on the card, ``core.uniforms.advance_keys``),
and a stochastic quantizer (TernGrad) draws leaf l's uniforms under
``split(sub, L)[l]``, l the leaf's index in the reference's sorted leaf
order: the reference's draws, bitwise. Nothing of it reads the host, so
a CUDA graph of K steps replays with each step's own draws.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import threefry, uniforms
from repro_torch.core.quantizers import (IdentityQuantizer, LogGradQuantizer,
                                         Quantizer, get_quantizer)
from repro_torch.opt import engine
from repro_torch.tree import sorted_leaf_index, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class QAdamConfig:
    alpha: float = 1e-3
    beta: float = 0.99
    theta: float = 0.999
    eps: float = 1e-5
    schedule: str = "constant"     # "sqrt" | "constant" | "halving:K"
    grad_q: Optional[str] = "log:6"
    weight_q: Optional[str] = None
    error_feedback: bool = True    # ablation knob (paper: EF on)
    # leaves smaller than this skip Q_x (norm scales would be clipped by
    # the absolute grid; the paper quantizes weight matrices). 0 =
    # quantize everything.
    weight_q_min_numel: int = 0
    # kernels' implementation in update and forward_params: "cuda" |
    # "torch" (the plain versions) | None = by the tensors' device
    backend: Optional[str] = None

    def grad_quantizer(self) -> Quantizer:
        return get_quantizer(self.grad_q)

    def weight_quantizer(self) -> Quantizer:
        return get_quantizer(self.weight_q)


class QAdamState(NamedTuple):
    count: int    # t, steps taken (the next step uses t + 1), on the host
    m: Any        # first moment, per param
    v: Any        # second moment, per param
    e: Any        # error-feedback residual, per param
    key: torch.Tensor   # the stochastic quantizers' PRNG key: (2,) int32
    #                     on the device, the reference's two uint32 words


class Optimizer(NamedTuple):
    init: Callable
    update: Callable
    forward_params: Callable
    # hp_row(t) -> (alpha_t, beta, theta_t, eps) of step t: what
    # ``update(grads, state, params, hp=None)`` turns into its (4,) device
    # row when no ``hp`` is given; a K-step dispatch fills a static table
    # from it and passes the rows (train.session)
    hp_row: Optional[Callable] = None


def _alpha_t(cfg: QAdamConfig, t: int) -> np.float32:
    tf = np.float32(t)
    if cfg.schedule == "sqrt":
        return np.float32(cfg.alpha) / np.sqrt(tf)
    if cfg.schedule == "constant":
        return np.float32(cfg.alpha)
    if cfg.schedule.startswith("halving"):
        k = np.float32(int(cfg.schedule.split(":")[1]))
        return np.float32(cfg.alpha) * np.float32(0.5) ** np.floor(
            (tf - np.float32(1.0)) / k)
    raise ValueError(cfg.schedule)


def _theta_t(cfg: QAdamConfig, t: int) -> np.float32:
    # theta_t = 1 - theta/t (Assumption 4); with theta < 1 it stays in (0, 1)
    return np.float32(1.0) - np.float32(cfg.theta) / np.float32(t)


def _zeros_like_tree(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def _state_init(seed: int):
    def init(params) -> QAdamState:
        dev = tree_leaves(params)[0].device
        return QAdamState(count=0, m=_zeros_like_tree(params),
                          v=_zeros_like_tree(params),
                          e=_zeros_like_tree(params),
                          key=threefry.prng_key(seed, dev))
    return init


def _leaf_draws(grads, state: QAdamState, stochastic: bool, backend):
    """The step's key split, the state key advanced in place now; an
    iterator over the leaves in ``tree_map`` order of functions
    ``draw(n)``: the leaf's uniforms under its subkey, keyed by its index
    in the reference's (sorted) leaf order (no table where nothing is
    drawn)."""
    order = sorted_leaf_index(grads)
    keys = uniforms.advance_keys(state.key, len(order) if stochastic else 0,
                                 backend=backend)
    return iter([lambda n, i=i: uniforms.draw(keys, i, n, backend=backend)
                 for i in order])


def _quantize(gq: Quantizer, x: torch.Tensor, draw, backend):
    """gq(x), a stochastic operator's uniforms from ``draw``."""
    u = draw(x.numel()).reshape(x.shape) if gq.codec.stochastic else None
    return gq(x, backend, u=u)


def qadam(cfg: QAdamConfig, seed: int = 0) -> Optimizer:
    """Algorithm 1: Quantized Generic Adam (single worker). ``seed`` keys
    the draws of a stochastic gradient quantizer (``grad_q="terngrad"``)."""
    gq = cfg.grad_quantizer()
    wq = cfg.weight_quantizer()

    def hp_row(t):
        return _alpha_t(cfg, t), cfg.beta, _theta_t(cfg, t), cfg.eps

    def forward_params(params, state=None):
        """Q_x(x_t), per tensor (one amax over a whole stacked leaf): the
        weights the gradient is sampled at (Assumption 3)."""
        if isinstance(wq, IdentityQuantizer):
            return params

        def leaf(p):
            if p.numel() < cfg.weight_q_min_numel:
                return p
            return wq(p, backend=cfg.backend).to(p.dtype)
        return tree_map(leaf, params)

    def update(grads, state: QAdamState, params=None, hp=None):
        t = state.count + 1
        if hp is None:
            hp = engine.hyperparams(*hp_row(t), tree_leaves(grads)[0].device)
        bk = cfg.backend
        draws = _leaf_draws(grads, state, gq.codec.stochastic, bk)

        def leaf(g, m, v, e):
            draw = next(draws)
            g = g.to(torch.float32)
            if isinstance(gq, LogGradQuantizer):
                # the paper's Q_g: K15, K16 (state in place), then K11
                return engine.adam_ef_update(
                    g, m, v, e, hp, k_g=gq.k_g,
                    error_feedback=cfg.error_feedback, backend=bk)[0]
            _, _, de = engine.adam_ef_moments(g, m, v, e, hp, backend=bk,
                                              out=(m, v))
            dq = _quantize(gq, de, draw, bk)
            if cfg.error_feedback:
                torch.sub(de, dq, out=e)
            else:
                e.zero_()
            return -dq

        upd = tree_map(leaf, grads, state.m, state.v, state.e)
        return upd, state._replace(count=t)

    return Optimizer(init=_state_init(seed), update=update,
                     forward_params=forward_params, hp_row=hp_row)


def _unquantized(params, state=None):
    return params


def ef_sgdm(alpha: float = 0.1, beta: float = 0.9,
            grad_q: str = "blockwise:256", schedule: str = "constant",
            seed: int = 0, backend: Optional[str] = None) -> Optimizer:
    """Zheng et al. '19 baseline: blockwise-compressed momentum SGD with
    error feedback. Per leaf, m and e in place: m' = beta * m + g,
    Delta + e = alpha_t * m' + e, the update -Q(Delta + e) (#14 for the
    blockwise operator), e' = Delta + e - Q(Delta + e); each operation
    rounded once. v is kept, unused, as in the reference's state.
    ``backend`` picks the quantizer's kernels or plain versions."""
    gq = get_quantizer(grad_q)
    cfg = QAdamConfig(alpha=alpha, beta=beta, schedule=schedule)

    def hp_row(t):
        return _alpha_t(cfg, t), beta, 0.0, 0.0

    def update(grads, state: QAdamState, params=None, hp=None):
        t = state.count + 1
        if hp is None:
            hp = engine.hyperparams(*hp_row(t), tree_leaves(grads)[0].device)
        a_t = hp[0]
        draws = _leaf_draws(grads, state, gq.codec.stochastic, backend)

        def leaf(g, m, e):
            draw = next(draws)
            m.mul_(beta).add_(g.to(torch.float32))
            de = torch.mul(m, a_t).add_(e)
            dq = _quantize(gq, de, draw, backend)
            torch.sub(de, dq, out=e)
            return dq.neg_()

        upd = tree_map(leaf, grads, state.m, state.e)
        return upd, state._replace(count=t)

    return Optimizer(init=_state_init(seed), update=update,
                     forward_params=_unquantized, hp_row=hp_row)


def terngrad_sgd(alpha: float = 0.1, schedule: str = "constant",
                 seed: int = 0, backend: Optional[str] = None) -> Optimizer:
    """TernGrad baseline (Wen et al. '17): unbiased ternary SGD, no error
    feedback. The update is -alpha_t * Q(g), Q's codes from K3's amax
    scale and #13 on this step's uniforms."""
    gq = get_quantizer("terngrad")
    cfg = QAdamConfig(alpha=alpha, schedule=schedule)

    def hp_row(t):
        return _alpha_t(cfg, t), 0.0, 0.0, 0.0

    def update(grads, state: QAdamState, params=None, hp=None):
        t = state.count + 1
        if hp is None:
            hp = engine.hyperparams(*hp_row(t), tree_leaves(grads)[0].device)
        a_t = hp[0]
        draws = _leaf_draws(grads, state, True, backend)

        def leaf(g):
            # -(Q(g) a_t) is Q(g) (-a_t) bit for bit
            return _quantize(gq, g.to(torch.float32), next(draws),
                             backend).mul_(a_t).neg_()

        return tree_map(leaf, grads), state._replace(count=t)

    return Optimizer(init=_state_init(seed), update=update,
                     forward_params=_unquantized, hp_row=hp_row)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.to(torch.float32) + u).to(p.dtype),
                    params, updates)


def apply_updates_(params, updates):
    """:func:`apply_updates` in place: each leaf's p + u, rounded once to
    its dtype, written over p (bitwise the same values; a float32 leaf
    takes ``p.add_(u)``). Returns ``params``, whose tensors keep their
    addresses (what a CUDA graph of the step needs)."""
    def leaf(p, u):
        if p.dtype == torch.float32:
            return p.add_(u)
        return p.copy_((p.to(torch.float32) + u).to(p.dtype))
    return tree_map(leaf, params, updates)


def wquan(params, k_x: int = 7, absolute: bool = True,
          backend: Optional[str] = None):
    """WQuan baseline: every weight quantized once, after training, on the
    uniform grid (absolute, or against the leaf's amax: K3), and back
    (K4, K12)."""
    wq = get_quantizer(f"uniform:{k_x}" if absolute else f"uniform_amax:{k_x}")
    return tree_map(lambda p: wq(p, backend=backend).to(p.dtype), params)
