"""Building-block layers, dense decoder subset (port of
``repro/models/layers.py``, local path).

Each function repeats the reference's float32 arithmetic in the same
order (norm statistics, rope angles, the ``cap * tanh(s / cap)``
softcap after the 1/sqrt(hd) scaling and before the mask, masked
softmax with the ``l_safe`` guard), so the two packages agree to
float32 rounding at equal inputs. A ``window`` of 0 is global
attention; otherwise a query at position p sees the keys at positions
``> p - window`` (gemma2's local layers).
Attention here is plain PyTorch (training over the whole sequence, and
decode against the cache view); the kernels the serving path runs sit
behind :func:`pmatmul` (K1) and ``gather_pages_kv`` (K2). Every function
is differentiable by autograd, including ``pmatmul``'s cast of a float32
weight to the activation dtype.

Context parallelism (:class:`ShardCtx`): under a sharded context the
sequence is split over the model group; training attention all-gathers
K and V along the sequence (its backward reduce-scatters them) and masks
with global positions.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.serve.quantized import QuantizedLeaf


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """How the forward is sharded: ``cp_group`` the model group the
    sequence is split over (None: local), ``cp_size`` its number of
    shards and ``cp_rank`` this rank's, and ``param_gather``, the hook
    ``gather(subtree, kind)`` that makes whole weights of a parameter
    subtree (kind "static": the leaves outside the layer stack; "blocks":
    one layer's), e.g. from model shards (``dist.step``) or from
    code-resident leaves (``serve.session.make_dequant_gather``). None is
    the identity."""

    cp_group: Any = None
    cp_size: int = 1
    cp_rank: int = 0
    param_gather: Optional[Callable] = None

    @property
    def sharded(self) -> bool:
        return self.cp_group is not None and self.cp_size > 1

    def cp_index(self) -> int:
        """This shard's place along the sequence (0 unsharded)."""
        return self.cp_rank if self.sharded else 0

    def gather(self, subtree, kind: str):
        if self.param_gather is None:
            return subtree
        return self.param_gather(subtree, kind)


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------

def code_resident(w) -> bool:
    """True for code-resident quantized weights (``QuantizedLeaf``)."""
    return isinstance(w, QuantizedLeaf)


def pmatmul(x: torch.Tensor, w, backend: Optional[str] = None) -> torch.Tensor:
    """Weight projection ``x @ w`` in x's dtype - the model's single
    contraction choke point. A code-resident ``w`` runs the K1 fused
    dequant-matmul; a float ``w`` is cast to x's dtype first."""
    if code_resident(w):
        return w.astype(x.dtype).matmul(x, backend=backend)
    return x @ w.to(x.dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x, w, eps=1e-6):
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.to(torch.float32)).to(dt)


def apply_norm(x, p, cfg: ModelConfig):
    return rmsnorm(x, p["w"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x, positions, theta):
    """x: (..., S, H, hd); positions: (S,) or (B, S) int positions."""
    hd = x.shape[-1]
    half = hd // 2
    dev = x.device
    th = torch.full((), theta, dtype=torch.float32, device=dev)  # no H2D copy
    inv_freq = torch.exp(-torch.log(th) * 2.0
                         * torch.arange(half, dtype=torch.float32, device=dev)
                         / hd)
    ang = positions.to(torch.float32)[..., None] * inv_freq   # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    if positions.dim() == 1:
        cos, sin = cos[None], sin[None]                       # (1, S, 1, half)
    xf = x.to(torch.float32)
    x1, x2 = xf[..., :half], xf[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (training): causal, over the whole sequence
# ---------------------------------------------------------------------------

def apply_softcap(s, cap):
    """``cap * tanh(s / cap)``; None leaves the scores as they are."""
    if cap is None:
        return s
    return cap * torch.tanh(s / cap)


def _window_ok(kv_pos, q_pos, window):
    """Keys inside the sliding window of each query (all when 0)."""
    if not window:
        return torch.ones_like(kv_pos > q_pos)
    return kv_pos > q_pos - window


def attention(q, k, v, *, q_pos, causal=True, window=0, softcap=None,
              ctx: ShardCtx = ShardCtx()):
    """GQA attention of a training forward. q: (B, Sq, H, hd) local;
    k, v: (B, Sq, K, hd) local, sequence-sharded iff ``ctx.sharded``;
    q_pos: (Sq,) global positions of the local queries. A sharded
    context all-gathers K and V along the sequence over its model group
    (``collectives.gather_shard``: the backward reduce-scatters their
    gradients), so the keys sit at global positions ``0..Skv-1``.

    As the reference: the H query heads are grouped (B, S, K, rep, hd)
    against their K/V head, scores are taken in float32 (exact products
    of the activation-dtype inputs), scaled, softcapped, masked (causal
    and window) with -1e30, softmaxed in float32 and cast to the
    activation dtype before the product with v. Plain PyTorch, so
    autograd gives its backward; the reference also computes it outside
    any Pallas kernel.
    """
    B, Sq, H, hd = q.shape
    if ctx.sharded:
        from repro_torch.dist import collectives as C
        k = C.gather_shard(k, 1, ctx.cp_size, ctx.cp_group)
        v = C.gather_shard(v, 1, ctx.cp_size, ctx.cp_group)
    K = k.shape[2]
    rep = H // K
    qr = q.reshape(B, Sq, K, rep, hd)
    scores = torch.einsum("bqkrd,bskd->bkrqs", qr.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(hd)
    scores = apply_softcap(scores, softcap)
    kv_pos = torch.arange(k.shape[1], device=q_pos.device)
    qp, kp = q_pos[:, None], kv_pos[None, :]
    mask = _window_ok(kp, qp, window)                          # (Sq, Skv)
    if causal:
        mask = mask & (qp >= kp)
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkrqs,bskd->bqkrd", probs, v)
    return out.reshape(B, Sq, H, hd)


# ---------------------------------------------------------------------------
# Attention against a cache view
# ---------------------------------------------------------------------------

def decode_attention(q, k_cache, v_cache, *, total_len, window=0,
                     softcap=None, kv_positions=None, extra_valid=None):
    """Single-token decode against a (B, S, K, hd) cache view.

    total_len: valid cache entries, scalar or (B,) per slot (the query
    sits at position total_len - 1). window / softcap: the layer's
    sliding window (0: global) and attention logit softcap.
    kv_positions: (S,) positions of the view columns; extra_valid:
    optional (B, S) mask ANDed into validity (page ownership for paged
    views).
    """
    B, _, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    rep = H // K
    dev = q.device
    kv_pos = (torch.arange(S, device=dev) if kv_positions is None
              else kv_positions)
    tl = torch.as_tensor(total_len, device=dev).expand(B)
    valid = kv_pos[None, :] < tl[:, None]                      # (B, S)
    valid = valid & _window_ok(kv_pos[None, :], tl[:, None] - 1, window)
    if extra_valid is not None:
        valid = valid & extra_valid
    qr = q.reshape(B, K, rep, hd).to(torch.float32)
    scores = torch.einsum("bkrd,bskd->bkrs", qr,
                          k_cache.to(torch.float32)) / math.sqrt(hd)
    scores = apply_softcap(scores, softcap)
    mask = valid[:, None, None, :]
    scores = torch.where(mask, scores, -torch.inf)
    l_loc = torch.amax(scores, dim=-1)                         # (B, K, rep)
    l_safe = torch.where(torch.isfinite(l_loc), l_loc, -1e30)
    p = torch.exp(scores - l_safe[..., None])
    p = torch.where(mask, p, 0.0)
    denom = torch.sum(p, dim=-1)
    o = torch.einsum("bkrs,bskd->bkrd", p, v_cache.to(torch.float32))
    out = o / torch.clamp_min(denom[..., None], 1e-30)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def chunk_attention(q, k_cache, v_cache, *, q_pos, window=0, softcap=None,
                    kv_positions=None, extra_valid=None):
    """Chunked-prefill attention: Sq prompt tokens per slot attend to the
    slot's cache view, which already holds the chunk's own K/V.

    q: (B, Sq, H, hd); q_pos: (B, Sq) positions; causality rides on them
    (kv_pos <= q_pos), and the window on them too. Queries past the
    chunk's valid prefix give outputs the caller discards.
    """
    B, Sq, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    rep = H // K
    dev = q.device
    kv_pos = (torch.arange(S, device=dev) if kv_positions is None
              else kv_positions)
    valid = kv_pos[None, None, :] <= q_pos[:, :, None]        # (B, Sq, S)
    valid = valid & _window_ok(kv_pos[None, None, :], q_pos[:, :, None],
                               window)
    if extra_valid is not None:
        valid = valid & extra_valid[:, None, :]
    qr = q.reshape(B, Sq, K, rep, hd).to(torch.float32)
    scores = torch.einsum("bqkrd,bskd->bkrqs", qr,
                          k_cache.to(torch.float32)) / math.sqrt(hd)
    scores = apply_softcap(scores, softcap)
    mask = valid[:, None, None]                                # (B,1,1,Sq,S)
    scores = torch.where(mask, scores, -torch.inf)
    l_loc = torch.amax(scores, dim=-1)
    l_safe = torch.where(torch.isfinite(l_loc), l_loc, -1e30)
    p = torch.exp(scores - l_safe[..., None])
    p = torch.where(mask, p, 0.0)
    denom = torch.sum(p, dim=-1)                               # (B,K,rep,Sq)
    o = torch.einsum("bkrqs,bskd->bqkrd", p, v_cache.to(torch.float32))
    out = o / torch.clamp_min(torch.movedim(denom, -1, 1)[..., None], 1e-30)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp(params, x, backend: Optional[str] = None):
    """Gated silu MLP."""
    h = (F.silu(pmatmul(x, params["w_gate"], backend))
         * pmatmul(x, params["w_up"], backend))
    return pmatmul(h, params["w_down"], backend)
