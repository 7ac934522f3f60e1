"""Building-block layers of the dense and MoE decoders (port of
``repro/models/layers.py``).

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
with global positions, and the MoE layer holds E / n of the experts and
exchanges tokens with the other ranks (``collectives.expert_exchange``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig, MoEConfig
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


# ---------------------------------------------------------------------------
# Mixture of Experts (shared + routed experts; einsum or sort dispatch)
# ---------------------------------------------------------------------------

def capacity(T: int, mcfg: MoEConfig) -> int:
    """Slots an expert takes per call of T tokens: ``ceil(T k / E *
    capacity_factor)``, at least 1, in Python doubles as the reference.
    Every routed token counts (a padded chunk tail, an idle decode
    slot), so chunked, whole and injected admission drop differently."""
    return max(1, math.ceil(T * mcfg.top_k / mcfg.n_experts
                            * mcfg.capacity_factor))


def moe_route(params, xt: torch.Tensor, mcfg: MoEConfig,
              backend: Optional[str] = None):
    """The router of T tokens xt (T, d): (float32 softmax probabilities
    (T, E), renormalized top-k gate values (T, k), their expert indices
    (T, k) int64). The logits are taken in xt's dtype (K1 for a
    code-resident router) and only then widened, as the reference
    rounds them. Top-k is a stable descending sort, so a tie puts the
    lower expert index first, as ``jax.lax.top_k`` does (``torch.topk``
    promises no order on ties, and bf16 router logits tie often)."""
    logits = pmatmul(xt, params["router"], backend).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :mcfg.top_k], idx[:, :mcfg.top_k]
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(dim=-1, keepdim=True), 1e-9)
    return probs, gate_vals, gate_idx


def _dispatch_einsum(xt, gate_idx, gate_vals, E: int, C: int):
    """The Switch one-hot dispatch: (xe (E, C, d), comb (T, E, C)). Slot
    c of expert e is the c-th of its (token, choice) pairs in token
    order; later ones are dropped. Each (e, c) holds one pair at most,
    so both products sum one nonzero term."""
    T, k = gate_idx.shape
    dt = xt.dtype
    dev = xt.device
    onehot = (gate_idx[..., None] == torch.arange(E, device=dev)).to(
        torch.int32)                                        # (T, k, E)
    flatoh = onehot.reshape(T * k, E)
    pos = (torch.cumsum(flatoh, dim=0) * flatoh - 1).reshape(T, k, E)
    in_cap = (pos >= 0) & (pos < C)
    disp = ((pos[..., None] == torch.arange(C, device=dev)).to(dt)
            * in_cap[..., None].to(dt) * onehot[..., None].to(dt))
    comb = torch.sum(disp * gate_vals.to(dt)[:, :, None, None], dim=1)
    xe = torch.einsum("td,tkec->ecd", xt, disp)
    return xe, comb


def _dispatch_sort(xt, gate_idx, E: int, C: int):
    """The argsort dispatch (the reference's ``_moe_dispatch_sort``),
    with no one-hot tensors and no scatter: a stable sort of the T k
    (token, choice) pairs by expert keeps token order within an expert,
    so expert e's rank-c pair fills slot (e, c) and the same late pairs
    as the einsum path's are dropped. Slot (e, c) gathers its pair's
    row (zeros where expert e has fewer than c + 1 pairs): every kept
    destination is one pair's, so no sum order enters, and the backward
    sums a token's k rows in a fixed order (no atomics).

    Returns (xe (E, C, d), dest (T, k) flat slot of each pair, clipped
    into its expert's slots, keep (T, k) bool)."""
    T, k = gate_idx.shape
    d = xt.shape[1]
    dev = xt.device
    flat_e = gate_idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    experts = torch.arange(E, device=dev)
    starts = torch.searchsorted(se, experts)
    counts = torch.searchsorted(se, experts, right=True) - starts
    rank = torch.arange(T * k, device=dev) - starts[se]
    cols = torch.arange(C, device=dev)
    slot = torch.clamp(starts[:, None] + cols, max=T * k - 1)   # (E, C)
    filled = cols[None, :] < counts[:, None]
    xs = xt[:, None, :].expand(T, k, d).reshape(T * k, d)[order]
    xe = torch.where(filled[..., None], xs[slot],
                     torch.zeros((), dtype=xt.dtype, device=dev))
    inv = torch.argsort(order)          # pair i sits at inv[i] in sorted order
    keep = (rank < C)[inv].reshape(T, k)
    dest = (se * C + torch.clamp(rank, max=C - 1))[inv].reshape(T, k)
    return xe, dest, keep


def _combine_sort(ye, gate_idx, gate_vals, dest, keep, dtype):
    """The reference's ``_moe_combine_sort``: each token's k expert rows
    times their gate values, summed into zeros in ascending expert order
    (the order its scatter-add takes them, the pairs sorted by expert),
    one add at a time in ``dtype``."""
    T, k = gate_idx.shape
    d = ye.shape[-1]
    by_expert = torch.argsort(gate_idx, dim=1, stable=True)
    dest = torch.take_along_dim(dest, by_expert, dim=1)
    w = torch.take_along_dim(gate_vals * keep.to(gate_vals.dtype),
                             by_expert, dim=1).to(dtype)
    vals = ye.reshape(-1, d)[dest.reshape(-1)].reshape(T, k, d) * w[..., None]
    y = torch.zeros((T, d), dtype=dtype, device=ye.device)
    for j in range(k):
        y = y + vals[:, j]
    return y


def moe(params, x: torch.Tensor, mcfg: MoEConfig,
        ctx: ShardCtx = ShardCtx(), backend: Optional[str] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE feed-forward of x (B, S, d): (y (B, S, d), the 0-d float32
    load-balance aux loss), step for step the reference's
    ``layers.moe``.

    The router (:func:`moe_route`); the Switch aux loss from the top-1
    choice, ``sum(mean(probs) * mean(one_hot(idx[:, 0]))) * E *
    router_aux_weight``; the capacity (:func:`capacity`); the dispatch
    ``mcfg.dispatch`` names (``"einsum"``: the (T, k, E, C) one-hot
    tensors and two plain products, left to ``torch.einsum`` as the
    reference leaves them to XLA; ``"sort"``: :func:`_dispatch_sort` and
    :func:`_combine_sort`); the routed experts silu(xe W_gate) * (xe
    W_up) W_down on the stacks (E, d, f), cast to x's dtype; the shared
    experts through :func:`mlp` (K1 on code-resident weights).

    Under a sharded context the expert stacks are this rank's E / n
    experts: the slots go to their owners and come back through
    ``collectives.expert_exchange``. Every step is deterministic: the
    sorts are stable, the dispatch gathers, and the sums run in fixed
    orders."""
    Bn, S, d = x.shape
    T = Bn * S
    xt = x.reshape(T, d)
    E = mcfg.n_experts
    probs, gate_vals, gate_idx = moe_route(params, xt, mcfg, backend)
    me = torch.mean(probs, dim=0)
    ce = torch.mean((gate_idx[:, :1] == torch.arange(
        E, device=x.device)).to(torch.float32), dim=0)
    aux = torch.sum(me * ce) * E * mcfg.router_aux_weight
    C = capacity(T, mcfg)
    if mcfg.dispatch == "sort":
        xe, dest, keep = _dispatch_sort(xt, gate_idx, E, C)
    else:
        xe, comb = _dispatch_einsum(xt, gate_idx, gate_vals, E, C)
    if ctx.sharded:
        from repro_torch.dist import collectives as CL
        xe = CL.expert_exchange(xe, ctx.cp_group, to_experts=True)
    h = torch.einsum("ecd,edf->ecf", xe, params["w_gate"].to(xe.dtype))
    h = F.silu(h) * torch.einsum("ecd,edf->ecf", xe,
                                 params["w_up"].to(xe.dtype))
    ye = torch.einsum("ecf,efd->ecd", h, params["w_down"].to(xe.dtype))
    if ctx.sharded:
        ye = CL.expert_exchange(ye, ctx.cp_group, to_experts=False)
    if mcfg.dispatch == "sort":
        y = _combine_sort(ye, gate_idx, gate_vals, dest, keep, xt.dtype)
    else:
        y = torch.einsum("ecd,tec->td", ye, comb)
    if mcfg.n_shared:
        y = y + mlp(params["shared"], xt, backend)
    return y.reshape(Bn, S, d), aux
