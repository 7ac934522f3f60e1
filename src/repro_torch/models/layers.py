"""Building-block layers of the dense, MoE, SSM, hybrid and
encoder-decoder families (port of ``repro/models/layers.py``).

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
with global positions, the MoE layer holds E / n of the experts and
exchanges tokens with the other ranks (``collectives.expert_exchange``),
the SSD scan corrects each shard's chunks with the summaries of the
shards before it and the causal convolution takes its halo from the
previous shard (``collectives.gather_stack`` and ``shift``, whose
backwards are written out: a reduce-scatter, the reverse shift). A
sharded decode (``dist.serve``) holds the cache split along the
sequence: each shard takes the softmax of its own columns and
:func:`decode_attention` combines them over the model group.

The SSD scan (mamba2, hymba's SSM heads) is plain PyTorch, as it is
plain jnp in the reference; so are the encoder-decoder family's
layernorm, sinusoidal positions and gelu MLP (whisper).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig, MoEConfig, SSMConfig
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


def layernorm(x, w, b, eps=1e-5):
    """float32 mean and biased variance, ``(x - mu) rsqrt(var + eps) w +
    b`` with w and b in float32, cast back to x's dtype."""
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.to(torch.float32) + b.to(torch.float32)).to(dt)


def apply_norm(x, p, cfg: ModelConfig):
    """The config's norm with its ``norm_eps`` (whisper's layernorm: 1e-6,
    not layernorm's default)."""
    if cfg.norm == "layernorm":
        return layernorm(x, p["w"], p["b"], cfg.norm_eps)
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


def sinusoidal_positions(S: int, d: int, offset=0, device=None):
    """Absolute positions ``offset + arange(S)`` as float32 ``[sin(p /
    10000^(2i/d)), cos(...)]`` for i < d/2: (S, d) for a number or a 0-d
    offset, (B, S, d) for a (B,) tensor (per-slot decode positions, read
    on the device: no host sync)."""
    if isinstance(offset, torch.Tensor):
        device = offset.device
        off = offset.to(torch.float32)[..., None]
    else:
        off = float(offset)
    pos = off + torch.arange(S, dtype=torch.float32, device=device)
    i = torch.arange(d // 2, dtype=torch.float32, device=device)
    ang = pos[..., None] / torch.pow(10000.0, 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Attention (training): over the whole sequence
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
              meta_tokens=0, ctx: ShardCtx = ShardCtx()):
    """GQA attention of a training forward. q: (B, Sq, H, hd) local;
    k, v: (B, Skv, K, hd) local, sequence-sharded iff ``ctx.sharded``;
    q_pos: (Sq,) global positions of the local queries (unread by a
    bidirectional, unwindowed call: the encoder's self-attention and the
    cross-attention, which mask nothing, as the reference's all-true
    mask changes nothing). A sharded
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

    ``meta_tokens`` (hymba): the first ``meta_tokens`` key columns are a
    learned prefix the caller concatenated in front of the keys (with
    ``q_pos`` shifted by as many); the window never masks them.
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
    if causal or window:
        kv_pos = torch.arange(k.shape[1], device=q_pos.device)
        qp, kp = q_pos[:, None], kv_pos[None, :]
        mask = _window_ok(kp, qp, window)                      # (Sq, Skv)
        if meta_tokens:
            mask = mask | (kp < meta_tokens)
        if causal:
            mask = mask & (qp >= kp)
        scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkrqs,bskd->bqkrd", probs, v)
    return out.reshape(B, Sq, H, hd)


# ---------------------------------------------------------------------------
# Attention against a cache view
# ---------------------------------------------------------------------------

def _meta_valid(ctx: ShardCtx) -> bool:
    """Whether this shard counts the meta prefix: every local call, and
    under a sharded context shard 0 only, so the combine across the
    model group sees the prefix exactly once."""
    return ctx.cp_index() == 0


def _with_meta(k_cache, v_cache, valid, meta_kv, ctx: ShardCtx = ShardCtx()):
    """The learned prefix ``meta_kv = (mk, mv)`` (B, M, K, hd) in front of
    the cache view's columns, valid where :func:`_meta_valid` says."""
    if meta_kv is None:
        return k_cache, v_cache, valid
    mk, mv = meta_kv
    meta = torch.full(valid.shape[:-1] + (mk.shape[1],), _meta_valid(ctx),
                      dtype=torch.bool, device=valid.device)
    return (torch.cat([mk.to(k_cache.dtype), k_cache], dim=1),
            torch.cat([mv.to(v_cache.dtype), v_cache], dim=1),
            torch.cat([meta, valid], dim=-1))


def _combine(o, denom, l_safe, ctx: ShardCtx):
    """The flash-style combine of every shard's partial softmax over the
    model group: an all-reduce MAX of ``l_safe``, weights ``w = exp(l_safe
    - l_max)`` and one SUM all-reduce of ``o w`` and ``denom w``, packed
    into one float32 buffer: O(B H hd) bytes a call, whatever the
    sequence length. Every rank of the group gets the same bits."""
    from repro_torch.dist import collectives as C
    l_max = C.all_reduce(l_safe.clone(), ctx.cp_group, op="max")
    w = torch.exp(l_safe - l_max)
    n = o.numel()
    buf = torch.cat([(o * w[..., None]).reshape(-1),
                     (denom * w).reshape(-1)])
    C.all_reduce(buf, ctx.cp_group)
    return buf[:n].reshape(o.shape), buf[n:].reshape(denom.shape)


def decode_attention(q, k_cache, v_cache, *, total_len, window=0,
                     softcap=None, kv_positions=None, extra_valid=None,
                     meta_kv=None, ctx: ShardCtx = ShardCtx()):
    """Single-token decode against a (B, S_loc, K, hd) cache view.

    total_len: valid cache entries, scalar or (B,) per slot (the query
    sits at position total_len - 1). window / softcap: the layer's
    sliding window (0: global) and attention logit softcap.
    kv_positions: (S_loc,) global positions of the view columns, by
    default ``ctx.cp_index() * S_loc + arange(S_loc)`` (a sequence-sharded
    cache; a paged view passes its own); extra_valid: optional (B, S_loc)
    mask ANDed into validity (page ownership for paged views, so each
    shard counts each page once); meta_kv: hymba's (B, M, K, hd) prefix,
    always visible, counted on shard 0 only under ``ctx``.

    Under a sharded ``ctx`` each shard takes the softmax of its own
    columns and :func:`_combine` joins them, as the reference's
    (logsumexp, weighted sum) psums.
    """
    B, _, H, hd = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    rep = H // K
    dev = q.device
    kv_pos = (ctx.cp_index() * S + torch.arange(S, device=dev)
              if kv_positions is None else kv_positions)
    tl = torch.as_tensor(total_len, device=dev).expand(B)
    valid = kv_pos[None, :] < tl[:, None]                      # (B, S)
    valid = valid & _window_ok(kv_pos[None, :], tl[:, None] - 1, window)
    if extra_valid is not None:
        valid = valid & extra_valid
    k_cache, v_cache, valid = _with_meta(k_cache, v_cache, valid, meta_kv,
                                         ctx)
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
    if ctx.sharded:
        o, denom = _combine(o, denom, l_safe, ctx)
    out = o / torch.clamp_min(denom[..., None], 1e-30)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def chunk_attention(q, k_cache, v_cache, *, q_pos, window=0, softcap=None,
                    kv_positions=None, extra_valid=None, meta_kv=None):
    """Chunked-prefill attention: Sq prompt tokens per slot attend to the
    slot's cache view, which already holds the chunk's own K/V.

    q: (B, Sq, H, hd); q_pos: (B, Sq) positions; causality rides on them
    (kv_pos <= q_pos), and the window on them too. Queries past the
    chunk's valid prefix give outputs the caller discards. meta_kv:
    hymba's (B, M, K, hd) prefix, visible to every query.
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
    k_cache, v_cache, valid = _with_meta(k_cache, v_cache, valid, meta_kv)
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

def mlp(params, x, backend: Optional[str] = None, act: str = "silu"):
    """Gated silu MLP, or with ``act="gelu"`` whisper's non-gated
    ``gelu(x W_up) W_down`` (gelu's tanh form, as ``jax.nn.gelu``'s
    default)."""
    if act == "gelu":
        h = F.gelu(pmatmul(x, params["w_up"], backend), approximate="tanh")
        return pmatmul(h, params["w_down"], backend)
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


# ---------------------------------------------------------------------------
# Mamba-2 SSD (state-space duality), chunked, context-parallel
# ---------------------------------------------------------------------------

def softplus(x):
    """``jax.nn.softplus``'s formula, ``max(x, 0) + log1p(exp(-|x|))``
    (``F.softplus`` switches to x above a threshold)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def segsum(a):
    """a: (..., l) -> (..., l, l) lower-triangular segment sums,
    ``out[..., i, j] = sum(a[..., j+1..i])`` for i >= j and -inf above the
    diagonal, masked before any ``exp`` so that neither the forward nor
    the backward meets an overflow (the reference's ``_segsum``)."""
    l = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    ss = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=a.device))
    return torch.where(mask, ss, -torch.inf)


def chunk_prefix(chunk_decay, states):
    """The inter-chunk recurrence: inclusive prefixes (decay (B, nc, H),
    state (B, nc, H, P, N)) of ``(d1, s1) o (d2, s2) = (d1 d2, s1 d2 +
    s2)`` over the chunks, in chunk order (the reference takes the same
    prefixes with ``lax.associative_scan``, which groups the products
    differently: float32 rounding apart)."""
    d, s = chunk_decay[:, 0], states[:, 0]
    ds, ss = [d], [s]
    for c in range(1, chunk_decay.shape[1]):
        dc = chunk_decay[:, c]
        s = s * dc[..., None, None] + states[:, c]
        d = d * dc
        ds.append(d)
        ss.append(s)
    return torch.stack(ds, dim=1), torch.stack(ss, dim=1)


def _exchange_summaries(total_decay, final, ctx: ShardCtx,
                        cp_exchange: str, wire_dtype):
    """Under context parallelism: the (decay (B, H), state (B, H, P, N))
    that the shards before this one leave at its first token, from
    every shard's local summary. ``"gather"``: all-gather the summaries
    and fold those of the lower ranks in rank order. ``"ladder"``: a
    Hillis-Steele prefix over the model group (log2(n) point-to-point
    hops, then one shift), ``wire_dtype`` on the wire. Every collective
    runs on every rank and its output enters every rank's graph (the
    reference's ``where``s), so the backward's collectives (the
    transposes: a reduce-scatter, the reverse shifts) pair up."""
    from repro_torch.dist import collectives as CL
    n, idx, group = ctx.cp_size, ctx.cp_rank, ctx.cp_group
    dev = final.device
    if cp_exchange == "ladder":
        acc_d, acc_s = total_decay, final
        hop = 1
        while hop < n:
            rd = CL.shift(acc_d, hop, group, wire_dtype)
            rs = CL.shift(acc_s, hop, group, wire_dtype)
            take = torch.tensor(idx >= hop, device=dev)
            # the incoming segment precedes ours: (d_in, s_in) o (d, s)
            acc_s = torch.where(take, rs * acc_d[..., None, None] + acc_s,
                                acc_s)
            acc_d = torch.where(take, rd * acc_d, acc_d)
            hop *= 2
        inc_state = CL.shift(acc_s, 1, group, wire_dtype)
        inc_decay = torch.where(torch.tensor(idx == 0, device=dev),
                                torch.ones_like(acc_d),
                                CL.shift(acc_d, 1, group, wire_dtype))
        return inc_decay, inc_state
    if cp_exchange != "gather":
        raise ValueError(f"unknown cp_exchange {cp_exchange!r}")
    gd = CL.gather_stack(total_decay, group)
    gs = CL.gather_stack(final, group)
    d_acc, s_acc = torch.ones_like(total_decay), torch.zeros_like(final)
    for i in range(n):
        take = torch.tensor(i < idx, device=dev)
        d_i = torch.where(take, gd[i], torch.ones_like(gd[i]))
        s_i = torch.where(take, gs[i], torch.zeros_like(gs[i]))
        d_acc, s_acc = d_acc * d_i, s_acc * d_i[..., None, None] + s_i
    return d_acc, s_acc


def ssd_chunked(xdt, a_bar, Bm, Cm, *, chunk: int,
                ctx: ShardCtx = ShardCtx(), initial_state=None,
                cp_exchange: str = "gather", cp_wire_dtype=torch.float32):
    """The chunked SSD scan (the reference's ``ssd_chunked``), in float32.

    xdt (B, S, H, P): inputs times dt; a_bar (B, S, H): log decay per
    token (dt A, negative); Bm, Cm (B, S, G, N): input and output
    projections, G groups shared by H / G heads each. Returns (y (B, S,
    H, P) in xdt's dtype, the final state (B, H, P, N) float32).
    ``initial_state`` (B, H, P, N) seeds the scan (chunked prefill from
    a decode cache). S must be a multiple of ``chunk``.

    Within a chunk, y = ((C B^T) * L) x with L = exp(segsum(a)), taken
    as three products over the group's C B^T, never as one
    four-operand einsum (which can build a (b, c, l, s, h, n) product).
    Across chunks, :func:`chunk_prefix`. Under a sharded context the
    sequence is split over the model group: each shard scans from zero
    and adds ``init * decay`` corrections from the shards before it
    (:func:`_exchange_summaries`); the returned final state is then this
    shard's (the last shard holds the sequence's)."""
    B, S, H, P = xdt.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if S % chunk:
        raise ValueError(f"ssd_chunked: the sequence length {S} is not a "
                         f"multiple of the chunk {chunk}")
    reph = H // G
    nc = S // chunk
    f32 = torch.float32
    xc = xdt.reshape(B, nc, chunk, H, P).to(f32)
    ac = a_bar.reshape(B, nc, chunk, H).to(f32)
    Bc = Bm.reshape(B, nc, chunk, G, N).to(f32)
    Cc = Cm.reshape(B, nc, chunk, G, N).to(f32)

    acum = torch.cumsum(ac, dim=2)                            # (B,nc,l,H)
    # intra-chunk (diagonal) term: (C B^T per group) * L, then @ x
    Lmat = torch.exp(segsum(ac.transpose(2, 3)))              # (B,nc,H,l,l)
    CB = torch.einsum("bclgn,bcsgn->bcgls", Cc, Bc)           # (B,nc,G,l,l)
    Wm = CB.repeat_interleave(reph, dim=2) * Lmat             # (B,nc,H,l,l)
    Y_diag = torch.einsum("bchls,bcshp->bclhp", Wm, xc)

    # per-chunk output states
    decay_states = torch.exp(acum[:, :, -1:, :] - acum)       # (B,nc,l,H)
    Bh = Bc.repeat_interleave(reph, dim=3)                    # (B,nc,l,H,N)
    states = torch.einsum("bclhn,bclhp->bchpn",
                          Bh * decay_states[..., None], xc)
    chunk_decay = torch.exp(acum[:, :, -1, :])                # (B,nc,H)

    dfx, sfx = chunk_prefix(chunk_decay, states)
    prev = torch.cat([torch.zeros_like(sfx[:, :1]), sfx[:, :-1]], dim=1)
    local_total_decay = dfx[:, -1]                            # (B,H)
    local_final = sfx[:, -1]                                  # (B,H,P,N)

    init = initial_state
    if ctx.sharded:
        inc_decay, inc_state = _exchange_summaries(
            local_total_decay, local_final, ctx, cp_exchange, cp_wire_dtype)
        init = inc_state if initial_state is None else \
            inc_state + initial_state * inc_decay[..., None, None]
    if init is not None:
        # chunk c sees the extra state init * prod(decay of chunks < c)
        excl_decay = torch.cat([torch.ones_like(dfx[:, :1]), dfx[:, :-1]],
                               dim=1)                         # (B,nc,H)
        prev = prev + init[:, None] * excl_decay[..., None, None]
        local_final = local_final + init * local_total_decay[..., None, None]

    Ch = Cc.repeat_interleave(reph, dim=3)                    # (B,nc,l,H,N)
    Y_off = torch.einsum("bclhn,bchpn->bclhp", Ch, prev) \
        * torch.exp(acum)[..., None]
    y = (Y_diag + Y_off).reshape(B, S, H, P)
    return y.to(xdt.dtype), local_final


def ssd_step(h, xdt, a_bar, Bm, Cm):
    """One token of the SSD recurrence: the state h (B, H, P, N) float32,
    xdt (B, H, P), a_bar (B, H), Bm, Cm (B, G, N) -> (y (B, H, P) in
    xdt's dtype, the new state ``h exp(a_bar) + xdt (x) B``), the
    reference's decode arithmetic in float32."""
    H, G = xdt.shape[1], Bm.shape[1]
    dA = torch.exp(a_bar)                                      # (B,H)
    Bh = Bm.repeat_interleave(H // G, dim=1)                   # (B,H,N)
    Ch = Cm.repeat_interleave(H // G, dim=1)
    h = h * dA[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", xdt.to(torch.float32), Bh.to(torch.float32))
    y = torch.einsum("bhpn,bhn->bhp", h, Ch.to(torch.float32))
    return y.to(xdt.dtype), h


def causal_conv1d(x, w, *, ctx: ShardCtx = ShardCtx(), prev_tail=None):
    """Depthwise causal convolution of x (B, S, C) with w (d_conv, C), in
    float32, cast back to x's dtype. The d_conv - 1 tokens before the
    first are ``prev_tail`` (a decode cache's conv tail) or zeros; under
    a sharded context, shard r > 0 takes them from shard r - 1 (the
    halo, ``collectives.shift``)."""
    B, S, C = x.shape
    dconv = w.shape[0]
    halo = dconv - 1
    tail = (torch.zeros((B, halo, C), dtype=x.dtype, device=x.device)
            if prev_tail is None else prev_tail)
    if ctx.sharded:
        from repro_torch.dist import collectives as CL
        recv = CL.shift(x[:, -halo:, :], 1, ctx.cp_group)
        tail = torch.where(torch.tensor(ctx.cp_rank > 0, device=x.device),
                           recv, tail)
    xp = torch.cat([tail.to(x.dtype), x], dim=1)              # (B,S+halo,C)
    y = torch.zeros((B, S, C), dtype=torch.float32, device=x.device)
    for i in range(dconv):
        y = y + xp[:, i:i + S, :].to(torch.float32) * w[i].to(torch.float32)
    return y.to(x.dtype)


def mamba2_mix(params, x, scfg: SSMConfig, d_model: int,
               ctx: ShardCtx = ShardCtx(), decode_cache=None,
               backend: Optional[str] = None):
    """The mamba2 mixer of x (B, S, d_model) -> (out (B, S, d_model),
    {"ssm": state (B, H, P, N) float32, "conv": tail (B, d_conv - 1,
    conv_dim)}), the reference's ``mamba2_mix`` with its casts: ``dt``
    and ``A`` in float32, ``xdt`` in the activation dtype, the scan in
    float32 and y cast back.

    ``decode_cache`` None: training or whole-prompt prefill (the scan
    from zero, or under ``ctx`` over the model group). A dict {"ssm",
    "conv"} and S == 1: the single-token recurrence ``h dA + x (x) B``.
    A dict and S > 1: the chunked prefill, the scan seeded from the
    cache's state (S must be a multiple of ``scfg.chunk``). The caller
    writes the returned state where it keeps it."""
    Bn, S, _ = x.shape
    di = scfg.expand * d_model
    G, N, Pd = scfg.n_groups, scfg.d_state, scfg.head_dim
    H = di // Pd
    conv_dim = di + 2 * G * N
    halo = scfg.d_conv - 1

    zxbcdt = pmatmul(x, params["in_proj"], backend)
    z, xbc, dt = torch.split(zxbcdt, [di, conv_dim, H], dim=-1)
    dt = softplus(dt.to(torch.float32)
                  + params["dt_bias"].to(torch.float32))     # (B,S,H)
    A = -torch.exp(params["A_log"].to(torch.float32))         # (H,)

    if decode_cache is None:
        xbc_c = causal_conv1d(xbc, params["conv_w"], ctx=ctx)
        new_conv = xbc[:, -halo:, :]
    else:
        xbc_c = causal_conv1d(xbc, params["conv_w"],
                              prev_tail=decode_cache["conv"])
        new_conv = torch.cat([decode_cache["conv"].to(xbc.dtype), xbc],
                             dim=1)[:, -halo:, :]
    xbc_c = F.silu(xbc_c)
    xs, Bm, Cm = torch.split(xbc_c, [di, G * N, G * N], dim=-1)
    xs = xs.reshape(Bn, S, H, Pd)
    Bm = Bm.reshape(Bn, S, G, N)
    Cm = Cm.reshape(Bn, S, G, N)

    a_bar = dt * A[None, None, :]                              # log decay
    xdt = xs * dt[..., None].to(xs.dtype)

    if decode_cache is None:
        wire = (torch.bfloat16 if scfg.cp_wire_dtype == "bfloat16"
                else torch.float32)
        y, new_ssm = ssd_chunked(xdt, a_bar, Bm, Cm, chunk=scfg.chunk,
                                 ctx=ctx, cp_exchange=scfg.cp_exchange,
                                 cp_wire_dtype=wire)
    elif S == 1:
        y, new_ssm = ssd_step(decode_cache["ssm"], xdt[:, 0], a_bar[:, 0],
                              Bm[:, 0], Cm[:, 0])
        y = y[:, None]                                         # (B,1,H,P)
    else:
        y, new_ssm = ssd_chunked(xdt, a_bar, Bm, Cm, chunk=scfg.chunk,
                                 initial_state=decode_cache["ssm"])

    y = y + xs * params["D"].to(xs.dtype)[None, None, :, None]
    y = y.reshape(Bn, S, di)
    y = rmsnorm(y * F.silu(z), params["norm_w"])
    out = pmatmul(y, params["out_proj"], backend)
    return out, {"ssm": new_ssm, "conv": new_conv}
