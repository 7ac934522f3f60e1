"""The quantized wire of Algorithm 3 on ``torch.distributed`` (port of
``repro/dist/collectives.py``): every cross-worker collective ships
packed uint8 payload rows plus float32 scales, or float32 rows where a
channel is unquantized.

The reference names its workers by mesh axes inside ``shard_map``; here
a process group is the worker axis and a rank its worker index. Two
worker channels, both error-compensated in ``repro_torch.dist.step``
(the baselines' variants in ``repro_torch.dist.modes``):

  * **update exchange** (worker -> server): each worker K7-encodes its
    update ``Delta_t + e_t`` into per-chunk payload rows and all-to-alls
    them, so worker ``w`` (the server of chunk ``w``) receives every
    worker's codes for its chunk and K6-decodes each row with that
    worker's scale. Per leaf ``n_workers * codec.payload_nbytes(c)``
    bytes a worker.
  * **weight broadcast** (server -> worker): each server K7-encodes its
    master chunk with the weight codec and all-gathers the payload;
    every worker K6-decodes Q_x(x_t) for the whole leaf.

Hierarchical tiers (``repro_torch.dist.topology``) run the same two
channels through a :class:`TierGroups`: the exchange all-to-alls the
``n_inter`` rows of this device's intra position over the inter (node)
group, and the broadcast gathers over the inter group first, then
within the node. Flat tiers take the flat collectives op for op.

Two model-axis channels. The forward's per-layer weight gather:
:func:`gather_shard` in float32, or :func:`quantized_gather_shard` with
int8 codes and one scale a shard (K3, K4 and K12 on the card). Both are
differentiable: the backward of an all-gather is a reduce-scatter. And
the MoE layer's token exchange, :func:`expert_exchange`: a tiled
all-to-all between every expert's capacity slots and this rank's local
experts; its backward is the reverse exchange.

The collectives are the synchronous forms of ``torch.distributed``: on
NCCL they are ordered on the device after the current stream's work and
the host does not wait for them; on gloo (CPU tests) they block. A group
of None is one rank alone: its collectives are local.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.comm import codec as CD
from repro_torch.comm import kernels as K


class TierGroups(NamedTuple):
    """The process groups of resolved tiers: ``inter`` spans the exchange
    tier (every worker on a flat topology), ``intra`` the fast tier (None
    on a flat topology, and for one device a node)."""

    inter: Any
    intra: Any = None


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def worker_index(group) -> int:
    """This worker's index: its rank in the group."""
    return 0 if group is None else dist.get_rank(group)


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x.reshape((1,) + tuple(x.shape)).clone()
    n = dist.get_world_size(group)
    out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    # all_gather_single is the newer name of all_gather_into_tensor
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, x.reshape(-1).contiguous(), group=group)
    return out.reshape((n,) + tuple(x.shape))


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Sum (``op="max"``: maximum) over the group, in place."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=group)
    return x


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """All-gather one per-worker payload or float32 row -> (n_workers,
    *x.shape), rows in rank order (one flat all-gather: gloo takes flat
    buffers only)."""
    return _all_gather(x, group)


def gather_side(x: torch.Tensor, group) -> torch.Tensor:
    """All-gather a scale side channel (a per-tensor scale, or the
    blockwise codec's per-block scales) -> (n_workers, *x.shape). Kept
    apart from :func:`gather_rows`: the byte accounting counts payloads
    only."""
    return _all_gather(x, group)


def reduce_rows(rows: torch.Tensor, group) -> torch.Tensor:
    """All-reduce (sum) of float32 worker-ownership rows, in place: the
    ``dp_adam`` baseline's gradient reduce (the reference's psum)."""
    return all_reduce(rows, group)


def exchange_rows(rows: torch.Tensor, group) -> torch.Tensor:
    """All-to-all of worker-ownership rows: row j goes to worker j; the
    result's row i is worker i's row for this worker."""
    if group is None:
        return rows
    out = torch.empty_like(rows)
    dist.all_to_all_single(out, rows.contiguous(), group=group)
    return out


def exchange_decode(payload_rows: torch.Tensor, scale: torch.Tensor, codec,
                    c: int, group, *, backend: Optional[str] = None
                    ) -> torch.Tensor:
    """Update-exchange channel for one leaf: my per-chunk payload rows
    (K7) -> all_to_all -> K6 decode of every worker's codes for MY chunk
    with its source scale. Returns ``(n_workers, c)`` float32 rows."""
    if payload_rows.dtype != torch.uint8:
        raise ValueError("the exchange moves uint8 payload rows")
    recv = exchange_rows(payload_rows, group)
    scales = gather_side(scale.reshape(()), group)
    return CD.decode_rows(recv, scales, codec, c, backend=backend)


def broadcast_decode(payload: torch.Tensor, scale: torch.Tensor, codec,
                     c: int, group, *, backend: Optional[str] = None,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weight-broadcast channel for one leaf: my chunk's packed payload
    -> all_gather -> K6 decode of every chunk with its source scale.
    Returns ``(n_workers, c)`` float32 rows, or writes the leaf's first
    ``out.numel()`` values into ``out`` (the rows' padding dropped)."""
    if payload.dtype != torch.uint8:
        raise ValueError("the broadcast moves uint8 payloads")
    rows = gather_rows(payload, group)
    scales = gather_side(scale.reshape(()), group)
    return CD.decode_rows(rows, scales, codec, c, backend=backend, out=out)


# ---------------------------------------------------------------------------
# per-tier channels: flat tiers take the collectives above op for op;
# hierarchical tiers keep the slow (inter) links to n_inter rows a leaf
# ---------------------------------------------------------------------------

def exchange_rows_tiered(rows: torch.Tensor, tiers, groups: TierGroups
                         ) -> torch.Tensor:
    """Tier-aware ``exchange_rows``. Flat: the all-to-all over every
    worker. Hierarchical: a node's devices hold bitwise the same rows
    (the gradient was intra-reduced first), so each device takes the
    ``n_inter`` rows of its intra position (worker ``w = node * n_intra
    + intra``) and all-to-alls them over the inter group only. Row ``k``
    of the result is node ``k``'s row for this worker's chunk."""
    if not tiers.hierarchical:
        return exchange_rows(rows, groups.inter)
    j = worker_index(groups.intra)
    grid = rows.reshape((tiers.n_inter, tiers.n_intra) + rows.shape[1:])
    return exchange_rows(grid[:, j].contiguous(), groups.inter)


def exchange_decode_tiered(payload_rows: torch.Tensor, scale: torch.Tensor,
                           codec, c: int, tiers, groups: TierGroups, *,
                           backend: Optional[str] = None) -> torch.Tensor:
    """Tier-aware ``exchange_decode``: the payload all-to-all over the
    exchange (inter) tier and the source scales gathered over the same
    tier. Returns ``(n_inter, c)`` float32 rows, one a peer
    (``n_inter == n_workers`` on a flat topology)."""
    if payload_rows.dtype != torch.uint8:
        raise ValueError("the exchange moves uint8 payload rows")
    recv = exchange_rows_tiered(payload_rows, tiers, groups)
    scales = gather_side(scale.reshape(()), groups.inter)
    return CD.decode_rows(recv, scales, codec, c, backend=backend)


def gather_rows_tiered(x: torch.Tensor, tiers, groups: TierGroups,
                       gather=None) -> torch.Tensor:
    """Tier-aware ``gather_rows`` (or ``gather``, e.g. ``gather_side``):
    (n_workers, *x.shape) in worker order. Hierarchical: over the inter
    group first (``n_inter`` rows cross the slow tier), then the stacked
    rows within the node, swapped into the flat ``(node, intra)``
    order."""
    gather = gather or gather_rows
    if not tiers.hierarchical:
        return gather(x, groups.inter)
    r = gather(x, groups.inter)                   # (n_inter, ...)
    r = gather(r, groups.intra)                   # (n_intra, n_inter, ...)
    return r.transpose(0, 1).reshape(
        (tiers.n_inter * tiers.n_intra,) + tuple(x.shape))


def broadcast_decode_tiered(payload: torch.Tensor, scale: torch.Tensor,
                            codec, c: int, tiers, groups: TierGroups, *,
                            backend: Optional[str] = None,
                            out: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Tier-aware ``broadcast_decode``: hierarchical tiers gather the
    payloads and scales inter first (``gather_rows_tiered``), so each
    chunk's codes cross the slow tier once a node. Returns ``(n_workers,
    c)`` float32 rows in worker order (or writes ``out``)."""
    if not tiers.hierarchical:
        return broadcast_decode(payload, scale, codec, c, groups.inter,
                                backend=backend, out=out)
    if payload.dtype != torch.uint8:
        raise ValueError("the broadcast moves uint8 payloads")
    rows = gather_rows_tiered(payload, tiers, groups)
    scales = gather_rows_tiered(scale.reshape(()), tiers, groups,
                                gather_side)
    return CD.decode_rows(rows, scales, codec, c, backend=backend, out=out)


# ---------------------------------------------------------------------------
# model-axis weight gather
# ---------------------------------------------------------------------------

def _tile(parts: torch.Tensor, ax: int) -> torch.Tensor:
    """(n, *shard) segments -> the whole tensor, segment i at position i
    along ``ax`` (a tiled all-gather's layout)."""
    n = parts.shape[0]
    shape = list(parts.shape[1:])
    shape[ax] *= n
    return parts.movedim(0, ax).reshape(shape)


def _untile(full: torch.Tensor, ax: int, n: int) -> torch.Tensor:
    """Inverse of :func:`_tile`: (n, *shard), contiguous."""
    shape = list(full.shape)
    loc = shape[ax] // n
    split = shape[:ax] + [n, loc] + shape[ax + 1:]
    return full.reshape(split).movedim(ax, 0).contiguous()


def _reduce_scatter(parts: torch.Tensor, group) -> torch.Tensor:
    """Sum of every rank's (n, *shard) segments, this rank's segment:
    one reduce-scatter on NCCL; an all-reduce and this rank's row on
    gloo, which has no reduce-scatter (the same sums)."""
    n = parts.shape[0]
    if dist.get_backend(group) == "nccl":
        out = torch.empty(parts.shape[1:], dtype=parts.dtype,
                          device=parts.device)
        dist.reduce_scatter_tensor(out, parts.reshape(n, -1), group=group)
        return out
    dist.all_reduce(parts, group=group)
    return parts[dist.get_rank(group)]


class _GatherShard(torch.autograd.Function):
    """All-gather along ``ax`` (tiled); backward: reduce-scatter, what
    the transpose of the reference's tiled ``all_gather`` is."""

    @staticmethod
    def forward(ctx, x, ax, group):
        ctx.ax, ctx.group = ax, group
        return _tile(_all_gather(x.contiguous(), group), ax)

    @staticmethod
    def backward(ctx, g):
        n = group_size(ctx.group)
        return (_reduce_scatter(_untile(g, ctx.ax, n), ctx.group), None,
                None)


def gather_shard(leaf: torch.Tensor, ax: int, n_shards: int,
                 group=None) -> torch.Tensor:
    """The whole weight from its model shards: a float all-gather of
    ``leaf`` along ``ax`` over ``group`` (the model group), with
    autograd (backward: the reduce-scatter of the gradient). One shard:
    the leaf itself."""
    if n_shards <= 1:
        return leaf
    return _GatherShard.apply(leaf, ax, group)


def quantize_shard(leaf: torch.Tensor, k_x: int, absolute: bool, *,
                   backend: Optional[str] = None):
    """A shard's int8 wire form: ``(codes int8, scale 0-d float32)`` of
    ``UniformCodec(k_x, absolute, wire_bits=8)``: the amax scale (K3;
    0.5 when absolute) and the codes clipped to +/-127 (K4)."""
    codec = CD.UniformCodec(k_x=k_x, absolute=absolute, wire_bits=8)
    x32 = leaf.to(torch.float32)
    scale = codec.compute_scale(x32, backend=backend)
    codes = codec.quantize(x32, scale, backend=backend).to(torch.int8)
    return codes, scale


class _QuantizedGather(torch.autograd.Function):
    """The int8 gather and the gradient ``jax.grad`` gives through the
    reference's ``quantized_gather_shard`` (see there)."""

    @staticmethod
    def forward(ctx, leaf, ax, n, k_x, absolute, group, backend):
        codes, scale = quantize_shard(leaf, k_x, absolute, backend=backend)
        if n <= 1:
            seg, scales = codes.reshape((1,) + codes.shape), scale.reshape(1)
        else:
            seg = _all_gather(codes, group)                 # (n, *shard)
            scales = _all_gather(scale.reshape(()), group)  # (n,)
        deq = K.uniform_dequantize_rows(seg.reshape(n, -1), scales, k_x,
                                        backend=backend)    # K12
        ctx.save_for_backward(leaf, seg, scale)
        ctx.ax, ctx.n, ctx.k_x, ctx.group = ax, n, k_x, group
        ctx.absolute = absolute
        return _tile(deq.reshape(seg.shape), ax).to(leaf.dtype)

    @staticmethod
    def backward(ctx, g):
        leaf, seg, scale = ctx.saved_tensors
        none = (None,) * 6
        if ctx.absolute:            # a constant scale: no gradient at all
            return (torch.zeros_like(leaf),) + none
        n = ctx.n
        gs = _untile(g.to(torch.float32), ctx.ax, n).reshape(n, -1)
        # d out / d scale_i = codes_i / 2^k_x; the codes carry none
        dscales = torch.sum(gs * (seg.reshape(n, -1).to(torch.float32)
                                  / float(2 ** ctx.k_x)), dim=1)
        if n > 1:                   # the scales' all-gather, transposed
            dist.all_reduce(dscales, group=ctx.group)
        ds = dscales[worker_index(ctx.group) if n > 1 else 0]
        # scale = where(amax > 0, amax, 1), amax = max|x|: the gradient
        # splits evenly over the elements at the max, times their sign
        x = leaf.to(torch.float32)
        at = (torch.abs(x) == scale) & (scale > 0)
        count = torch.clamp_min(at.sum().to(torch.float32), 1.0)
        dx = torch.where(at, torch.sign(x) * (ds / count),
                         torch.zeros_like(x))
        return (dx.to(leaf.dtype),) + none


def quantized_gather_shard(leaf: torch.Tensor, ax: int, n_shards: int,
                           k_x: int, absolute: bool, group=None, *,
                           backend: Optional[str] = None) -> torch.Tensor:
    """Int8 weight gather: the local shard quantized with its own scale
    (:func:`quantize_shard`), the int8 codes and scales all-gathered over
    the model group, and each segment dequantized with its source's
    scale (K12). One shard: a local Q_x round trip.

    The gradient is the reference's, what ``jax.grad`` gives through
    ``codec.quantize``'s rounding: the codes are integers and pass none,
    so the whole gradient flows through the scales. Shard i's scale
    takes ``sum(g_i * codes_i) / 2^k_x`` summed over the model group,
    and, the scale being ``max|x|`` (``where(amax > 0, amax, 1)``), it
    lands on the elements at the max, split evenly between ties, times
    their sign; every other element gets 0 (all of them with
    ``absolute``, whose scale is the constant 0.5)."""
    return _QuantizedGather.apply(leaf, ax, max(int(n_shards), 1), k_x,
                                  absolute, group, backend)


# ---------------------------------------------------------------------------
# model-axis expert exchange (expert parallelism)
# ---------------------------------------------------------------------------

def _exchange_experts(x: torch.Tensor, group, to_experts: bool
                      ) -> torch.Tensor:
    """One tiled all-to-all over the model group of n ranks, rank j
    owning experts [j E_loc, (j + 1) E_loc).

    ``to_experts``: (E, C, d) capacity slots of this rank's tokens ->
    (E_loc, n C, d), every rank's slots for the local experts, rank j's
    at columns [j C, (j + 1) C) (the reference's ``all_to_all(split_axis
    =0, concat_axis=1, tiled=True)``). Otherwise the inverse: (E_loc,
    n C, d) -> (E, C, d), rank j's experts' outputs for this rank's
    tokens at rows [j E_loc, (j + 1) E_loc) (``split_axis=1,
    concat_axis=0``)."""
    n = group_size(group)
    if to_experts:
        E, C, d = x.shape
        send = x.reshape(n, E // n, C, d).contiguous()
    else:
        El, nC, d = x.shape
        send = x.reshape(El, n, nC // n, d).movedim(1, 0).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if to_experts:                      # recv[j]: rank j's slots
        return recv.movedim(0, 1).reshape(E // n, n * C, d)
    return recv.reshape(n * El, nC // n, d)


class _ExpertExchange(torch.autograd.Function):
    """:func:`_exchange_experts` with autograd: the transpose of a tiled
    all-to-all is the all-to-all the other way, as ``jax.grad`` takes it
    through the reference's ``lax.all_to_all``."""

    @staticmethod
    def forward(ctx, x, group, to_experts):
        ctx.group, ctx.to_experts = group, to_experts
        return _exchange_experts(x, group, to_experts)

    @staticmethod
    def backward(ctx, g):
        return (_exchange_experts(g, ctx.group, not ctx.to_experts), None,
                None)


def expert_exchange(x: torch.Tensor, group, to_experts: bool
                    ) -> torch.Tensor:
    """The MoE token exchange over the model group (see
    :func:`_exchange_experts`), differentiable. A rank's loss then
    depends on the other ranks' local experts, and its backward sends
    their cotangents back to them: each rank's local expert leaves get
    the gradient of every rank's tokens' loss through them. One rank:
    the tensor itself."""
    if group_size(group) <= 1:
        return x
    return _ExpertExchange.apply(x, group, to_experts)


# ---------------------------------------------------------------------------
# model-axis SSD summaries and conv halos (the SSM family's context
# parallelism)
# ---------------------------------------------------------------------------

class _GatherStack(torch.autograd.Function):
    """All-gather stacked along a new leading dim (the reference's
    untiled ``lax.all_gather``): (n, *x.shape). Backward: the sum of
    every rank's cotangent of row r, to rank r (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g.contiguous().clone(), ctx.group), None


def gather_stack(x: torch.Tensor, group) -> torch.Tensor:
    """Every model rank's ``x``, stacked in rank order: (n, *x.shape),
    differentiable. One rank: ``x[None]``."""
    if group_size(group) <= 1:
        return x[None]
    return _GatherStack.apply(x, group)


def _shift(x: torch.Tensor, hop: int, group) -> torch.Tensor:
    """Rank r's ``x`` to rank r + hop (point to point; ``hop`` may be
    negative); a rank with no source receives zeros (``lax.ppermute``
    with the pairs (i, i + hop))."""
    n, r = group_size(group), worker_index(group)
    out = torch.zeros_like(x)
    x = x.contiguous()
    ops = []
    if 0 <= r + hop < n:
        ops.append(dist.P2POp(dist.isend, x,
                              dist.get_global_rank(group, r + hop), group))
    if 0 <= r - hop < n:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, r - hop), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Shift(torch.autograd.Function):
    """:func:`_shift` with autograd: the transpose of a shift by ``hop``
    is the shift by ``-hop`` (ranks past ``n - hop`` take zeros)."""

    @staticmethod
    def forward(ctx, x, hop, group):
        ctx.hop, ctx.group = hop, group
        return _shift(x, hop, group)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, -ctx.hop, ctx.group), None, None


def shift(x: torch.Tensor, hop: int, group,
          wire_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Model rank r's ``x`` arrives at rank r + hop, differentiable;
    ranks r < hop get zeros. ``wire_dtype`` rounds what crosses the
    wire (the ladder's bfloat16 wire), and the result is cast back."""
    if group_size(group) <= 1:
        return torch.zeros_like(x)
    if wire_dtype is None or wire_dtype == x.dtype:
        return _Shift.apply(x, hop, group)
    return _Shift.apply(x.to(wire_dtype), hop, group).to(x.dtype)
