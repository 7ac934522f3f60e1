"""Sharded serving step (port of ``repro/dist/serve.py``).

The weights stay model-axis shards (``dist.sharding``'s layout) and are
gathered each step, whole leaves in one pass, as float32 or as int8 Q_x
codes (``ServeConfig.weight_k``: K3, K4 and K12 on the card, one scale a
shard across all the layers of a leaf). The KV cache is split along the
sequence over the model axis and along the batch over the worker axes;
a page pool along its page axis over the model axis (every shard holds
the whole page table of its worker's slots, in global page ids); the
SSM state and conv tail along the batch only (every model shard runs
the same recurrence); an encoder-decoder's cross caches along the
frames over the model axis.

Where the reference's ``shard_map`` takes global arrays and cuts them
by ``PartitionSpec``, a rank here holds its own parts: its model shard
of the parameters and its part of the cache (``ServeStep.shard_params``,
``shard_cache`` and ``init_cache`` cut or make them; ``gather_cache``
puts a cache back together). The inputs, positions and write masks a
step takes are the global ones, identical on every rank, and a decode
step returns the whole (B, V) logits on every rank (the reference's
``out_specs=P(b0, None)``: an all-gather over the worker group), so a
session's host-side control vectors stay global and every rank picks
the same tokens.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from repro_torch.dist import collectives as C
from repro_torch.dist import sharding as SH
from repro_torch.dist.step import ServeConfig, _make_param_gather
from repro_torch.launch.mesh import Grid
from repro_torch.models import layers as L
from repro_torch.tree import tree_map

__all__ = ["ServeConfig", "Split", "ServeStep", "make_serve_step",
           "_cache_specs_for"]


class Split(NamedTuple):
    """How a tensor is cut over the grid (the port's ``PartitionSpec``):
    ``worker`` the dim the worker axes split (the batch), ``model`` the
    dim the model axis splits; None: whole."""

    worker: Optional[int] = None
    model: Optional[int] = None


def _cache_specs_for(cfg, b0) -> Dict[str, Split]:
    """Each cache leaf's :class:`Split`, one to one with the reference's
    ``PartitionSpec``s; ``b0`` truthy: the batch splits over the worker
    axes. ``k``/``v`` (layers, B, S, K, hd): the sequence over the model
    axis; ``pk``/``pv`` (layers, P, ps, K, hd): the pages over the model
    axis (``num_pages % Nm == 0``); ``ptab`` (B, npag): the batch only;
    ``ssm``/``conv``: the batch only; ``ck``/``cv`` (layers, B, Sa, K,
    hd): the frames over the model axis."""
    w = 1 if b0 else None
    specs = {}
    if cfg.arch_type != "ssm":
        specs["k"] = specs["v"] = Split(w, 2)
        specs["pk"] = specs["pv"] = Split(None, 1)
        specs["ptab"] = Split(0 if b0 else None, None)
    if cfg.arch_type in ("ssm", "hybrid"):
        specs["ssm"] = specs["conv"] = Split(w, None)
    if cfg.arch_type == "encdec":
        specs["ck"] = specs["cv"] = Split(w, 2)
    return specs


def _part(x: torch.Tensor, dim: Optional[int], n: int, index: int
          ) -> torch.Tensor:
    """Part ``index`` of ``n`` of x along ``dim`` (a view; x whole when
    ``dim`` is None or n is 1)."""
    if dim is None or n <= 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"into {n} parts")
    size = x.shape[dim] // n
    return x.narrow(dim, index * size, size)


class ServeStep:
    """A rank's sharded serving step over a grid (``make_serve_step``).

    kind "decode": ``step(params, inputs, cache, pos, write=None) ->
    (logits (B, V), cache)``: this rank's model shard of the parameters
    and part of the cache, the global inputs ({"token": (B, 1)} or
    {"embeds": (B, 1, d)}), position (scalar or (B,)) and write mask
    ((B,) bool: ``Model.decode_step``'s); the cache is updated in place
    and the logits are the whole batch's on every rank.

    kind "prefill": ``step(params, batch) -> (logits (B, S, V), cache)``
    through ``Model.prefill`` over the global batch: its rows split over
    the workers where B divides by their number, its sequence over the
    model shards where S divides by theirs (the reference's
    ``_batch_geometry``); the logits and the cache (``k``, ``v``,
    ``ssm``, ``conv``) are returned whole on every rank."""

    def __init__(self, model, grid, sc: ServeConfig, kind: str):
        cfg = model.cfg
        if not isinstance(grid, Grid):
            grid = Grid.of_group(grid)
        self.model, self.grid, self.config, self.kind = model, grid, sc, kind
        self.worker_axes, self.wsizes, self.n_workers = SH.worker_info(
            grid, sc.worker_axes)
        self.worker_index = grid.index_over(self.worker_axes)
        self.workers = grid.group(self.worker_axes)
        self.n_shards, self.shard = grid.n_shards, grid.model_index
        Nm = self.n_shards
        self.layout = SH.build_layout(
            model.init(device="meta"), Nm)
        self.param_specs = self.layout.shard_axes()
        self.batch_sharded = bool(sc.batch_dim_shardable and
                                  self.worker_axes)
        b0 = self.worker_axes if self.batch_sharded else None
        self.input_specs = {"token": Split(0 if b0 else None, None),
                            "embeds": Split(0 if b0 else None, None)}
        self.cache_specs = _cache_specs_for(cfg, b0)

        def gather(expert_local):
            return _make_param_gather(
                self.layout, Nm, grid.model, expert_local=expert_local,
                quant_k=sc.weight_k, quant_absolute=sc.weight_absolute,
                stacked_at_static=True)
        self.ctx = L.ShardCtx(cp_group=grid.model if Nm > 1 else None,
                              cp_size=Nm, cp_rank=self.shard,
                              param_gather=gather(Nm > 1))
        if kind == "prefill":
            if cfg.arch_type == "encdec":
                raise NotImplementedError(
                    "enc-dec prefill goes through prefill_encoder + decode")
            self.cache_specs = {k: v for k, v in self.cache_specs.items()
                                if k in ("k", "v", "ssm", "conv")}
            # a sequence that stays whole: experts gathered like any leaf
            self._whole_ctx = L.ShardCtx(param_gather=gather(False))
        elif kind != "decode":
            raise ValueError(f"unknown serve kind {kind!r}")

    # ---------------- the rank's parts ----------------
    def rows(self, batch_size: int) -> slice:
        """This rank's rows of a global batch (all of them where the
        batch does not split)."""
        if not self.batch_sharded or self.n_workers == 1:
            return slice(0, batch_size)
        if batch_size % self.n_workers:
            raise ValueError(f"a batch of {batch_size} does not split over "
                             f"{self.n_workers} workers")
        b = batch_size // self.n_workers
        return slice(self.worker_index * b, (self.worker_index + 1) * b)

    def shard_params(self, params):
        """This rank's model shard of a whole parameter tree (float
        leaves), each leaf contiguous (a leaf that is whole on every
        shard and already contiguous is the leaf itself)."""
        return tree_map(
            lambda p, d, s: SH.shard_of(p, d, s, self.n_shards,
                                        self.shard).contiguous(),
            params, self.layout.dims, self.layout.stacked)

    def _cut(self, name: str, x: torch.Tensor) -> torch.Tensor:
        spec = self.cache_specs[name]
        if spec.worker is not None and self.n_workers > 1:
            r = self.rows(x.shape[spec.worker])
            x = x.narrow(spec.worker, r.start, r.stop - r.start)
        return _part(x, spec.model, self.n_shards, self.shard)

    def shard_cache(self, cache: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """This rank's part of a global cache (``Model.init_cache``'s
        layout), each leaf a contiguous copy."""
        return {k: self._cut(k, v).clone(memory_format=torch.contiguous_format)
                for k, v in cache.items()}

    def init_cache(self, batch_size: int, max_seq: int, dtype=None,
                   page_pool=None, device="cuda", encoder_seq: int = 0
                   ) -> Dict[str, torch.Tensor]:
        """This rank's part of ``model.init_cache(batch_size, max_seq,
        page_pool=page_pool, encoder_seq_local=encoder_seq)``, made at
        its own size: the page table's RELEASED sentinel stays the
        global ``num_pages``."""
        whole = self.model.init_cache(batch_size, max_seq, dtype=dtype,
                                      page_pool=page_pool, device="meta",
                                      encoder_seq_local=encoder_seq)
        out = {}
        for name, t in whole.items():
            shape = self._cut(name, t).shape
            if name == "ptab":
                out[name] = torch.full(shape, page_pool[0], dtype=t.dtype,
                                       device=device)
            else:
                out[name] = torch.zeros(shape, dtype=t.dtype, device=device)
        return out

    def gather_cache(self, cache: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        """The global cache from every rank's part (all-gathers over the
        model group and the worker group); the inverse of
        :meth:`shard_cache`."""
        out = {}
        for name, t in cache.items():
            spec = self.cache_specs[name]
            if spec.model is not None and self.n_shards > 1:
                t = C.gather_shard(t, spec.model, self.n_shards,
                                   self.grid.model)
            if spec.worker is not None and self.n_workers > 1:
                t = C.gather_shard(t, spec.worker, self.n_workers,
                                   self.workers)
            out[name] = t
        return out

    def _gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The whole batch of a (B_loc, ...) result, rows in worker
        order."""
        if not self.batch_sharded or self.n_workers == 1:
            return x
        return C.gather_shard(x, 0, self.n_workers, self.workers)

    # ---------------- the steps ----------------
    def __call__(self, *args, **kw):
        if self.kind == "decode":
            return self.decode(*args, **kw)
        return self.prefill(*args, **kw)

    def decode(self, params, inputs, cache, pos, write=None):
        B = next(iter(inputs.values())).shape[0]
        r = self.rows(B)
        dev = cache[next(iter(cache))].device
        pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
        if pos.dim() == 1:
            pos = pos[r]
        logits, cache = self.model.decode_step(
            params, {k: v[r] for k, v in inputs.items()}, cache, pos,
            write=None if write is None else write[r], ctx=self.ctx)
        return self._gather_rows(logits), cache

    def prefill(self, params, batch):
        x = batch["tokens" if "tokens" in batch else "embeds"]
        B, S = x.shape[:2]
        Nm = self.n_shards
        split = self.batch_sharded and B % self.n_workers == 0
        cp = Nm > 1 and S % Nm == 0
        mine = {}
        for k, v in batch.items():
            if split and self.n_workers > 1:
                v = v[self.rows(B)]
            if cp and v.dim() >= 2:
                v = _part(v, 1, Nm, self.shard)
            mine[k] = v
        S_loc = S // Nm if cp else S
        logits, cache = self.model.prefill(
            params, mine, max_seq_local=S_loc,
            ctx=self.ctx if cp else self._whole_ctx)
        if cp:
            logits = C.gather_shard(logits, 1, Nm, self.grid.model)
            cache = {k: (C.gather_shard(v, 2, Nm, self.grid.model)
                         if k in ("k", "v") else v)
                     for k, v in cache.items()}
        if split:
            logits = self._gather_rows(logits)
            cache = {k: (C.gather_shard(v, 1, self.n_workers, self.workers)
                         if self.n_workers > 1 else v)
                     for k, v in cache.items()}
        return logits, cache

    def prefill_encoder(self, params, audio, cache):
        """An encoder-decoder's cross caches (``Model.prefill_encoder``
        under the step's context): ``audio`` (B, Sa, d) is the global
        batch's frames; this rank runs the encoder over its worker's rows
        and its shard's frames and fills its part of ``ck``/``cv``."""
        if self.kind != "decode":
            raise ValueError("prefill_encoder fills a decode step's cache")
        a = audio[self.rows(audio.shape[0])]
        a = _part(a, 1, self.n_shards, self.shard)
        return self.model.prefill_encoder(params, a, cache, ctx=self.ctx)


def make_serve_step(model, grid, sc: ServeConfig, kind: str = "decode"):
    """The sharded serving step of ``kind`` ("decode" or "prefill") over
    ``grid`` (``launch.mesh.make_grid``, or a plain process group: its
    ranks the workers, one model shard). Returns ``(step, param_specs,
    (input_specs, cache_specs))`` as the reference: ``step`` a
    :class:`ServeStep`; ``param_specs`` each leaf's ``(axis, n_shards)``
    (``Layout.shard_axes``); the inputs' and the cache leaves'
    :class:`Split`. The kernels' implementation follows the tensors'
    device."""
    step = ServeStep(model, grid, sc, kind)
    return step, step.param_specs, (step.input_specs, step.cache_specs)
