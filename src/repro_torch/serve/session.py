"""Continuous-batching serve sessions over a fixed pool of decode slots
(port of ``repro/serve/session.py``).

  * ``submit(Request) -> handle`` claims a free slot (or queues). The
    pending queue is ordered by SLO class (``interactive`` > ``standard``
    > ``batch``) and arrival; under slot or page pressure a higher class
    preempts the lowest-class occupant (``preempt_mode="requeue"``
    recomputes it later with its own sampling stream, ``"kill"`` returns
    the partial generation).
  * ``step()`` runs one decode step over all slots - embedding, attention
    against each slot's own cache prefix, greedy or temperature sampling -
    as device work only: no per-token device-to-host transfer. Before it,
    at most one chunk of a pending prompt advances through
    ``model.decode_chunk`` (chunked prefill).
  * ``drain()`` steps until every request finished and returns
    ``{handle: Result}``. The host reads device state only at harvests
    (``stats["syncs"]``), O(requests), never O(tokens).

Admission, as the reference's: ``"chunked"`` (the dense family's
``"auto"``), ``"whole"`` (one ``Model.prefill`` over the prompt fills the
slot's fixed lane; prompts shorter than 2 tokens are injected) or
``"inject"`` (the prompt enters through the decode step, one token a
step, the step's logits discarded until the last prompt position).
Models with SSD mixers (mamba2, hymba) follow the SSD chunk rule: the
scan has no per-token validity, so a prompt is admitted chunked only
when ``prefill_chunk`` is a multiple of ``ssm.chunk`` and the prompt a
multiple of ``prefill_chunk``; else whole where the prompt tiles
``ssm.chunk`` (fixed lanes only); else injected. A slot's SSM state and
conv tail are zeroed (in place) when it is claimed.

On a CUDA device the decode step is one CUDA graph, the counterpart of
the reference's single jitted step: the first step of each kind (greedy,
sampling) runs eagerly as the warm-up, the next captures it, and every
later one replays it (``stats["captures"]``, ``stats["replays"]``; a
kernel's launch counter counts it once, at capture). Every state tensor
is written in place, by the step and by the host's admissions and
releases alike, so the graph always sees the live state. A capture that
fails raises. The CPU runs every step eagerly.

A mesh session (``decode_fn=`` a ``dist.serve.make_serve_step``
decode step) runs the same scheduler on every rank of a grid: each rank
holds its part of the cache (the step's ``init_cache``), while every
host-side control vector (slots, positions, current tokens, prompts,
sampling streams) is the global one, identical on every rank; the step
returns the whole batch's logits on every rank, so every rank picks the
same tokens. Mesh sessions admit by injection, and refuse a paged cache
and ``QuantizedParams`` with the reference's messages.

Sampling is the reference's, key for key: a request's key is
``fold_in(base_key, admission ordinal)`` (``base_key`` default
``PRNGKey(seed)``; ``reseed(key)`` restarts the ordinals), its first
token of a chunked or whole admission draws with ``split(key)[1]`` and
the slot keeps ``split(key)[0]``, an injected prompt stores the key
itself, and every sampling step splits each hot slot's key (in-prompt
steps too) and draws ``categorical`` with the second half
(``kernels.prng.categorical_step``, one kernel and its fold on the
card). Greedy and sampled tokens are the reference's for the same key
(a sampled token may differ only where the reference's top two scores
lie within float32 rounding of each other).

Differences from the reference, all inside the session: the cache is
updated in place (inactive slots' writes drop, where the reference
reverts them on fixed lanes and rewrites identical bytes on pages).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import threefry as TF
from repro_torch.kernels import prng
from repro_torch.perf import aot
from repro_torch.perf import cache as perf_cache
from repro_torch.serve.paged import PagePool
from repro_torch.serve.quantized import is_quantized, make_dequant_gather

SLO_PRIORITY = {"batch": 0, "standard": 1, "interactive": 2}


@dataclasses.dataclass
class Request:
    prompt: Sequence[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    slo: str = "standard"           # "interactive" | "standard" | "batch"


@dataclasses.dataclass
class Result:
    tokens: List[int]
    prompt_len: int
    handle: int = -1
    # "length" | "eos" | "cache_full" | "preempted"
    finish_reason: str = "length"


class ServeSession:
    """Slot-scheduled continuous-batching session.

    model: ``repro_torch.models.model.Model`` (token-input decoder LM).
    params: its parameter tree, on ``device``; may hold ``QuantizedLeaf``
        leaves from ``quantize_params`` (matmul leaves then run K1).
    slots: concurrent decode lanes; max_seq: per-slot cache length (a
        request needs ``len(prompt) + max_new_tokens - 1 <= max_seq``).
    paged: page pool + page tables (``page_size`` tokens per page,
        ``num_pages`` pages, default fixed-lane-equal memory); admission
        validates pages up front.
    prefill: "auto" (the reference's default: for the dense family it
        chooses chunked admission), "chunked" (``prefill_chunk`` prompt
        tokens per dispatch, interleaved with decode), "whole" (one
        ``Model.prefill`` of the prompt into the slot's fixed lane; fixed
        lanes only, a prompt shorter than 2 tokens is injected) or
        "inject" (the prompt through the decode step, one token a step).
        The first generated token of a chunked or whole admission is the
        greedy argmax of the last prompt position's logits, or, when
        sampling, a draw under the second half of the request key's
        split; an injected prompt's first token is the decode step's.
        A mesh session admits every prompt by injection.
    base_key: the sampling streams' base key (a (2,) threefry key, the
        reference's uint32 words or the port's int32 key); default
        ``PRNGKey(seed)``.
    decode_fn: a ``(params, inputs, cache, pos, write=) -> (logits,
        cache)`` step in place of ``model.decode_step``, e.g.
        ``dist.serve.make_serve_step(..., "decode")``'s, with ``params``
        this rank's model shards; where it has ``init_cache`` and
        ``rows`` (a ``dist.serve.ServeStep``), the session holds the
        rank's part of the cache they give.
    aot_dir: AOT artifact directory (``repro_torch.perf.aot``) for the
        kernel library the decode step launches, keyed on (model config,
        slots, max_seq, paged geometry, quantization, arg signature, card,
        sources). A warm dir loads it without ``nvcc`` or a link. ``stats``
        records ``compilations`` vs ``aot_loads`` (and ``aot_saves``); on
        the CPU they stay 0. The CUDA graph is still captured in each
        process.
    """

    def __init__(self, model, params, *, slots: int = 8, max_seq: int = 256,
                 eos_id: Optional[int] = None, base_key=None,
                 seed: int = 0, sync_interval: int = 8,
                 fused_matmul: bool = True, paged: bool = False,
                 page_size: int = 16, num_pages: Optional[int] = None, prefill: str = "auto",
                 prefill_chunk: int = 32, preempt_mode: str = "requeue",
                 device="cuda", decode_fn=None,
                 aot_dir: Optional[str] = None):
        cfg = model.cfg
        if cfg.input_mode != "tokens" or cfg.arch_type not in (
                "dense", "moe", "ssm", "hybrid"):
            raise ValueError("ServeSession serves token-input decoder LMs "
                             "(the port: the dense, MoE, SSM and hybrid "
                             "families)")
        self.model, self.cfg = model, cfg
        self.device = torch.device(device)
        self.slots, self.max_seq, self.eos_id = slots, max_seq, eos_id
        self.sync_interval = max(1, sync_interval)
        self.params = params
        self._local = decode_fn is None
        self._decode_fn = decode_fn
        self.paged = bool(paged)
        if self.paged:
            if not self._local:
                raise ValueError("paged sessions use the local decode path; "
                                 "mesh paged decode runs through "
                                 "dist.serve cache specs directly")
            if cfg.arch_type == "ssm":
                raise ValueError("pure-SSM models hold no KV cache to page")
            if max_seq % page_size:
                raise ValueError(f"max_seq={max_seq} must be a multiple of "
                                 f"page_size={page_size}")
            self.page_size = int(page_size)
            self.num_pages = int(num_pages if num_pages is not None
                                 else slots * (max_seq // page_size))
            self._pool = PagePool(self.num_pages, self.page_size)
        else:
            self.page_size = self.num_pages = 0
            self._pool = None
        if prefill not in ("auto", "chunked", "whole", "inject"):
            raise ValueError(f"unknown prefill mode {prefill!r}")
        if prefill == "whole" and self.paged:
            raise ValueError("whole-prompt prefill fills a dense lane; "
                             "paged sessions admit chunked (or inject)")
        self._prefill_mode = prefill
        self.prefill_chunk = max(1, int(prefill_chunk))
        if preempt_mode not in ("requeue", "kill"):
            raise ValueError(f"unknown preempt_mode {preempt_mode!r}")
        self.preempt_mode = preempt_mode
        if not self._local and is_quantized(params):
            raise ValueError("QuantizedParams require the local decode path;"
                             " a mesh decode_fn brings its own weight wire")
        self._gather = (make_dequant_gather(fused=fused_matmul)
                        if is_quantized(params) else None)
        self._state = self._init_state()
        self._graphs: Dict[bool, torch.cuda.CUDAGraph] = {}  # sample ->
        self._warm: set = set()         # step kinds run once eagerly
        self._base_key = TF.as_key(base_key if base_key is not None
                                   else TF.prng_key(seed), "ServeSession")
        self._hot: set = set()          # handles in slots with temp > 0
        self._slot_handle: List[Optional[int]] = [None] * slots
        self._slot_done_step = [0] * slots   # earliest possible finish
        self._slot_pages: List[Optional[List[int]]] = [None] * slots
        self._prefill_q: "collections.OrderedDict[int, dict]" = \
            collections.OrderedDict()   # slot -> chunked-admission progress
        self._pending: List[int] = []   # handles, (priority, arrival) order
        self._requests: Dict[int, Request] = {}
        self._req_key: Dict[int, torch.Tensor] = {}  # kept over preemption
        self._results: Dict[int, Result] = {}
        self._submit_t: Dict[int, float] = {}
        self.ttft_s: Dict[int, float] = {}  # submit -> first-token dispatch
        self._next_handle = 0
        self._admit_seq = 0
        self._steps = 0
        self.stats = {"dispatches": 0, "syncs": 0, "admitted": 0,
                      "compilations": 0, "aot_loads": 0, "aot_saves": 0,
                      "preemptions": 0, "chunk_dispatches": 0,
                      "max_inflight": 0, "captures": 0, "replays": 0}
        perf_cache.ensure_persistent_cache()   # opt-in via the env
        self._aot_dir = aot_dir if self._local else None
        facts = {"program": "serve_decode", "model_cfg": cfg,
                 "slots": slots, "max_seq": max_seq, "eos": eos_id,
                 "quantized": is_quantized(params),
                 "fused_matmul": fused_matmul, "paged": self.paged,
                 "page_size": self.page_size, "num_pages": self.num_pages,
                 "prefill": prefill, "prefill_chunk": self.prefill_chunk}
        aot.load_or_compile(self._dispatch, (params, self._state),
                            aot_dir=self._aot_dir, facts=facts,
                            stats=self.stats, device=self.device)

    # ------------------------------------------------------------------
    # device-side state and the programs that update it
    # ------------------------------------------------------------------

    def _init_state(self):
        B, S, dev = self.slots, self.max_seq, self.device
        pool = (self.num_pages, self.page_size) if self.paged else None
        make = getattr(self._decode_fn, "init_cache", None)
        if make is not None:
            cache = make(B, S, device=dev)
        else:
            cache = self.model.init_cache(B, max_seq_local=S, page_pool=pool,
                                          device=dev)

        def z(dt):
            return torch.zeros((B,), dtype=dt, device=dev)
        return dict(cache=cache, cur=z(torch.int32), pos=z(torch.int32),
                    plen=z(torch.int32), gen=z(torch.int32),
                    max_new=z(torch.int32), active=z(torch.bool),
                    temp=z(torch.float32),
                    rng=torch.zeros((B, 2), dtype=torch.int32, device=dev),
                    prompt=torch.zeros((B, S), dtype=torch.int32, device=dev),
                    out=torch.zeros((B, S), dtype=torch.int32, device=dev))

    def _to_dev(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    def _claim_cache(self, slot: int, ptab_row: Optional[np.ndarray]):
        """Slot reuse: per-slot attention masking already hides a previous
        occupant's rows, but the recurrent lanes (SSM state, conv tail)
        carry it on, so they are zeroed, in place; paged sessions install
        the slot's table row."""
        cache = self._state["cache"]
        rows = getattr(self._decode_fn, "rows", None)
        row = slot
        if rows is not None:        # this rank's rows of a mesh step
            mine = rows(self.slots)
            row = slot - mine.start if mine.start <= slot < mine.stop \
                else None
        for name in ("ssm", "conv"):
            if name in cache and row is not None:
                cache[name][:, row].zero_()
        if self.paged:
            self._state["cache"]["ptab"][slot] = self._to_dev(ptab_row,
                                                              torch.int32)

    def _stage(self, slot: int, ptab_row):
        """Claim a slot for chunked admission: inactive, ``pos = max_seq``
        so interleaved decode steps neither advance it nor write its
        cache while its chunks are in flight."""
        st = self._state
        st["active"][slot] = False
        st["pos"][slot] = self.max_seq
        st["gen"][slot] = 0
        self._claim_cache(slot, ptab_row)

    def _release(self, slot: int):
        """Free a slot: its decode writes drop from now on (paged: the
        RELEASED-sentinel table row), so recycled pages stay intact."""
        st = self._state
        st["active"][slot] = False
        st["pos"][slot] = self.max_seq
        if self.paged:
            st["cache"]["ptab"][slot] = self.num_pages

    def _first_token(self, slot: int, lg: torch.Tensor, plen: int,
                     max_new: int, temp: float, key: torch.Tensor):
        """Activate ``slot`` after its prompt of ``plen`` tokens filled
        the cache: the first generated token from the last prompt
        position's logits ``lg`` (V,), greedy, or when sampling the
        reference's draw (``split(key)``: draw with the second half, the
        slot keeps the first), chunked and whole admission alike."""
        st = self._state
        lgf = lg.to(torch.float32).reshape(1, -1)
        rng = key.to(self.device).reshape(1, 2).clone()   # drawn in place
        if temp > 0.0:
            t = torch.full((1,), temp, dtype=torch.float32,
                           device=self.device)
            _, t0 = prng.categorical_step(lgf, t, rng)
        else:
            t0 = torch.argmax(lgf, dim=-1).to(torch.int32)
        t0 = t0[0]
        st["cur"][slot] = t0
        st["pos"][slot] = plen
        st["plen"][slot] = plen
        st["gen"][slot] = 1
        st["out"][slot, 0] = t0
        st["max_new"][slot] = max_new
        done = torch.tensor(max_new <= 1, device=self.device)
        if self.eos_id is not None:
            done = done | (t0 == self.eos_id)
        st["active"][slot] = ~done
        st["temp"][slot] = temp
        st["rng"][slot] = rng[0]

    def _run_chunk(self, slot, tokens, start, nvalid, max_new, temp, key,
                   is_last):
        """One chunked-prefill dispatch for one slot; the final chunk
        also picks the first generated token (:meth:`_first_token`)."""
        cache = self._state["cache"]
        lane = {name: (t if name in ("pk", "pv") else
                       t[slot:slot + 1] if name == "ptab" else
                       t[:, slot:slot + 1])      # views: written in place
                for name, t in cache.items()}
        lg, _ = self.model.decode_chunk(
            self.params, {"token": self._to_dev(tokens[None], torch.int32)},
            lane, self._to_dev([start], torch.int32),
            self._to_dev([nvalid], torch.int32), self._gather)
        if is_last:
            self._first_token(slot, lg[0], start + nvalid, max_new, temp, key)

    def _prefill_whole(self, slot: int, prompt: np.ndarray, max_new: int,
                       temp: float, key: torch.Tensor):
        """Whole-prompt admission: one ``Model.prefill`` over the prompt
        writes the slot's fixed lanes (zeros past the prompt, as the
        reference's padded cache; the SSM state and conv tail at the
        prompt's end), then the first token."""
        st = self._state
        plen = len(prompt)
        toks = self._to_dev(prompt[None], torch.int32)
        lg, lane = self.model.prefill(self.params, {"tokens": toks},
                                      max_seq_local=self.max_seq,
                                      gather=self._gather)
        for name, t in lane.items():
            st["cache"][name][:, slot].copy_(t[:, 0])
        self._write_prompt(slot, prompt)
        self._first_token(slot, lg[0, plen - 1], plen, max_new, temp, key)

    def _write_prompt(self, slot: int, prompt: np.ndarray):
        row = np.zeros((self.max_seq,), np.int32)
        row[:len(prompt)] = prompt
        self._state["prompt"][slot] = self._to_dev(row, torch.int32)

    def _inject(self, slot: int, prompt: np.ndarray, max_new: int,
                temp: float, key: torch.Tensor, ptab_row):
        """Injected admission: the slot starts active at position 0 on
        its first prompt token; the decode step feeds the rest of the
        prompt and emits from the last prompt position on."""
        st = self._state
        self._write_prompt(slot, prompt)
        st["cur"][slot] = int(prompt[0])
        st["pos"][slot] = 0
        st["plen"][slot] = len(prompt)
        st["gen"][slot] = 0
        st["max_new"][slot] = max_new
        st["active"][slot] = True
        st["temp"][slot] = temp
        st["rng"][slot] = key.to(self.device)
        self._claim_cache(slot, ptab_row)

    def _decode(self, sample: bool):
        """One decode step over all slots, on the device only, every
        state tensor written in place (a CUDA graph of this step replays
        against the tensors it captured). A slot still inside its
        injected prompt feeds its next prompt token and emits nothing;
        inactive slots' cache writes drop."""
        st, S, eos = self._state, self.max_seq, self.eos_id
        B = self.slots
        active, pos = st["active"], st["pos"]
        inputs = {"token": st["cur"][:, None]}
        if self._local:
            logits, _ = self.model.decode_step(
                self.params, inputs, st["cache"], pos, self._gather,
                write=active)
        else:
            logits, _ = self._decode_fn(self.params, inputs, st["cache"],
                                        pos, write=active)
        logits = logits.to(torch.float32)
        if sample:       # every hot slot's key advances, as the reference's
            greedy, sampled = prng.categorical_step(logits, st["temp"],
                                                    st["rng"])
            tok = torch.where(st["temp"] > 0.0, sampled, greedy)
        else:
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        nxt = pos + 1
        in_prompt = nxt < st["plen"]
        emit = active & ~in_prompt                 # tok was generated
        prompt_next = torch.gather(
            st["prompt"], 1, torch.clamp(nxt, 0, S - 1).long()[:, None])[:, 0]
        rows = torch.arange(B, device=self.device)
        gidx = torch.clamp(st["gen"], 0, S - 1).long()
        st["out"][rows, gidx] = torch.where(emit, tok, st["out"][rows, gidx])
        gen = st["gen"] + emit.to(torch.int32)
        done = emit & (gen >= st["max_new"])
        if eos is not None:
            done = done | (emit & (tok == eos))
        done = done | (active & (nxt >= S))        # cache full
        alive = active & ~done
        cur = torch.where(alive, torch.where(in_prompt, prompt_next, tok),
                          st["cur"])
        new_pos = torch.where(alive, torch.clamp_max(nxt, S - 1), pos)
        st["cur"].copy_(cur)
        st["pos"].copy_(new_pos)
        st["gen"].copy_(gen)
        st["active"].copy_(alive)

    def _state_tensors(self) -> List[Tuple[str, torch.Tensor]]:
        return ([(k, v) for k, v in self._state.items() if k != "cache"]
                + [("cache." + k, v) for k, v in self._state["cache"].items()])

    def _capture(self, sample: bool) -> torch.cuda.CUDAGraph:
        """Capture one decode step of this kind as a CUDA graph (which
        executes nothing). Raises if the capture fails or the step left
        a state tensor other than the one it was given."""
        before = self._state_tensors()
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                self._decode(sample)
        except Exception as e:
            raise RuntimeError(f"capturing the decode step (sample={sample}) "
                               f"as a CUDA graph failed: {e}") from e
        now = dict(self._state_tensors())
        moved = [k for k, t in before if now.get(k) is not t]
        if moved:
            raise RuntimeError(f"the decode step replaced the state tensors "
                               f"{moved}; a CUDA graph of it would replay "
                               "against the old ones")
        self.stats["captures"] += 1
        return graph

    def _dispatch(self, sample: bool):
        """One decode step: eager on the CPU and for each kind's first
        step on CUDA, then one capture, then replays."""
        if self.device.type != "cuda" or sample not in self._warm:
            self._decode(sample)
            self._warm.add(sample)
            return
        graph = self._graphs.get(sample)
        if graph is None:
            graph = self._graphs[sample] = self._capture(sample)
        graph.replay()
        self.stats["replays"] += 1

    # ------------------------------------------------------------------
    # scheduler API (host logic, as the reference's)
    # ------------------------------------------------------------------

    @property
    def free_slots(self) -> int:
        return sum(h is None for h in self._slot_handle)

    @property
    def inflight(self) -> int:
        return sum(h is not None for h in self._slot_handle)

    @property
    def queued(self) -> int:
        return len(self._pending)

    @property
    def free_pages(self) -> int:
        return self._pool.free_pages if self.paged else 0

    def _request_pages(self, req: Request) -> int:
        # cache rows written: prompt + all generated tokens but the last
        return self._pool.pages_for(len(req.prompt) + req.max_new_tokens - 1)

    def submit(self, req: Request) -> int:
        """Queue a request; returns its handle. Claims a free slot at once
        when one is available (preempting a lower SLO class under slot or
        page pressure)."""
        plen = len(req.prompt)
        if plen < 1:
            raise ValueError("empty prompt")
        if req.slo not in SLO_PRIORITY:
            raise ValueError(f"unknown SLO class {req.slo!r}; expected one "
                             f"of {sorted(SLO_PRIORITY)}")
        if plen + req.max_new_tokens - 1 > self.max_seq:
            raise ValueError(
                f"prompt_len={plen} + max_new={req.max_new_tokens} - 1 "
                f"exceeds max_seq={self.max_seq}")
        if self.paged and self._request_pages(req) > self.num_pages:
            raise ValueError(
                f"request needs {self._request_pages(req)} pages; the pool "
                f"holds {self.num_pages}")
        h = self._next_handle
        self._next_handle += 1
        self._requests[h] = req
        # keyed on the submission ordinal since the last (re)seed; the key
        # survives preemption, so a requeued request replays its draws
        self._req_key[h] = TF.fold_in(self._base_key, self._admit_seq)
        self._admit_seq += 1
        self._submit_t[h] = time.perf_counter()
        self._enqueue(h)
        self._schedule()
        return h

    def _enqueue(self, h: int):
        """Insert into the pending queue ordered by (SLO class desc,
        arrival asc)."""
        keyf = lambda hh: (-SLO_PRIORITY[self._requests[hh].slo], hh)
        me = keyf(h)
        lo = 0
        while lo < len(self._pending) and keyf(self._pending[lo]) < me:
            lo += 1
        self._pending.insert(lo, h)

    def _schedule(self, allow_harvest: bool = True):
        """Admit from the head of the queue while resources allow; under
        pressure collect finished slots first, then preempt strictly
        lower-SLO occupants."""
        while self._pending:
            h = self._pending[0]
            req = self._requests[h]
            if self._try_admit(h, req):
                self._pending.pop(0)
                continue
            if allow_harvest and self.inflight:
                allow_harvest = False
                if self._collect_finished():
                    continue
            if not self._try_preempt_for(req):
                break

    def _try_admit(self, handle: int, req: Request) -> bool:
        free = [s for s, owner in enumerate(self._slot_handle)
                if owner is None]
        if not free:
            return False
        pages = None
        if self.paged:
            pages = self._pool.alloc(self._request_pages(req))
            if pages is None:
                return False
        self._admit(free[0], handle, req, pages)
        return True

    def _try_preempt_for(self, req: Request) -> bool:
        """Reclaim slot and pages from the lowest-SLO, most recently
        admitted occupant strictly below ``req``'s class."""
        pr = SLO_PRIORITY[req.slo]
        victims = [(SLO_PRIORITY[self._requests[h].slo], -h, s)
                   for s, h in enumerate(self._slot_handle)
                   if h is not None and h in self._requests
                   and SLO_PRIORITY[self._requests[h].slo] < pr]
        if not victims:
            return False
        if self.paged:
            reclaim = sum(len(self._slot_pages[s] or ())
                          for _, _, s in victims)
            if self._pool.free_pages + reclaim < self._request_pages(req):
                return False
        victims.sort()
        self._preempt(victims[0][2])
        return True

    def _preempt(self, slot: int):
        h = self._slot_handle[slot]
        self.stats["preemptions"] += 1
        if self.preempt_mode == "kill":
            req = self._requests.pop(h)
            tokens: List[int] = []
            if slot not in self._prefill_q:
                snap = self._sync()
                tokens = [int(t) for t in snap["out"][slot, :int(snap["gen"][slot])]]
            self._results[h] = Result(tokens=tokens, prompt_len=len(req.prompt),
                                      handle=h, finish_reason="preempted")
            self._req_key.pop(h, None)
        else:
            # requeue-and-recompute, at the head of its SLO class
            self._enqueue(h)
        self._free_slot(slot, release=True)

    def _free_slot(self, slot: int, release: bool):
        h = self._slot_handle[slot]
        self._slot_handle[slot] = None
        self._slot_done_step[slot] = 0
        self._prefill_q.pop(slot, None)
        self._hot.discard(h)
        if self.paged and self._slot_pages[slot] is not None:
            self._pool.free(self._slot_pages[slot])
            self._slot_pages[slot] = None
        if release:
            self._release(slot)

    def _admit(self, slot: int, handle: int, req: Request,
               pages: Optional[List[int]]):
        plen = len(req.prompt)
        key = self._req_key[handle]
        ptab_row = None
        if self.paged:
            ptab_row = np.full((self.max_seq // self.page_size,),
                               self.num_pages, np.int32)
            ptab_row[:len(pages)] = pages
            self._slot_pages[slot] = pages
        self._slot_handle[slot] = handle
        prompt = np.asarray(req.prompt, np.int32)
        mode = self._admission_mode(plen)
        if mode == "whole":
            self._prefill_whole(slot, prompt, req.max_new_tokens,
                                req.temperature, key)
            self._finalize_admission(slot, handle, req,
                                     remaining=req.max_new_tokens - 1)
        elif mode == "chunked":
            self._stage(slot, ptab_row)
            self._prefill_q[slot] = dict(
                handle=handle, tokens=prompt, next=0, plen=plen,
                max_new=req.max_new_tokens, temp=req.temperature, key=key)
            nchunks = -(-plen // self.prefill_chunk)
            # provisional bound until the final chunk lands
            self._slot_done_step[slot] = (self._steps + nchunks
                                          + req.max_new_tokens)
            self._advance_prefill()    # first chunk goes out at once
        else:
            self._inject(slot, prompt, req.max_new_tokens, req.temperature,
                         key, ptab_row)
            self._finalize_admission(slot, handle, req,
                                     remaining=plen + req.max_new_tokens - 1)
        self.stats["admitted"] += 1
        self.stats["max_inflight"] = max(self.stats["max_inflight"],
                                         self.inflight)

    def _can_prefill_whole(self, plen: int) -> bool:
        if not self._local or plen < 2:
            return False
        if self.cfg.arch_type in ("ssm", "hybrid"):
            # the SSD chunked scan needs the sequence to tile its chunk
            return plen % self.cfg.ssm.chunk == 0
        return True

    def _admission_mode(self, plen: int) -> str:
        """The reference's choice for a local session: chunked unless
        asked otherwise; whole falls back to inject below 2 prompt
        tokens. With SSD mixers every dispatched chunk must be full and
        a multiple of the SSD chunk, else whole where the prompt tiles
        the SSD chunk (fixed lanes), else inject. A mesh session injects
        every prompt."""
        if self._prefill_mode == "inject" or not self._local:
            return "inject"
        if self._prefill_mode == "whole":
            return "whole" if self._can_prefill_whole(plen) else "inject"
        if self.cfg.arch_type in ("ssm", "hybrid"):
            c = self.prefill_chunk
            if c % self.cfg.ssm.chunk == 0 and plen % c == 0:
                return "chunked"
            if not self.paged and self._can_prefill_whole(plen):
                return "whole"
            return "inject"
        return "chunked"

    def _finalize_admission(self, slot: int, handle: int, req: Request,
                            remaining: int):
        self._slot_done_step[slot] = self._steps + remaining
        if req.temperature > 0:
            self._hot.add(handle)
        if handle not in self.ttft_s and handle in self._submit_t:
            self.ttft_s[handle] = time.perf_counter() - self._submit_t[handle]

    def _advance_prefill(self):
        """Dispatch ONE prompt chunk for the oldest mid-prefill slot."""
        if not self._prefill_q:
            return
        slot, pp = next(iter(self._prefill_q.items()))
        c = self.prefill_chunk
        lo = pp["next"]
        hi = min(lo + c, pp["plen"])
        tok = np.zeros((c,), np.int32)
        tok[:hi - lo] = pp["tokens"][lo:hi]
        is_last = hi >= pp["plen"]
        self._run_chunk(slot, tok, lo, hi - lo, pp["max_new"], pp["temp"],
                        pp["key"], is_last)
        pp["next"] = hi
        self.stats["chunk_dispatches"] += 1
        if is_last:
            del self._prefill_q[slot]
            h = pp["handle"]
            self._finalize_admission(slot, h, self._requests[h],
                                     remaining=max(0, pp["max_new"] - 1))

    def step(self):
        """One decode step for every slot, preceded by at most one
        chunked-prefill dispatch. While requests are queued, finished
        slots are harvested as soon as one can have finished."""
        self._advance_prefill()
        self._dispatch(sample=bool(self._hot))
        self.stats["dispatches"] += 1
        self._steps += 1
        if self._pending:
            bound = min((self._slot_done_step[s]
                         for s, h in enumerate(self._slot_handle)
                         if h is not None), default=0)
            if self._steps >= bound or (
                    self.eos_id is not None
                    and self._steps % self.sync_interval == 0):
                self.harvest()

    def _sync(self) -> Dict[str, np.ndarray]:
        self.stats["syncs"] += 1
        return {k: self._state[k].cpu().numpy()
                for k in ("active", "gen", "plen", "out")}

    def harvest(self) -> List[int]:
        """Collect finished slots into results, free them (pages back to
        the pool), and admit queued requests."""
        finished = self._collect_finished()
        self._schedule(allow_harvest=False)
        return finished

    def _collect_finished(self) -> List[int]:
        snap = self._sync()
        finished = []
        for s in range(self.slots):
            h = self._slot_handle[s]
            if h is None or snap["active"][s] or s in self._prefill_q:
                continue
            n = int(snap["gen"][s])
            req = self._requests.pop(h)
            reason = "length"
            if n < req.max_new_tokens:
                reason = ("eos" if self.eos_id is not None and n > 0
                          and int(snap["out"][s, n - 1]) == self.eos_id
                          else "cache_full")
            self._results[h] = Result(
                tokens=[int(t) for t in snap["out"][s, :n]],
                prompt_len=int(snap["plen"][s]), handle=h,
                finish_reason=reason)
            self._req_key.pop(h, None)
            self._free_slot(s, release=self.paged)
            finished.append(h)
        return finished

    def drain(self, max_steps: Optional[int] = None) -> Dict[int, Result]:
        """Step until every submitted request has finished; returns the
        results not yet delivered as ``{handle: Result}``."""
        outstanding = self.inflight + self.queued
        budget = (max_steps if max_steps is not None
                  else (outstanding + self.slots) * 2 * self.max_seq
                  + self.max_seq)
        while self.inflight or self._pending:
            if budget <= 0:
                raise RuntimeError("drain exceeded its step budget")
            if self._prefill_q:
                # one chunk advances per step: burst through the chunks
                burst = sum(-(-(pp["plen"] - pp["next"])
                              // self.prefill_chunk) or 1
                            for pp in self._prefill_q.values())
            elif self._pending:
                burst = 8
            elif self.eos_id is not None:
                burst = self.sync_interval
            else:
                # no EOS: slots finish exactly at their known bound
                nxt = min(self._slot_done_step[s]
                          for s, h in enumerate(self._slot_handle)
                          if h is not None)
                burst = max(1, nxt - self._steps)
            burst = min(burst, budget)
            for _ in range(burst):
                self.step()
            budget -= burst
            if not self._pending:
                self.harvest()
        out, self._results = self._results, {}
        return out

    def reseed(self, key):
        """Set the base sampling key (a (2,) threefry key) for requests
        submitted from now on, restarting the per-submission key
        sequence."""
        self._base_key = TF.as_key(key, "ServeSession")
        self._admit_seq = 0

    def result(self, handle: int) -> Optional[Result]:
        """Pop a finished request's result (None while still running)."""
        return self._results.pop(handle, None)
