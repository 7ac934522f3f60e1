"""Launch-geometry tuning of the port's kernels on the card, and the
exchange bucket sweep (port of ``repro/perf/autotune.py``).

The reference tunes its Pallas tiles (``enc_rows``, ``mm_cols``), TPU
knobs with no counterpart here (``comm/matmul.py`` says so). The port
tunes values its kernels take at run time and that leave their outputs'
contract as it is:

  * :func:`tune_enc_rows` - K7, #5 and K6's blocks an SM
    (``comm.kernels.set_enc_rows``): the warps walk the chunks with a
    grid stride, so every value writes the same bits;
  * :func:`tune_mm_cols` - K1's tensor-core plan at one ``(m, k, n,
    k_x)``: ``TC_TILE_N`` times K-slice counts around ``k1_plan``'s
    choice (``comm.matmul.set_mm_cols``). Another slice count sums in
    another fp32 order, so a tuned K1 is held to K1's tolerance;
  * :func:`tune_exchange_buckets` - ``TrainConfig.exchange_bucket_bytes``
    against the step's device time (CUDA events a step), one size on
    every rank (:func:`agree_on_bucket`).

The kernel tuners time CUDA graphs of repeated launches with CUDA events
and raise without a card: there is nothing to time on the CPU. Each
keeps the reference's return dict and restores the previous setting
unless ``install``. Tune before any graph capture: a captured graph
keeps the geometry it was captured with.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.comm import codec as CD
from repro_torch.comm import kernels as K
from repro_torch.comm import matmul as MM

CANDIDATE_ROWS = (1, 2, 4, 8, 16)     # blocks an SM
CANDIDATE_COLS = MM.TC_TILE_N         # K1's output columns a block
# exchange-bucket sweep: one pass after the backward, 1 MiB, the 4 MiB
# default, 16 MiB. The config's current value always joins the sweep.
CANDIDATE_BUCKETS = (0, 1 << 20, 4 << 20, 16 << 20)


def _card(device=None) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("the tuners time kernels on a CUDA device; "
                           "none is present")
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        raise RuntimeError(f"the tuners time kernels on a CUDA device, "
                           f"not {device}")
    return device


def graph_seconds(fn, reps: int = 20, replays: int = 5) -> float:
    """Seconds a call of ``fn`` takes on the card: ``reps`` calls
    captured in one CUDA graph (after an eager warm-up), the graph
    replayed ``replays`` times between CUDA events."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    end.synchronize()
    del g
    return start.elapsed_time(end) / 1e3 / (replays * reps)


def _time_roundtrip(spec: str, numel: int, iters: int, device) -> float:
    codec = CD.get_codec(spec)
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(numel, generator=gen, device=device)
    scales = torch.ones(1, dtype=torch.float32, device=device)
    from repro_torch.opt import grids
    if codec.kind == "log":          # the tables, outside the capture
        grids.log_table_on(codec.k, device)
        grids.log_grid_on(device)

    def roundtrip():
        payload, _ = K.encode_rows(x, codec, 1)
        K.decode_rows(payload, scales, codec, numel)
    return graph_seconds(roundtrip, reps=max(1, iters))


def tune_enc_rows(spec: str = "log:6", *, numel: int = 1 << 18,
                  iters: int = 3,
                  candidates: Sequence[int] = CANDIDATE_ROWS,
                  backend: Optional[str] = None,
                  install: bool = True, device=None) -> dict:
    """Time a #5 encode + K6 decode round trip per candidate blocks an
    SM. Returns ``{"timings_s": {blocks: seconds}, "best": blocks,
    "installed": bool}``; with ``install=True`` the best value is left
    installed (otherwise the previous override is restored)."""
    device = _card(device)
    key = backend or "cuda"
    prev = K._ENC_ROWS_OVERRIDE.get(key)
    timings = {}
    try:
        for rows in candidates:
            K.set_enc_rows(rows, backend=key)
            timings[rows] = _time_roundtrip(spec, numel, iters, device)
    finally:
        K.set_enc_rows(prev, backend=key)
    best = min(timings, key=timings.get)
    if install:
        K.set_enc_rows(best, backend=key)
    return {"timings_s": timings, "best": best, "installed": install}


def k1_operands(m: int, k: int, n: int, k_x: int, device, seed: int = 0):
    """bf16 activations (m, k) and int8/int16 Q_x codes (k, n) of a
    random weight, with their scale: K1's tensor-core operands."""
    from repro_torch.opt import engine
    gen = torch.Generator(device=device).manual_seed(seed)
    w = torch.randn((k, n), generator=gen, device=device) * 0.02
    codes, scale = engine.quantize_uniform(w, k_x, absolute=False)
    x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
    return x, codes, scale


def slice_candidates(m: int, k: int, n: int, code_bits: int) -> list:
    """K-slice counts around ``k1_plan``'s choice s: 1, s/2, s, 2s, 4s
    (the distinct counts K's 32-row units allow)."""
    s = MM.k1_plan(m, k, n, code_bits).grid[2]
    units = -(-k // MM.TC_SLICE_ROWS)
    out = []
    for c in (1, s // 2, s, 2 * s, 4 * s):
        c = max(1, min(c, units, MM.TC_MAX_SLICES))
        per = -(-units // c)
        c = -(-units // per)
        if c not in out:
            out.append(c)
    return sorted(out)


def tune_mm_cols(*, m: int = 4, k: int = 1 << 12, n: int = 11008,
                 k_x: int = 6, iters: int = 20,
                 candidates: Sequence[int] = CANDIDATE_COLS,
                 slices: Optional[Sequence[int]] = None,
                 install: bool = True, device=None) -> dict:
    """Time K1 on tensor cores (bf16 activations against int8/int16 Q_x
    codes) per candidate plan, ``tile_n`` in ``candidates`` times the
    K-slice counts of :func:`slice_candidates` (or ``slices``), and
    install the winner for this ``(m, k, n, k_x)`` via
    ``MM.set_mm_cols`` unless ``install`` is False. ``(m, k, n)``
    defaults model a decode-step projection (yi-6b's w_gate at 4 rows).

    Returns ``{"timings_s": {(tile_n, slices): seconds}, "best": (tile_n,
    slices), "default": k1_plan's (tile_n, slices), "key":
    MM.mm_key(...), "installed": bool}``."""
    device = _card(device)
    code_bits = 8 if k_x <= 6 else 16
    key = MM.mm_key(m, k, n, code_bits)
    prev = MM._MM_COLS_OVERRIDE.get(key)
    MM.set_mm_cols(None, key=key)
    plan = MM.k1_plan(m, k, n, code_bits)
    default = (plan.tile_n, plan.grid[2])
    x, codes, scale = k1_operands(m, k, n, k_x, device)
    counts = list(slices) if slices is not None else \
        slice_candidates(m, k, n, code_bits)
    timings = {}
    try:
        for tile_n in candidates:
            for s in counts:
                MM.set_mm_cols((tile_n, s), key=key)
                got = MM.k1_plan(m, k, n, code_bits)
                cand = (got.tile_n, got.grid[2])
                if cand in timings:
                    continue
                timings[cand] = graph_seconds(lambda: MM.dequant_matmul(
                    x, codes, scale, k_x=k_x, n=n, w_dtype="float32",
                    cast_dtype="bfloat16"), reps=max(1, iters))
    finally:
        MM.set_mm_cols(prev, key=key)
    best = min(timings, key=timings.get)
    if install:
        MM.set_mm_cols(best, key=key)
    return {"timings_s": timings, "best": best, "default": default,
            "key": key, "installed": install}


def _overlap(art, state, batch, device) -> dict:
    """One more step with the bucket hooks' CUDA events on: each
    bucket's exchange bytes and the device ms the backward still ran
    after the bucket launched (what the bucket could overlap), in
    launch order; {} for one pass after the backward."""
    if not art.overlap:
        return {}
    art.overlap["timing"] = True
    try:
        art.step_fn(state, batch)
        torch.cuda.synchronize(device)
    finally:
        art.overlap["timing"] = False
    ov = art.overlap
    *starts, end = ov.pop("events")
    left = [s.elapsed_time(end) for s in starts]
    rows = [{"bucket": k, "bytes": b, "backward_ms_left": max(t, 0.0)}
            for k, b, t in zip(ov["order"], ov["bytes"], left)]
    return {"buckets": rows, "in_backward": ov["in_backward"],
            "bytes_overlapped": sum(r["bytes"] for r in rows
                                    if r["backward_ms_left"] > 0.0),
            "bytes_total": sum(ov["bytes"])}


def agree_on_bucket(timings: dict, tc, group=None, device=None):
    """One bucket size for every rank: each candidate's slowest time over
    the ranks of ``group`` (the default process group when None; the
    candidates in one order on every rank), and the fastest of those.
    The size sets the order in which a step issues its exchange
    collectives, so ranks that chose apart would issue mismatched
    collectives. Returns ``(agreed timings, tc with the winner)``; alone
    (no process group, or one rank) the timings are this rank's."""
    import torch.distributed as dist
    keys = list(timings)
    agreed = dict(timings)
    if dist.is_available() and dist.is_initialized() and \
            dist.get_world_size(group) > 1:
        on = device if dist.get_backend(group) == "nccl" else "cpu"
        t = torch.tensor([timings[k] for k in keys], dtype=torch.float64,
                         device=on)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        agreed = dict(zip(keys, t.tolist()))
    best = min(keys, key=agreed.get)
    return agreed, dataclasses.replace(tc, exchange_bucket_bytes=best)


def tune_exchange_buckets(model, grid, tc, batch, *,
                          candidates: Sequence[int] = CANDIDATE_BUCKETS,
                          steps: int = 8, warmup: int = 1, device=None,
                          seed: int = 0, state_digest=None) -> dict:
    """Sweep ``TrainConfig.exchange_bucket_bytes`` against the train
    step's device time for this (model, grid, topology): the backward /
    exchange overlap knob of ``dist.step``'s gradient hooks. Each
    candidate trains ``warmup + steps`` steps from the same initial
    state on ``batch``; each timed step lies between two CUDA events on
    the step's stream (the side stream joins it before the step ends),
    and a candidate's time is the mean of its ``steps``, its spread their
    least and most. Every rank of the grid takes the same winner
    (:func:`agree_on_bucket`: the slowest rank's mean a candidate).
    ``tc.exchange_bucket_bytes`` always joins the sweep, so
    ``"speedup"`` (default time / best time) is >= 1.0 by construction.
    ``state_digest(state)``, when given, is taken after each candidate's
    run (e.g. to hold the states bitwise equal), before one more step
    that measures the overlap (``"overlap"``: each bucket's bytes and
    the backward's device ms left after it launched).

    Returns ``{"timings_s": {bucket: seconds, agreed over the ranks},
    "step_s": {bucket: [this rank's seconds a step]}, "spread_s":
    {bucket: (least, most)}, "best": bucket, "default":
    tc.exchange_bucket_bytes, "speedup": float, "config": TrainConfig,
    "losses": {bucket: [...]}, "overlap": {bucket: art.overlap},
    "buckets": {bucket: count}, "digests": {bucket: ...}}``."""
    from repro_torch.dist.step import make_train_step

    device = _card(device)
    cands = list(dict.fromkeys(
        tuple(int(b) for b in candidates) + (tc.exchange_bucket_bytes,)))
    step_s, losses, overlap, counts, digests = {}, {}, {}, {}, {}
    world = None
    for b in cands:
        tcb = dataclasses.replace(tc, exchange_bucket_bytes=b)
        art = make_train_step(model, grid, tcb)
        art.prepare(device)
        world = art.grid.world
        state = art.init_state(seed=seed, device=device)
        run, marks = [], []
        for _ in range(max(1, warmup)):
            state, metrics = art.step_fn(state, batch)
            run.append(metrics["loss"])
        for _ in range(steps):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            state, metrics = art.step_fn(state, batch)
            ev[1].record()
            marks.append(ev)
            run.append(metrics["loss"])
        torch.cuda.synchronize(device)
        step_s[b] = [a.elapsed_time(e) / 1e3 for a, e in marks]
        losses[b] = [float(x) for x in run]
        if state_digest is not None:
            digests[b] = state_digest(state)
        overlap[b] = _overlap(art, state, batch, device)
        counts[b] = len(art.buckets)
        del state, art
        torch.cuda.empty_cache()
    mean = {b: sum(v) / len(v) for b, v in step_s.items()}
    timings, config = agree_on_bucket(mean, tc, world, device)
    best = config.exchange_bucket_bytes
    return {"timings_s": timings, "step_s": step_s,
            "spread_s": {b: (min(v), max(v)) for b, v in step_s.items()},
            "best": best, "default": tc.exchange_bucket_bytes,
            "speedup": timings[tc.exchange_bucket_bytes] / timings[best],
            "config": config, "losses": losses, "overlap": overlap,
            "buckets": counts, "digests": digests}
