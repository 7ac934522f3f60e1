#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each raising on failure (exit code nonzero, no result line):

  1. print the card's name and power limit (nvidia-smi);
  2. build the four CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
     sm_90a, one process per source);
  3. hold each kernel against its plain PyTorch version at yi-6b shapes:
     K3 amax / K4 quantize on a stacked (32, 4096, 11008) f32 leaf and K2
     page gather bitwise; K1 dequant-matmul at M in {1, 4, 32} for every
     projection shape and code type within one bf16 ulp (plus a floor
     near zero set from the measured fp32 summation-order noise; a
     dropped K row must fail that gate); time each kernel, its plain
     version and a one-call PyTorch yardstick;
  4. serve full-width yi-6b (random weights from a seed): Model.init,
     quantize_params(k_x=6), a paged ServeSession (page 16, 4 slots,
     chunked prefill 32) answering 8 requests of 64-token prompts with
     16 new tokens each; the kernels' launch counts are read around this
     run and every one must be > 0, with no plain version on the card;
     then one decode step on identical state through the kernels and
     through the plain versions: relative L2 of the logits within
     SHALLOW_LIMIT for the bf16 step cut to 1 and 2 layers and within
     F32_LIMIT for the full-depth step in float32 activations (at full
     depth in bf16, fp32 summation order alone moves the logits by
     ~3e-2, which is printed, with a float64-summed step, not gated);
  5. print one ``{"kernels": [...]}`` line, the card line again, and the
     last line ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package. Detailed tables are
also written to ``results/chip_smoke.json``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOPS = 989e12              # dense bf16 tensor-core peak
YI = dict(L=32, d=4096, H=32, K=4, hd=128, f=11008, V=64000)
# decode-logits limits, kernels vs plain versions (rel L2), set from the
# readings in PERF.md: the bf16 step cut to 1 and 2 layers, and the
# full-depth step in float32 activations
SHALLOW_LIMIT = 1e-2
F32_LIMIT = 5e-5


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, flops: float = 0.0):
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn(i)`` over ``iters`` calls (CUDA events)."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def print_ptxas(log: str) -> None:
    """One line per kernel instance from nvcc's ``-Xptxas -v`` output:
    registers, and spill bytes where there are any."""
    name, spill = "", ""
    for line in log.splitlines():
        if "Function properties for " in line:
            name = line.split("Function properties for ")[-1].strip()
        elif "bytes spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            spill = (f", {nums[1]} B spill stores, {nums[2]} B spill loads"
                     if nums[1] or nums[2] else "")
        elif "Used " in line and " registers" in line and name:
            regs = line.split("Used ")[1].split(" registers")[0]
            at = name.find("_kernel")   # mangled: template args follow
            print(f"  ptxas: {regs:>3} registers{spill}  "
                  f"{name[max(0, at - 16):at + 44]}")
            name = ""


def graph_ms(torch, fn, variants: int = 1, replays: int = 20) -> float:
    """Device time of one ``fn(i)`` with the host out of the way: the
    calls for i < variants are captured in a CUDA graph, which is then
    replayed (rotating variants keep the L2 cache from holding inputs)."""
    for i in range(variants):
        fn(i)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(variants):
            fn(i)
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        g.replay()
    end.record()
    end.synchronize()
    del g
    return start.elapsed_time(end) / (replays * variants)


def profile_ms(torch, fn, steps: int = 3):
    """Device time per call of ``fn()`` by kernel, from torch.profiler:
    (total device ms, [(kernel name, device ms)] largest first)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if t and getattr(e, "device_type", None) is not None and \
                "CUDA" in str(e.device_type):
            rows.append((e.key, t / steps / 1e3))
    rows.sort(key=lambda r: -r[1])
    return sum(t for _, t in rows), rows


def bf16_ulp(torch, x):
    a = x.abs().to(torch.float32).clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


# K1's floor below one bf16 ulp, in units of sqrt(K) 2^-24 |x*w|_2: set
# from the fp32 summation-order noise measured between the kernel and
# the plain product (PERF.md, K1 parity).
K1_FLOOR = 8.0


def k1_noise_unit(torch, MM, x, codes, scale, kw):
    """sqrt(K) 2^-24 |x*w|_2 per output, |x*w|_2 the L2 norm of the K
    products summed into it: the scale of fp32 summation-order noise."""
    w = MM.dequant_codes(codes, scale, k_x=kw["k_x"], n=kw["n"],
                         pack_bits=kw["pack_bits"], w_dtype="float32",
                         cast_dtype=kw["cast_dtype"]).float()
    t = (x.float() ** 2 @ w ** 2).sqrt()
    return x.shape[-1] ** 0.5 * 2.0 ** -24 * t


def k1_tolerance(torch, ulp_of, unit):
    """One bf16 ulp of the plain product, plus a floor for outputs that
    cancel to near zero, where a bf16 ulp is finer than the fp32
    summation-order noise of two orders of the same K products."""
    return bf16_ulp(torch, ulp_of.float()) + K1_FLOOR * unit


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_quantize(torch, K, dev):
    L, d, f = YI["L"], YI["d"], YI["f"]
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.empty((L, d * f), dtype=torch.float32, device=dev)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=g)
    x.mul_(0.02)
    a_k = K.amax_rows(x, backend="cuda")
    a_p = K.amax_rows(x, backend="torch")
    if not torch.equal(a_k, a_p):
        raise AssertionError("K3 amax differs from its plain version")
    s = torch.clamp_min(a_k, 1e-30)
    c_k = K.uniform_quantize_rows(x, s, 6, backend="cuda")
    c_p = K.uniform_quantize_rows(x, s, 6, backend="torch")
    if not torch.equal(c_k, c_p):
        raise AssertionError("K4 uniform quantize differs from its plain "
                             "version")
    del c_p
    xb = x.numel() * 4
    rows = []
    t_k = cuda_ms(torch, lambda i: K.amax_rows(x, backend="cuda"), 5, 1)
    t_p = cuda_ms(torch, lambda i: K.amax_rows(x, backend="torch"), 5, 1)
    t_l = cuda_ms(torch, lambda i: x.abs().amax(-1), 5, 1)
    b, by = bound_ms(xb + 4 * L)
    rows.append(dict(name="amax_rows", route="cuda",
                     source="src/repro_torch/csrc/quantize.cu",
                     replaces="src/repro/comm/kernels.py:482",
                     max_abs_err=float((a_k - a_p).abs().max()), ms=t_k,
                     plain_ms=t_p, bound_ms=b, bound_by=by, library_ms=t_l,
                     shape=[L, d * f]))
    t_k = cuda_ms(torch, lambda i: K.uniform_quantize_rows(
        x, s, 6, backend="cuda"), 5, 1)
    t_p = cuda_ms(torch, lambda i: K.uniform_quantize_rows(
        x, s, 6, backend="torch"), 5, 1)
    b, by = bound_ms(xb + 4 * L + x.numel())
    rows.append(dict(name="uniform_quantize_rows", route="cuda",
                     source="src/repro_torch/csrc/quantize.cu",
                     replaces="src/repro/comm/kernels.py:545",
                     max_abs_err=0.0, ms=t_k, plain_ms=t_p, bound_ms=b,
                     bound_by=by, library_ms=None, shape=[L, d * f]))
    return rows


def check_gather(torch, paged, dev, slots, npag, num_pages):
    g = torch.Generator(device=dev).manual_seed(12)
    pool = torch.randn((num_pages, 16, YI["K"], YI["hd"]), generator=g,
                       device=dev).to(torch.bfloat16)
    perm = torch.randperm(num_pages, generator=g, device=dev)
    tab = perm[:slots * npag].reshape(slots, npag).to(torch.int32)
    tab[1, npag // 2:] = num_pages          # RELEASED sentinel tail
    tab[3, :] = num_pages                   # a released slot
    a = paged.gather_pages(pool, tab, backend="cuda")
    b = paged.gather_pages(pool, tab, backend="torch")
    if not torch.equal(a, b):
        raise AssertionError("K2 page gather differs from its plain version")
    flat = torch.clamp(tab, 0, num_pages - 1).reshape(-1).long()
    t_k = graph_ms(torch, lambda i: paged.gather_pages(pool, tab,
                                                       backend="cuda"))
    t_p = graph_ms(torch, lambda i: paged.gather_pages(pool, tab,
                                                       backend="torch"))
    t_l = graph_ms(torch, lambda i: torch.index_select(pool, 0, flat))
    t_e = cuda_ms(torch, lambda i: paged.gather_pages(pool, tab,
                                                      backend="cuda"))
    view = a.numel() * a.element_size()
    b_, by = bound_ms(2 * view + tab.numel() * 4)
    return dict(name="gather_pages", route="cuda",
                source="src/repro_torch/csrc/gather_pages.cu",
                replaces="src/repro/serve/paged.py:74", max_abs_err=0.0,
                ms=t_k, plain_ms=t_p, bound_ms=b_, bound_by=by,
                library_ms=t_l, eager_ms=t_e, shape=list(tab.shape))


def _codes(torch, B, g, dev, kind, Kd, N):
    """Random codes of one kind: (k_x, pack_bits, codes)."""
    k_x = {"int8": 6, "int16": 7, "p3": 1, "p4": 2, "p6": 4}[kind]
    lim = 2 ** k_x
    c = torch.randint(-lim, lim + 1, (Kd, N), generator=g, device=dev,
                      dtype=torch.int32)
    if kind == "int8":
        return k_x, 0, c.to(torch.int8)
    if kind == "int16":
        return k_x, 0, c.to(torch.int16)
    bits = int(kind[1:])
    return k_x, bits, B.pack_rows(c, bits)


def check_matmul(torch, MM, B, dev):
    """K1 at every (M, K, N, code type) of the path; returns the decode
    row for the kernels line and the full table."""
    g = torch.Generator(device=dev).manual_seed(13)
    d, f, V, hK = YI["d"], YI["f"], YI["V"], YI["K"] * YI["hd"]
    shapes = [(d, d), (d, hK), (d, f), (f, d), (d, V)]
    cases = [(M, Kd, N, kind) for M in (1, 4, 32) for (Kd, N) in shapes
             for kind in ("int8", "int16", "p3", "p4", "p6")]
    cases += [(5, 1000, 1001, kind)
              for kind in ("int8", "int16", "p3", "p4", "p6")]  # ragged
    table, worst, noise = [], 0.0, {}
    scale = torch.tensor(0.0371, device=dev)
    for M, Kd, N, kind in cases:
        k_x, pb, codes = _codes(torch, B, g, dev, kind, Kd, N)
        x = (torch.randn((M, Kd), generator=g, device=dev)).to(torch.bfloat16)
        kw = dict(k_x=k_x, n=N, pack_bits=pb, cast_dtype="bfloat16")
        a = MM.dequant_matmul(x, codes, scale, backend="cuda", **kw)
        b = MM.dequant_matmul(x, codes, scale, backend="torch", **kw)
        diff = (a.float() - b.float()).abs()
        unit = k1_noise_unit(torch, MM, x, codes, scale, kw)
        tol = k1_tolerance(torch, b, unit)
        if a.dtype != torch.bfloat16 or not bool((diff <= tol).all()):
            over = (diff - bf16_ulp(torch, b.float())) / unit
            raise AssertionError(f"K1 at M={M} K={Kd} N={N} {kind}: beyond "
                                 f"one bf16 ulp of the plain product + "
                                 f"floor (max abs {float(diff.max())}, "
                                 f"{float(over.max())} floor units)")
        err = float(diff.max())
        worst = max(worst, err)
        # beyond one ulp, in floor units (the floor is K1_FLOOR of them)
        over = float(((diff - bf16_ulp(torch, b.float())).clamp_min(0)
                      / unit).max())
        n = noise.setdefault(Kd, dict(K=Kd, max_abs_err=0.0, bf16_over_ulp=0.0,
                                      f32_noise=0.0))
        n["max_abs_err"] = max(n["max_abs_err"], err)
        n["bf16_over_ulp"] = max(n["bf16_over_ulp"], over)
        table.append(dict(M=M, K=Kd, N=N, codes=kind, max_abs_err=err,
                          over_ulp_units=over))
        if M == 4 or Kd == 1000:
            # the same sums in fp32 activations: the summation-order noise
            # itself, in the same units
            xf = x.float()
            kf = dict(kw, cast_dtype=None)
            d32 = (MM.dequant_matmul(xf, codes, scale, backend="cuda", **kf)
                   - MM.dequant_matmul(xf, codes, scale, backend="torch",
                                       **kf)).abs()
            n["f32_noise"] = max(n["f32_noise"], float((d32 / unit).max()))
            if kind == "int8" and Kd != 1000:
                # the upper reading: one K row dropped from the plain sum
                w = MM.dequant_codes(codes, scale, k_x=k_x, n=N, pack_bits=0,
                                     w_dtype="float32", cast_dtype="bfloat16")
                bad = (x[:, :-1].float() @ w[:-1].float()).to(torch.bfloat16)
                fd = (bad.float() - b.float()).abs()
                seen = float((fd > tol).float().mean())
                if seen == 0.0:
                    raise AssertionError(f"K1 gate blind to a dropped K row "
                                         f"at K={Kd} N={N}")
                n["fault_max_abs"] = float(fd.max())
                n["fault_caught"] = seen
    # timing at the path's int8 shapes, four weight copies in rotation so
    # the 50 MB L2 does not hold the codes between calls
    timed = []
    for M in (4, 32, 1):
        for Kd, N in shapes:
            ws = [_codes(torch, B, g, dev, "int8", Kd, N)[2] for _ in range(4)]
            wf = [MM.dequant_codes(w, scale, k_x=6, n=N, pack_bits=0,
                                   w_dtype="float32",
                                   cast_dtype="bfloat16") for w in ws]
            x = torch.randn((M, Kd), generator=g, device=dev).to(torch.bfloat16)
            kw = dict(k_x=6, n=N, cast_dtype="bfloat16")
            t_k = graph_ms(torch, lambda i: MM.dequant_matmul(
                x, ws[i], scale, backend="cuda", **kw), 4)
            t_p = graph_ms(torch, lambda i: MM.dequant_matmul(
                x, ws[i], scale, backend="torch", **kw), 4, 5)
            t_l = graph_ms(torch, lambda i: torch.matmul(x, wf[i]), 4)
            t_e = cuda_ms(torch, lambda i: MM.dequant_matmul(
                x, ws[i % 4], scale, backend="cuda", **kw))
            bnd, by = bound_ms(Kd * N + 2 * M * Kd + 2 * M * N + 4,
                               2.0 * M * Kd * N)
            timed.append(dict(M=M, K=Kd, N=N, ms=t_k, plain_ms=t_p,
                              library_ms=t_l, eager_ms=t_e, bound_ms=bnd,
                              bound_by=by,
                              gbs=(Kd * N) / t_k / 1e6))
            del ws, wf
    rep = next(r for r in timed if (r["M"], r["K"], r["N"]) == (4, d, f))
    row = dict(name="dequant_matmul", route="cuda",
               source="src/repro_torch/csrc/dequant_matmul.cu",
               replaces="src/repro/comm/matmul.py:166", max_abs_err=worst,
               ms=rep["ms"], plain_ms=rep["plain_ms"],
               bound_ms=rep["bound_ms"], bound_by=rep["bound_by"],
               library_ms=rep["library_ms"], shape=[4, d, f])
    return row, table, timed, sorted(noise.values(), key=lambda r: r["K"])


# ---------------------------------------------------------------------------
# phase 4: full-width serving
# ---------------------------------------------------------------------------

def first_layers(blocks, n: int):
    """The first ``n`` layers of a scan-stacked subtree (QuantizedLeafs
    keep their per-layer scales)."""
    from repro_torch.serve.quantized import is_qleaf, tree_map_with_path
    return tree_map_with_path(
        lambda _, l: dataclasses.replace(
            l, codes=l.codes[:n], scale=l.scale[:n],
            shape=(n,) + tuple(l.shape[1:])) if is_qleaf(l) else l[:n],
        blocks)


def serve(torch, dev, mods):
    MM, paged, K = mods["MM"], mods["paged"], mods["K"]
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serve.quantized import (make_dequant_gather,
                                             params_nbytes, quantize_params)
    from repro_torch.serve.session import Request, ServeSession
    import numpy as np

    cfg = get_config("yi-6b")
    model = Model(cfg)
    slots, max_seq, n_req, plen, max_new = 4, 128, 8, 64, 16
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=[int(t) for t in rng.integers(
        1, cfg.vocab_size, size=plen)], max_new_tokens=max_new)
        for _ in range(n_req)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path, with every kernel count at 0 just before it
    MM.launches = paged.launches = 0
    K.amax_launches = K.quantize_launches = 0
    MM.plain_on_cuda = paged.plain_on_cuda = K.plain_on_cuda = 0
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    fp_bytes = params_nbytes(params)
    qparams = quantize_params(params, k_x=6, pack=True)
    torch.cuda.synchronize()
    t_quant = time.perf_counter() - t0
    peak_start = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()
    q_bytes = params_nbytes(qparams)
    sess = ServeSession(model, qparams, slots=slots, max_seq=max_seq,
                        paged=True, page_size=16, prefill_chunk=32, seed=0,
                        device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    handles = [sess.submit(r) for r in reqs]
    results = sess.drain()
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t1
    launches = {"dequant_matmul": MM.launches, "gather_pages": paged.launches,
                "amax_rows": K.amax_launches,
                "uniform_quantize_rows": K.quantize_launches}
    plain = MM.plain_on_cuda + paged.plain_on_cuda + K.plain_on_cuda

    if any(n == 0 for n in launches.values()):
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    if plain:
        raise AssertionError(f"{plain} plain-version calls on the card")
    for h in handles:
        r = results[h]
        if len(r.tokens) != max_new or r.finish_reason != "length":
            raise AssertionError(f"request {h}: {len(r.tokens)} tokens, "
                                 f"{r.finish_reason}")
    n_tok = sum(len(results[h].tokens) for h in handles)

    # one decode step and one chunk, timed, on a fresh cache
    gather = make_dequant_gather()
    cache = model.init_cache(slots, max_seq, page_pool=(sess.num_pages, 16),
                             device=dev)
    npag = max_seq // 16
    cache["ptab"].copy_(torch.arange(slots * npag, dtype=torch.int32,
                                     device=dev).reshape(slots, npag))
    prompt = torch.tensor([reqs[i].prompt for i in range(slots)],
                          dtype=torch.int32, device=dev)
    lane = lambda s: {"pk": cache["pk"], "pv": cache["pv"],
                      "ptab": cache["ptab"][s:s + 1]}
    for s in range(slots):
        for c0 in range(0, plen, 32):
            model.decode_chunk(qparams, {"token": prompt[s:s + 1, c0:c0 + 32]},
                               lane(s), torch.tensor([c0], device=dev),
                               torch.tensor([32], device=dev), gather)
    chunk_ms = cuda_ms(torch, lambda i: model.decode_chunk(
        qparams, {"token": prompt[0:1, 32:64]}, lane(0),
        torch.tensor([32], device=dev), torch.tensor([32], device=dev),
        gather), 5, 1)
    tok = prompt[:, -1:].contiguous()
    pos = torch.full((slots,), plen, dtype=torch.int32, device=dev)
    step_ms = cuda_ms(torch, lambda i: model.decode_step(
        qparams, {"token": tok}, cache, pos, gather), 10, 2)
    step_dev_ms, step_kernels = profile_ms(torch, lambda: model.decode_step(
        qparams, {"token": tok}, cache, pos, gather))

    # identical state through the kernels and through the plain versions
    def rel_l2(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    def both(mdl, qp, cache_of):
        """Logits of one decode step through the kernels and through the
        plain versions, each on its own copy of the state."""
        la, _ = mdl.decode_step(qp, {"token": tok}, cache_of(), pos, gather)
        lb, _ = mdl.decode_step(qp, {"token": tok}, cache_of(), pos, gather,
                                backend="torch")
        return la, lb

    def clone():
        return {k: v.clone() for k, v in cache.items()}
    la, lb = both(model, qparams, clone)
    if not bool(torch.isfinite(la).all()) or la.shape != (slots, cfg.vocab_size):
        raise AssertionError("decode logits not finite or misshapen")
    rel = rel_l2(la, lb)
    agree = float((la.argmax(-1) == lb.argmax(-1)).float().mean())

    # Gates where summation-order noise has not compounded: the bf16 step
    # cut to its first 1 and 2 layers, and the full-depth step in float32
    # activations (the same kernels' f32 instances).
    shallow = {}
    for n in (1, 2):
        mdl = Model(dataclasses.replace(cfg, n_layers=n))
        qp = dict(qparams, blocks=first_layers(qparams["blocks"], n))
        a, b = both(mdl, qp, lambda: {k: (v[:n] if k != "ptab" else v).clone()
                                      for k, v in cache.items()})
        shallow[n] = rel_l2(a, b)
        if shallow[n] > SHALLOW_LIMIT:
            raise AssertionError(f"decode logits at depth {n}: kernels vs "
                                 f"plain rel L2 {shallow[n]} > {SHALLOW_LIMIT}")
    m32 = Model(dataclasses.replace(cfg, dtype="float32"))

    def clone32():
        return {k: v.float() if v.is_floating_point() else v.clone()
                for k, v in cache.items()}
    a32, b32 = both(m32, qparams, clone32)
    rel32 = rel_l2(a32, b32)
    if rel32 > F32_LIMIT:
        raise AssertionError(f"float32 decode logits: kernels vs plain rel "
                             f"L2 {rel32} > {F32_LIMIT}")

    # readings, not gates: float64 sums in the plain product (how far two
    # fp32 summation orders drift apart over 32 bf16 layers on their own),
    # and a planted fault (one K row dropped from every plain projection)
    plain32 = MM._matmul_torch

    def plain64(x2, codes, scale, **kw):
        w = MM.dequant_codes(codes, scale, **kw)
        return (x2.double() @ w.double()).to(
            MM._out_dtype(x2.dtype, kw["w_dtype"], kw["cast_dtype"]))

    def dropped_row(x2, codes, scale, **kw):
        w = MM.dequant_codes(codes, scale, **kw)
        return (x2[:, :-1].float() @ w[:-1].float()).to(
            MM._out_dtype(x2.dtype, kw["w_dtype"], kw["cast_dtype"]))
    try:
        MM._matmul_torch = plain64
        lc, _ = model.decode_step(qparams, {"token": tok}, clone(), pos,
                                  gather, backend="torch")
        MM._matmul_torch = dropped_row
        lf, _ = m32.decode_step(qparams, {"token": tok}, clone32(), pos,
                                gather, backend="torch")
    finally:
        MM._matmul_torch = plain32
    rel_k64, rel_p64 = rel_l2(la, lc), rel_l2(lb, lc)
    rel_fault = rel_l2(lf, b32)
    print(f"decode logits rel L2, kernels vs plain: bf16 {rel:.4e} (argmax "
          f"agreement {agree:.3f}), bf16 at depth 1 {shallow[1]:.4e} and 2 "
          f"{shallow[2]:.4e} (limit {SHALLOW_LIMIT}), float32 {rel32:.4e} "
          f"(limit {F32_LIMIT}); readings: bf16 vs float64 sums kernels "
          f"{rel_k64:.4e} plain {rel_p64:.4e}; float32 with one K row "
          f"dropped {rel_fault:.4e}", flush=True)
    return dict(launches=launches, tokens=n_tok, serve_s=t_serve,
                tok_per_s=n_tok / t_serve, startup_s=t_quant,
                decode_step_ms=step_ms, chunk_ms=chunk_ms,
                decode_step_device_ms=step_dev_ms,
                decode_step_kernels=step_kernels[:12],
                resident_bytes=q_bytes, fp32_bytes=fp_bytes,
                peak_startup_bytes=peak_start,
                peak_bytes=torch.cuda.max_memory_allocated(),
                logits_rel_l2=rel, logits_rel_l2_kernels_vs_f64=rel_k64,
                logits_rel_l2_plain_vs_f64=rel_p64, argmax_agreement=agree,
                logits_rel_l2_depth1=shallow[1],
                logits_rel_l2_depth2=shallow[2], logits_rel_l2_f32=rel32,
                logits_rel_l2_f32_row_dropped=rel_fault,
                stats=dict(sess.stats))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port is measured on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch import build
    from repro_torch.comm import bits as B
    from repro_torch.comm import kernels as K
    from repro_torch.comm import matmul as MM
    from repro_torch.serve import paged

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)

    t0 = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    print_ptxas(build.build_log)

    rows = check_quantize(torch, K, dev)
    torch.cuda.empty_cache()
    rows.append(check_gather(torch, paged, dev, slots=4, npag=8,
                             num_pages=32))
    mm_row, mm_table, mm_timed, mm_noise = check_matmul(torch, MM, B, dev)
    rows.insert(0, mm_row)
    torch.cuda.empty_cache()
    print(f"kernel checks passed ({len(mm_table)} K1 cases)", flush=True)
    for n in mm_noise:
        fault = (f"; one dropped K row: max abs {n['fault_max_abs']:.4e}, "
                 f"caught at {n['fault_caught']:.1%} of outputs"
                 if "fault_max_abs" in n else "")
        print(f"  K1 K={n['K']}: max abs err {n['max_abs_err']:.4e}; beyond "
              f"one ulp {n['bf16_over_ulp']:.3f} and f32 summation noise "
              f"{n['f32_noise']:.3f} units of sqrt(K) 2^-24 |x*w|_2 (floor "
              f"{K1_FLOOR:g}){fault}", flush=True)

    res = serve(torch, dev, {"MM": MM, "paged": paged, "K": K})
    for r in rows:
        r["launches"] = res["launches"][r["name"]]
    print(f"served {res['tokens']} tokens in {res['serve_s']:.3f} s "
          f"({res['tok_per_s']:.2f} tok/s); decode step "
          f"{res['decode_step_ms']:.3f} ms, chunk {res['chunk_ms']:.3f} ms; "
          f"resident {res['resident_bytes']} B vs fp32 {res['fp32_bytes']} B; "
          f"peak {res['peak_bytes']} B (start-up {res['peak_startup_bytes']} B); "
          f"logits rel L2 {res['logits_rel_l2']:.3e}, argmax agreement "
          f"{res['argmax_agreement']:.3f}; stats {res['stats']}", flush=True)
    busy = res["decode_step_device_ms"] / res["decode_step_ms"]
    print(f"decode step: {res['decode_step_device_ms']:.3f} ms of device "
          f"work in {res['decode_step_ms']:.3f} ms (device idle "
          f"{1 - busy:.1%}); by kernel:", flush=True)
    for name, t in res["decode_step_kernels"]:
        print(f"  {t:9.4f} ms  {name[:90]}")
    for t in mm_timed:
        print(f"  K1 M={t['M']} K={t['K']} N={t['N']}: {t['ms']:.4f} ms "
              f"({t['gbs']:.0f} GB/s) plain {t['plain_ms']:.4f} library "
              f"{t['library_ms']:.4f} bound {t['bound_ms']:.4f} eager call "
              f"{t['eager_ms']:.4f}")

    out_dir = os.path.join(HERE, "results")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
        json.dump(dict(card=card, kernels=rows, k1_cases=mm_table,
                       k1_noise=mm_noise, k1_timed=mm_timed, serve=res),
                  fh, indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
