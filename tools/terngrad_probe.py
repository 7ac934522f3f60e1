"""Time TernGrad's training step on a card, in one process:

  * Algorithm 1's ``terngrad_sgd`` through ``TrainSession.from_optimizer``
    on yi-6b cut to 8 layers, 2 x 1024 tokens (``chip_smoke.py`` phase
    5b's cell);
  * the distributed ``terngrad`` mode through ``TrainSession.from_artifacts``
    on one NCCL rank, yi-6b cut to 2 layers (phase 7's cell);

each step by step and, where the package allows it, with
``scan_chunk=4`` (one CUDA graph a chunk): the step's wall ms (host
clock over whole dispatches), its device ms and the draws' device ms
(``torch.profiler``: the threefry kernels, or ``torch.rand``'s Philox
kernel), and the run's peak bytes. Prints the card's name and power
limit and one JSON line.

    python3 tools/terngrad_probe.py [--src DIR] [--cache DIR] [--label L]

``--src`` imports the package from another checkout's ``src`` (the
parent commit's, to compare two versions in one call); ``--cache`` shares
a kernel build cache between the checkouts.
"""
import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ, BATCH, CHUNK = 1024, 2, 4
DRAW_KERNELS = ("threefry", "distribution_elementwise")


def device_ms(torch, fn, calls: int):
    """Device ms of one ``fn()`` (torch.profiler over ``calls`` calls after
    a warm one) and the draw kernels' share of it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = draws = 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if t and "CUDA" in str(getattr(e, "device_type", "")):
            total += t
            if any(k in e.key for k in DRAW_KERNELS):
                draws += t
    return total / calls / 1e3, draws / calls / 1e3


def measure(torch, make, chunk: int, steps: int):
    """A session's steady step: wall and device ms, the draws' device ms,
    peak bytes; ``{"refused": ...}`` where the package refuses the
    chunk."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        sess = make(chunk)
    except NotImplementedError as e:
        return {"refused": str(e)[:120]}
    sess.run(2 * chunk)                # warm-up (and the capture)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.run(steps)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps * 1e3
    dev, draws = device_ms(torch, lambda: sess.run(chunk), 2)
    out = dict(step_wall_ms=wall, step_device_ms=dev / chunk,
               draw_ms=draws / chunk,
               peak_bytes=torch.cuda.max_memory_allocated(),
               stats={k: v for k, v in sess.stats.items()
                      if k.startswith(("graph", "dispatches"))})
    sess.close()
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.join(HERE, "src"))
    ap.add_argument("--cache", default=None)
    ap.add_argument("--label", default="tree")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("terngrad_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch import build
    if args.cache:
        build.set_cache_dir(args.cache)
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    from repro_torch.configs import get_config
    from repro_torch.core.qadam import terngrad_sgd
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.dist.step import TrainConfig, make_train_step
    from repro_torch.launch.mesh import (close_process_group,
                                         make_process_group)
    from repro_torch.models.model import Model
    from repro_torch.train.session import SessionConfig, TrainSession
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    res = {"label": args.label, "src": args.src, "card": card,
           "build_s": build_s}

    cfg8 = dataclasses.replace(get_config("yi-6b"), n_layers=8)
    model8 = Model(cfg8)

    def loss_fn(p, b):
        ls, nt = model8.loss(p, b)
        return ls / nt

    def alg1(chunk):
        return TrainSession.from_optimizer(
            terngrad_sgd(alpha=1e-3), loss_fn,
            model8.init(seed=0, device=dev),
            batch_for_model(cfg8, SEQ, BATCH, seed=0),
            SessionConfig(log_every=CHUNK * 4, scan_chunk=chunk),
            log=lambda *_: None)
    res["alg1"] = measure(torch, alg1, 1, 6)
    res["alg1_graph"] = measure(torch, alg1, CHUNK, 2 * CHUNK)
    del model8

    cfg2 = dataclasses.replace(cfg8, n_layers=2)
    model2 = Model(cfg2)
    group = make_process_group("cuda")
    try:
        art = make_train_step(model2, group, TrainConfig(
            alpha=1e-3, grad_k=None, weight_k=None, mode="terngrad"))

        def dist(chunk):
            return TrainSession.from_artifacts(
                art, batch_for_model(cfg2, SEQ, BATCH, seed=0),
                SessionConfig(log_every=CHUNK * 4, scan_chunk=chunk),
                seed=0, device=dev, log=lambda *_: None)
        res["dist"] = measure(torch, dist, 1, 6)
        res["dist_graph"] = measure(torch, dist, CHUNK, 2 * CHUNK)
        del art
    finally:
        close_process_group()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
