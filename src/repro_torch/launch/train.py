"""Training launcher: distributed QAdam-EF (Algorithms 2+3) through
``TrainSession.from_artifacts`` (port of ``repro/launch/train.py``).

  python -m repro_torch.launch.train --arch yi-6b \\
      --grad-bits 6 --weight-bits 7 --weight-absolute

runs one rank on the GPU (``--device cuda``, the default, over NCCL);
``torchrun --nproc-per-node W -m repro_torch.launch.train ...`` runs W
ranks, one per card. ``--smoke --device cpu`` runs the small
configuration on gloo through the kernels' plain versions, e.g.

  torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch yi-6b \\
      --smoke --device cpu --data 2 --steps 5 --seq 32 --global-batch 4

Weights are random, drawn from ``--seed``; batches are the synthetic
token stream of ``data.pipeline`` (embeddings in place of tokens for
llava-next-mistral-7b, its vision tower's stub; audio frames beside the
tokens for whisper-small, its mel and conv front-end's stub), every
rank taking its rows of one global batch, e.g.

  python -m repro_torch.launch.train --arch llava-next-mistral-7b \
      --smoke --device cpu --steps 4 --seq 32 --global-batch 4

``--grad-bits 0``/``--weight-bits 0`` turn either channel
to float32 rows; ``--no-ef`` ablates error feedback. ``--mode`` picks
the paper's ``qadam`` or a baseline: ``dp_adam`` (fp32 data-parallel
Adam), ``efadam`` (two-way EF), ``terngrad``, ``ef_sgd``, e.g.

  python -m repro_torch.launch.train --arch yi-6b --smoke --device cpu \
      --mode terngrad --grad-bits 0 --weight-bits 0 --alpha 0.02 --steps 5

``--steps`` is the total step budget: with ``--resume`` the session
restores the newest checkpoint under ``--ckpt-dir`` (state, step count
and data-stream position: bitwise an unbroken run) and runs only the
steps left. ``--ckpt-every N`` writes a checkpoint every N steps (keep
the newest ``--ckpt-keep``; ``--ckpt-codec uniform_amax:7`` stores the
moments as wire codes), e.g.

  python -m repro_torch.launch.train --arch yi-6b --smoke --device cpu \
      --steps 6 --seq 32 --global-batch 4 --ckpt-dir /tmp/ck \
      --ckpt-every 2 --resume

``--scan-chunk K`` runs K steps a dispatch: one CUDA-graph replay on the
card, a loop on the CPU (the log and checkpoint cadences are multiples
of K).

``--adaptive`` (or ``--mode adaptive``) drives the run through
``repro_torch.adapt``'s controller: per-leaf stats kept on the device,
a replan every ``--replan-every`` steps under ``--adapt-budget`` (the
exchange's byte budget against the fixed log:6 wire), the new plan's
step swapped in with the state carried bitwise; ``--adapt-verify``
holds every plan's byte accounting to measured payloads and the host
syncs to one a window (with ``--log-every 0``); ``--resume`` restores
the plan and the stats EMA with the state, e.g.

  python -m repro_torch.launch.train --arch yi-6b --smoke --device cpu \
      --adaptive --replan-every 2 --steps 6 --adapt-verify --log-every 0

The ranks form a ``(pod, data, model)`` grid (``launch.mesh.make_grid``,
row-major as the reference's mesh): ``--model N`` splits the sequence
and every weight over N model shards (the forward gathers each layer's
weights, float32 or int8 with ``--model-gather-quant 8``), and
``--topology NxD`` (which implies ``--pod N --data D``) runs the
hierarchical wire, a float32 reduce inside each node of D cards and the
quantized exchange across the N nodes, e.g. on four cards

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch yi-6b \
      --topology 2x2 --steps 5
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch yi-6b \
      --data 2 --model 2 --model-gather-quant 8 --steps 5

The MoE family trains the same way (``--arch deepseek-moe-16b`` or
``llama4-maverick-400b-a17b``); under ``--model N`` each rank holds
E / N of every layer's experts and the MoE layers exchange their tokens
over the model group (expert parallelism), e.g.

  torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch deepseek-moe-16b --smoke --device cpu --data 2 --model 2 \
      --steps 3 --seq 32 --global-batch 4

The SSM and hybrid family too (``--arch mamba2-2.7b`` or
``hymba-1.5b``); under ``--model N`` each rank holds S / N positions of
every sequence (a multiple of the SSD chunk), scans its chunks from zero
and corrects them with the shards before it (the config's
``ssm.cp_exchange``: an all-gather of the per-shard summaries, or the
log-step ladder of point-to-point shifts), takes its conv halo from the
previous rank, and hymba's meta prefix goes in front of the gathered
K/V, e.g.

  torchrun --nproc-per-node 4 -m repro_torch.launch.train \
      --arch mamba2-2.7b --smoke --device cpu --data 2 --model 2 \
      --steps 3 --seq 32 --global-batch 4

``--layers N`` cuts the configuration's depth at full width.

The kernel build cache (``repro_torch.perf.cache``) is on by default:
``--compile-cache DIR`` places it (default ``$REPRO_COMPILE_CACHE`` or
the repository's ``build/``), ``--no-compile-cache`` builds into a
private temporary directory. ``--aot-dir DIR`` keeps the step's kernel
library as an AOT artifact (``repro_torch.perf.aot``): a restart loads
it without ``nvcc``. ``--tune-buckets`` times the exchange bucket sizes
on the card before training (``perf.autotune.tune_exchange_buckets``)
and trains with the fastest. The reference's multi-host flags are known
and refused by name: the port runs one process per card under
``torchrun``, which sets the process group from its environment, where
the reference runs one process per host.
"""
from __future__ import annotations

import argparse
import json

# the reference's jax.distributed flags (one process per host), with the
# value that leaves them off
MULTIHOST = {"multihost": False, "coordinator": None, "num_processes": None,
             "process_id": None}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--data", type=int, default=None,
                    help="workers (the data axis); default: the ranks "
                         "torchrun started, 1 alone")
    ap.add_argument("--alpha", type=float, default=1e-3)
    ap.add_argument("--beta", type=float, default=0.99)
    ap.add_argument("--theta", type=float, default=0.999)
    ap.add_argument("--schedule", default="constant")
    ap.add_argument("--grad-bits", type=int, default=6,
                    help="log-grid k_g; 0 = fp32 wire")
    ap.add_argument("--weight-bits", type=int, default=6,
                    help="uniform k_x; 0 = fp32 broadcast")
    ap.add_argument("--weight-absolute", action="store_true",
                    help="the paper's absolute [-0.5,0.5] grid")
    ap.add_argument("--no-ef", action="store_true")
    ap.add_argument("--mode", default="qadam",
                    choices=["qadam", "efadam", "dp_adam", "terngrad",
                             "ef_sgd", "adaptive"])
    ap.add_argument("--adaptive", action="store_true",
                    help="runtime-adaptive per-leaf bit allocation "
                         "(repro_torch.adapt): stats-driven replans every "
                         "--replan-every steps under --adapt-budget")
    ap.add_argument("--adapt-budget", type=float, default=0.6,
                    help="exchange byte budget as a fraction of the fixed "
                         "log:6 wire")
    ap.add_argument("--replan-every", type=int, default=25)
    ap.add_argument("--adapt-ema", type=float, default=0.8,
                    help="stats EMA decay per step")
    ap.add_argument("--adapt-verify", action="store_true",
                    help="assert exact byte accounting at every plan and "
                         "no steady-state host sync")
    ap.add_argument("--scan-chunk", type=int, default=1,
                    help=">1: this many steps a dispatch (a CUDA graph on "
                         "the card)")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="batches staged to the device ahead (0 = inline)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-keep", type=int, default=3,
                    help="versioned checkpoints kept (keep-last-N)")
    ap.add_argument("--ckpt-codec", default=None,
                    help="repro_torch.comm codec spec for compressed "
                         "moment snapshots, e.g. uniform_amax:7 (lossy)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest checkpoint under --ckpt-dir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--history-out", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the configuration to this many layers "
                         "(0: its own depth)")
    ap.add_argument("--model", type=int, default=1, help="model axis size")
    ap.add_argument("--pod", type=int, default=0, help="pod axis size")
    ap.add_argument("--topology", default=None, metavar="SPEC",
                    help="'flat' (default) or 'NxD' = "
                         "HierarchicalTopology(nodes=N, devices_per_node=D)"
                         "; NxD implies --pod N --data D when those are "
                         "left default")
    ap.add_argument("--model-gather-quant", type=int, default=0,
                    help="int8 gather of the model shards at this k_x, "
                         "0 = float32")
    ap.add_argument("--tune-buckets", action="store_true",
                    help="time the exchange bucket sizes on the card before "
                         "training and train with the fastest "
                         "(perf.autotune.tune_exchange_buckets)")
    ap.add_argument("--compile-cache", default=None, metavar="DIR",
                    help="kernel build cache dir (default "
                         "$REPRO_COMPILE_CACHE or the repository's build/)")
    ap.add_argument("--no-compile-cache", action="store_true")
    ap.add_argument("--aot-dir", default=None, metavar="DIR",
                    help="AOT artifact dir: a restart loads the step's "
                         "kernel library without nvcc (repro_torch.perf.aot)")
    # the reference's multi-host flags: refused (see the module docstring)
    ap.add_argument("--multihost", action="store_true")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args(argv)
    if args.resume and not args.ckpt_dir:
        ap.error("--resume requires --ckpt-dir")
    args.adaptive = args.adaptive or args.mode == "adaptive"
    for name, off in MULTIHOST.items():
        if getattr(args, name) != off:
            raise NotImplementedError(
                f"--{name.replace('_', '-')}: the port runs one process per "
                "card under torchrun, which sets the process group from its "
                "environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT); "
                "the reference's jax.distributed flags name one process "
                "per host and have no counterpart")
    from repro_torch.dist import topology as T
    topo = T.parse_topology(args.topology)
    if isinstance(topo, T.HierarchicalTopology):
        n, d = topo.nodes, topo.devices_per_node
        if args.pod == 0 and args.data in (None, 1):
            # NxD picks the grid too: pod = node axis, data = intra axis
            args.pod, args.data = n, d
        elif max(args.pod, 1) * (args.data or 1) != n * d:
            ap.error(f"--topology {args.topology} needs {n * d} workers "
                     f"but --pod/--data give "
                     f"{max(args.pod, 1) * (args.data or 1)}")
    args.topology_spec = topo
    return args


def _plan_summary(plan) -> str:
    counts = {}
    for spec in plan:
        counts[spec] = counts.get(spec, 0) + 1
    return " ".join(f"{s}x{n}" for s, n in sorted(counts.items()))


def _run_adaptive(args, model, grid, tc, cfg, lead):
    """--adaptive: the run through the repro_torch.adapt controller
    (stats ring -> bit allocation -> step swaps at replan boundaries)
    instead of a plain session."""
    import math

    from repro_torch.adapt.controller import AdaptConfig, AdaptiveController
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.launch.mesh import rank_device
    from repro_torch.train.session import SessionConfig

    say = print if lead else (lambda *_: None)
    batches = batch_for_model(cfg, args.seq, args.global_batch,
                              seed=args.seed)
    sc = SessionConfig(log_every=args.log_every,
                       ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
                       ckpt_keep=args.ckpt_keep, ckpt_codec=args.ckpt_codec,
                       scan_chunk=args.scan_chunk, prefetch=args.prefetch,
                       aot_dir=args.aot_dir)
    acfg = AdaptConfig(budget_ratio=args.adapt_budget,
                       replan_every=args.replan_every,
                       ema_decay=args.adapt_ema)
    ctl = AdaptiveController(model, grid, tc, batches, acfg, sc,
                             seed=args.seed, device=rank_device(args.device),
                             log=say, verify=args.adapt_verify)
    say(f"workers={ctl.art.n_workers} device={args.device}")
    try:
        start = ctl.resume(args.ckpt_dir) if args.resume else 0
        if start:
            plan = ctl.tc.bit_plan
            say(f"resumed from step {start} ({args.ckpt_dir}), plan "
                f"restored: "
                f"{_plan_summary(plan) if plan else 'initial log grid'}")
        remaining = args.steps - start
        if remaining <= 0:
            say(f"nothing to do: checkpoint at step {start} >= "
                f"--steps {args.steps}")
            return
        ctl.run(remaining)
        windows = math.ceil(remaining / args.replan_every)
        if args.adapt_verify:
            # every plan already passed accounted == measured; here: the
            # only host syncs are the window harvests (and the log
            # boundaries' loss harvests), nothing a step
            if args.log_every == 0:
                assert ctl.stats["syncs"] == windows,                     (f"{ctl.stats['syncs']} syncs != {windows} replan "
                     f"windows: a per-step host sync crept in")
            say(f"adapt-verify OK: {len(ctl.plan_log)} plans exact, "
                f"{ctl.stats['syncs']} syncs / {windows} windows")
        losses = [h for h in ctl.session.history if "loss" in h]
        if not losses:
            losses = [{"step": s, "loss": v}
                      for s, v in ctl.session.harvest_losses()]
    finally:
        ctl.close()
    say(f"session stats: {ctl.stats}")
    for e in ctl.plan_log:
        a2a = e["comm"]["update_exchange_bytes"]
        say(f"plan @{e['step']}: a2a {a2a / 1e6:.3f}MB/step "
            f"({'initial log grid' if e['bit_plan'] is None else ''}"
            f"{'' if e['bit_plan'] is None else _plan_summary(e['bit_plan'])})")
    if args.history_out and lead:
        with open(args.history_out, "w") as f:
            json.dump({"arch": args.arch, "history": ctl.session.history,
                       "plan_log": [
                           {"step": e["step"], "comm": e["comm"],
                            "bit_plan": (list(e["bit_plan"])
                                         if e["bit_plan"] else None)}
                           for e in ctl.plan_log],
                       "stats": ctl.stats}, f, indent=1)
    if losses:
        say("final loss:", losses[-1]["loss"])


def setup_build_cache(args) -> None:
    """``--compile-cache`` / ``--no-compile-cache`` (both launchers): the
    build cache on by default, as the reference's compile cache; with
    ``--aot-dir`` an artifact built from this checkout for this card is
    loaded before anything launches a kernel."""
    from repro_torch import perf
    if args.no_compile_cache:
        perf.disable_persistent_cache()
    else:
        cache_dir = perf.enable_persistent_cache(args.compile_cache)
        if cache_dir:
            print(f"compile cache: {cache_dir}")
    if args.aot_dir and args.device != "cpu" and \
            perf.aot.preload(args.aot_dir):
        print(f"kernel library loaded from {args.aot_dir}")


def tune_buckets(args, model, grid, tc, cfg, lead):
    """--tune-buckets: the exchange bucket sweep on a probe batch from a
    fresh same-seed stream (the training stream's position untouched),
    on the card; returns the config with the fastest size, the same on
    every rank (the slowest rank's time a size decides)."""
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.launch.mesh import rank_device
    from repro_torch.perf.autotune import tune_exchange_buckets
    from repro_torch.train.session import stage_batch
    dev = rank_device(args.device)
    probe = stage_batch(next(batch_for_model(cfg, args.seq,
                                             args.global_batch,
                                             seed=args.seed)), dev)
    rep = tune_exchange_buckets(model, grid, tc, probe, device=dev,
                                seed=args.seed)
    if lead:
        print(f"tuned exchange bucket: {rep['best']} B (speedup "
              f"{rep['speedup']:.2f}x vs default {rep['default']} B); "
              + ", ".join(f"{b} B {t * 1e3:.3f} ms (this rank "
                          f"{rep['spread_s'][b][0] * 1e3:.3f}-"
                          f"{rep['spread_s'][b][1] * 1e3:.3f})"
                          for b, t in rep["timings_s"].items()))
    return rep["config"]


def main(argv=None):
    """Run the launcher on ``argv``; returns ``{"art", "comm", "history",
    "stats", "state"}`` of the session (None for ``--adaptive`` and where
    nothing was left to do). A process group that exists already (one
    rank of a caller's) is used and left open; one made here is closed
    at the end."""
    args = parse_args(argv)

    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import batch_for_model
    from repro_torch.dist.step import TrainConfig, make_train_step
    from repro_torch.launch.mesh import (close_process_group, make_grid,
                                         rank_device)
    from repro_torch.models.model import Model
    from repro_torch.train.loop import comm_bytes_per_step
    from repro_torch.train.session import SessionConfig, TrainSession

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    setup_build_cache(args)
    tc = TrainConfig(alpha=args.alpha, beta=args.beta, theta=args.theta,
                     schedule=args.schedule,
                     grad_k=args.grad_bits or None,
                     weight_k=args.weight_bits or None,
                     weight_absolute=args.weight_absolute,
                     error_feedback=not args.no_ef,
                     mode="adaptive" if args.adaptive else args.mode,
                     topology=args.topology_spec,
                     model_gather_quant=args.model_gather_quant or None,
                     seed=args.seed)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = Model(cfg)
    owned = not torch.distributed.is_initialized()
    try:
        grid = make_grid(pod=args.pod, data=args.data, model=args.model,
                         device=args.device)
        lead = grid.rank == 0
        if args.tune_buckets:
            tc = tune_buckets(args, model, grid, tc, cfg, lead)
        if args.adaptive:
            _run_adaptive(args, model, grid, tc, cfg, lead)
            return None
        art = make_train_step(model, grid, tc)
        comm = comm_bytes_per_step(art, tc)
        if lead:
            print(f"grid={dict(zip(grid.axes, grid.sizes))} "
                  f"workers={art.n_workers} device={args.device}")
            print(f"comm/device/step: "
                  f"exchange={comm['update_exchange_bytes'] / 1e6:.2f}MB "
                  f"broadcast={comm['weight_broadcast_bytes'] / 1e6:.2f}MB")
            if comm["tiers"]["intra"]["total"]:
                print(f"  per tier: "
                      f"inter={comm['tiers']['inter']['total'] / 1e6:.2f}MB "
                      f"intra={comm['tiers']['intra']['total'] / 1e6:.2f}MB")
        batches = batch_for_model(cfg, args.seq, args.global_batch,
                                  seed=args.seed)
        sc = SessionConfig(log_every=args.log_every,
                           ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
                           ckpt_keep=args.ckpt_keep,
                           ckpt_codec=args.ckpt_codec,
                           scan_chunk=args.scan_chunk, prefetch=args.prefetch,
                           aot_dir=args.aot_dir)
        sess = TrainSession.from_artifacts(
            art, batches, sc, seed=args.seed,
            device=rank_device(args.device),
            log=print if lead else (lambda *_: None))
        try:
            start = sess.resume(args.ckpt_dir) if args.resume else 0
            if start and lead:
                print(f"resumed from step {start} ({args.ckpt_dir})")
            remaining = args.steps - start
            if remaining <= 0:
                if lead:
                    print(f"nothing to do: checkpoint at step {start} >= "
                          f"--steps {args.steps}")
                return None
            sess.run(remaining)
            losses = [h for h in sess.history if "loss" in h]
            if not losses:   # --log-every 0: nothing harvested in the run
                losses = [{"step": s, "loss": v}
                          for s, v in sess.harvest_losses()]
        finally:
            sess.close()
        if lead:
            print(f"session stats: {sess.stats}")
            if args.history_out:
                with open(args.history_out, "w") as f:
                    json.dump({"arch": args.arch, "history": sess.history,
                               "comm": comm, "stats": sess.stats}, f,
                              indent=1)
            if losses:
                print("final loss:", losses[-1]["loss"])
        return {"art": art, "comm": comm, "history": losses,
                "stats": dict(sess.stats), "state": sess.state}
    finally:
        if owned:
            close_process_group()


if __name__ == "__main__":
    main()
