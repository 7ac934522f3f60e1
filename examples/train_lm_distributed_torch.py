"""End-to-end program on the PyTorch port: distributed QAdam-EF training
of a ~100M-param LM (Algorithms 2+3; port of
``examples/train_lm_distributed.py``) - workers x context parallelism,
int8-lane update exchange + weight broadcast.

The reference's 8 simulated devices become ``torchrun`` ranks: gloo
processes on the CPU (4 workers x 2-way context parallelism),

  PYTHONPATH=src torchrun --nproc-per-node 8 \\
      examples/train_lm_distributed_torch.py --device cpu --data 4 --model 2

or NCCL ranks, one a card; on one card it is one rank:

  PYTHONPATH=src python examples/train_lm_distributed_torch.py --steps 300

``--smoke`` keeps the smoke configuration's widths (quick CPU runs).
"""
import argparse
import dataclasses
import json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--alpha", type=float, default=1e-3)
    ap.add_argument("--data", type=int, default=None,
                    help="workers (default: the ranks over --model)")
    ap.add_argument("--model", type=int, default=1,
                    help="context-parallel (model axis) shards")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke configuration's widths instead of the "
                         "~100M model's (quick runs on the CPU)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

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
    # ~100M params: 8 layers of d=768 GQA + 32k vocab
    cfg = get_config("yi-6b", smoke=True)
    widths = {} if args.smoke else dict(
        d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048, vocab_size=32000)
    cfg = dataclasses.replace(cfg, n_layers=args.layers, dtype="float32",
                              **widths)
    model = Model(cfg)
    grid = make_grid(data=args.data, model=args.model, device=args.device)
    lead = grid.rank == 0
    say = print if lead else (lambda *_: None)
    try:
        say(f"params: {cfg.n_params() / 1e6:.1f}M")
        tc = TrainConfig(alpha=args.alpha, schedule="constant",
                         grad_k=6, weight_k=6, weight_absolute=False)
        art = make_train_step(model, grid, tc)
        comm = comm_bytes_per_step(art, tc)
        say(f"{art.n_workers} workers x {grid.n_shards}-way CP "
            f"({args.device}); per-device wire/step: exchange "
            f"{comm['update_exchange_bytes'] / 1e6:.1f}MB + broadcast "
            f"{comm['weight_broadcast_bytes'] / 1e6:.1f}MB (fp32 all-reduce "
            f"would be {comm['shard_params'] * 8 / 1e6:.1f}MB)")

        batches = batch_for_model(cfg, args.seq, args.global_batch, seed=0)
        # TrainSession: batches prefetched + staged to the device on a
        # background thread, losses device-resident between log
        # boundaries (the stats line shows dispatches vs host syncs)
        with TrainSession.from_artifacts(
                art, batches, SessionConfig(log_every=10), seed=0,
                device=rank_device(args.device),
                log=say) as sess:
            history = sess.run(args.steps)
            stats = dict(sess.stats)
    finally:
        close_process_group()
    say(f"session stats: {stats}")
    if args.out and lead:
        with open(args.out, "w") as f:
            json.dump(history, f)
    losses = [h for h in history if "loss" in h]
    first, last = losses[0]["loss"], losses[-1]["loss"]
    say(f"loss {first:.3f} -> {last:.3f}")
    assert last < first, "training must make progress"


if __name__ == "__main__":
    main()
