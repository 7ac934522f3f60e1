"""Quickstart on the PyTorch port: train a small LM with Quantized Adam
+ Error Feedback (Algorithm 1) and watch the communication budget shrink
8x (port of ``examples/quickstart.py``).

  PYTHONPATH=src python examples/quickstart_torch.py               # card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The hot loop runs ``scan_chunk`` steps a dispatch: on the card the first
chunk runs eagerly and every later one replays one CUDA graph of the
chunk's steps (``TrainSession``), the update's quantizers on their
kernels (K15/K16/K11 for the log grid, K3/K4/K12 for Q_x); on the CPU
the same steps run through the kernels' plain versions.
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core.packing import pack_codes
from repro_torch.core.qadam import QAdamConfig, qadam
from repro_torch.core.quantizers import get_quantizer
from repro_torch.data.pipeline import batch_for_model
from repro_torch.models.model import Model
from repro_torch.train.session import SessionConfig, TrainSession
from repro_torch.tree import tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--chunk", type=int, default=10,
                    help="steps a dispatch (one CUDA graph on the card)")
    args = ap.parse_args(argv)

    cfg = get_config("yi-6b", smoke=True)  # 2-layer GQA toy
    model = Model(cfg)
    params = model.init(seed=0, device=args.device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"model: {cfg.name} (smoke) - {n_params / 1e6:.2f}M params "
          f"({args.device})")

    # Algorithm 1: log-grid Q_g (4-bit wire) + EF + amax-grid Q_x
    opt = qadam(QAdamConfig(alpha=3e-3, grad_q="log:6",
                            weight_q="uniform_amax:7",
                            weight_q_min_numel=2 ** 14))

    # wire accounting for one parameter tensor, to make the 8x concrete
    q = get_quantizer("log:6")
    leaf = params["blocks"]["attn"]["q"]
    qt = q.encode(leaf)
    packed = pack_codes(qt.codes, 4)
    print(f"example tensor {tuple(leaf.shape)}: fp32 wire "
          f"{leaf.numel() * 4 / 1e3:.1f}KB -> 4-bit codes "
          f"{packed.numel() / 1e3:.1f}KB "
          f"({leaf.numel() * 4 / packed.numel():.1f}x smaller)")

    def loss_fn(p, batch):
        ls, nt = model.loss(p, batch)
        return ls / nt

    chunk = args.chunk
    sess = TrainSession.from_optimizer(
        opt, loss_fn, params, batch_for_model(cfg, seq_len=64,
                                              global_batch=8),
        SessionConfig(log_every=chunk, scan_chunk=chunk),
        log=lambda *_: None)
    with sess:
        history = sess.run(args.steps)
        stats = dict(sess.stats)
    losses = [h for h in history if "loss" in h]
    for h in losses:
        print(f"steps {h['step'] - chunk + 1:3d}-{h['step']:3d}  "
              f"loss {h['loss']:.4f}")
    print(f"session stats: {stats}")
    assert losses[-1]["loss"] < losses[0]["loss"], "training must progress"
    print("done - loss decreasing under 4-bit update + 8-bit weight wire, "
          f"{chunk} steps per dispatch.")


if __name__ == "__main__":
    main()
