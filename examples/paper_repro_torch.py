"""The paper's experimental comparison at small scale (Tables 2-3
analogue), on the PyTorch port (``repro_torch``).

CIFAR/ResNet are not available offline, so the comparative protocol runs
on a synthetic Gaussian-cluster classification task with an MLP, as
``examples/paper_repro.py`` does: QADAM (ours) against TernGrad,
blockwise-EF SGD (Zheng et al.) and WQuan (post-training weight
quantization), at matched wire bits, with 8 workers whose updates the
server averages (Algorithm 2). ``--mode efadam`` adds two-way
compression: the server quantizes the averaged update it broadcasts with
a ``log:2`` codec and its own error feedback.

On the card every quantizer runs its kernel: the log-grid Q_g K15, K16
and K11; Q_x K3, K4 and K12; TernGrad K3 and #13; blockwise sign #14;
the server's log codec K3, #10 and K11.

  PYTHONPATH=src python examples/paper_repro_torch.py --steps 400
  PYTHONPATH=src python examples/paper_repro_torch.py --mode efadam
  PYTHONPATH=src python examples/paper_repro_torch.py --device cpu \\
      --steps 20 --seeds 1
"""
import argparse
import json

import numpy as np
import torch

from repro_torch.comm.codec import get_codec
from repro_torch.core.qadam import (QAdamConfig, apply_updates, ef_sgdm,
                                    qadam, terngrad_sgd, wquan)
from repro_torch.data.pipeline import (ClsDataConfig, classification_batches,
                                       classification_dataset)

HIDDEN = 256


def mlp_init(seed: int, d_in: int, d_hidden: int, n_classes: int,
             device="cuda"):
    """The reference's MLP (shapes and scales), its weights drawn from
    numpy's generator: torch cannot reproduce the reference's JAX draws,
    so a comparison carries the reference's parameters across instead
    (``repro_torch.convert.params_from_numpy``)."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape)
    p = {"w1": normal(d_in, d_hidden) / np.sqrt(d_in),
         "b1": np.zeros(d_hidden),
         "w2": normal(d_hidden, d_hidden) * 0.05,
         "b2": np.zeros(d_hidden),
         "w3": normal(d_hidden, n_classes) * 0.05,
         "b3": np.zeros(n_classes)}
    return {k: torch.from_numpy(v.astype(np.float32)).to(device)
            for k, v in p.items()}


def mlp_apply(p, x):
    h = torch.tanh(x @ p["w1"] + p["b1"])
    h = torch.tanh(h @ p["w2"] + p["b2"])
    return h @ p["w3"] + p["b3"]


def loss_fn(p, x, y):
    logp = torch.log_softmax(mlp_apply(p, x), dim=-1)
    return -logp.gather(1, y.long()[:, None]).mean()


def accuracy(p, x, y) -> float:
    return float((mlp_apply(p, x).argmax(-1) == y).to(torch.float32).mean())


def _grads(p, x, y):
    leaves = {k: v.detach().requires_grad_() for k, v in p.items()}
    with torch.enable_grad():
        gs = torch.autograd.grad(loss_fn(leaves, x, y), list(leaves.values()))
    return dict(zip(leaves, gs))


@torch.no_grad()
def run(opt, steps, data, params, batch=128, seed=0, n_workers=8,
        server_q=None, server_ef=True):
    """The multi-worker protocol: each worker takes its own minibatch and
    its own optimizer state (``worker`` keys its draws); the server
    applies the mean of the workers' (quantized) updates, Algorithm 2.
    The workers run one after another, in a loop.

    ``server_q`` (a codec spec, e.g. "log:2") turns on two-way
    compression: the server quantizes the averaged update it broadcasts,
    with its own error feedback when ``server_ef`` (the ``efadam``
    protocol, Chen et al. '22). Returns the final parameters."""
    xtr, ytr = data[0], data[1]
    params = {k: v.clone() for k, v in params.items()}
    states = [opt.init(params)._replace(worker=w) for w in range(n_workers)]
    codec = get_codec(server_q) if server_q else None
    es = {k: torch.zeros_like(v) for k, v in params.items()}
    its = [classification_batches(xtr, ytr, batch, seed=seed + w)
           for w in range(n_workers)]
    for _ in range(steps):
        upds = []
        for w in range(n_workers):
            x, y = next(its[w])
            g = _grads(opt.forward_params(params, states[w]), x, y)
            upd, states[w] = opt.update(g, states[w], params)
            upds.append(upd)
        mean_upd = {k: torch.stack([u[k] for u in upds]).mean(0)
                    for k in params}
        if codec is not None:
            for k, u in mean_upd.items():
                send = u + es[k]
                scale = codec.compute_scale(send)
                q = codec.dequantize(codec.quantize(send, scale), scale)
                es[k] = send - q if server_ef else torch.zeros_like(send)
                mean_upd[k] = q
        params = apply_updates(params, mean_upd)
    return params


def methods(mode: str, server_q: str = "log:2"):
    """name -> (optimizer, its arguments, k_x of WQuan after training or
    None, server codec spec or None, server EF): the reference's methods
    and learning rates. ``build`` makes the optimizer."""
    def adam(**kw):
        return "qadam", dict(alpha=2e-3, **kw)
    if mode == "efadam":
        sq = server_q
        return {
            # one-way (worker channel only) vs two-way, matched bits
            "QADAM log-3bit 1way": (*adam(grad_q="log:2"), None, None, True),
            f"EFADAM 2way {sq}": (*adam(grad_q="log:2"), None, sq, True),
            f"EFADAM 2way {sq} no-srv-EF": (*adam(grad_q="log:2"), None, sq,
                                            False),
            "EFADAM fp32 workers 2way": (*adam(grad_q=None), None, sq, True),
        }
    return {
        "QADAM fp32": (*adam(grad_q=None, weight_q=None), None, None, True),
        "QADAM log-3bit": (*adam(grad_q="log:2"), None, None, True),
        "QADAM log-2bit": (*adam(grad_q="log:1"), None, None, True),
        "QADAM log-3bit no-EF": (*adam(grad_q="log:2", error_feedback=False),
                                 None, None, True),
        "QADAM + Qx(k=5)": (*adam(grad_q="log:2", weight_q="uniform_amax:5"),
                            None, None, True),
        "WQuan(k=5) post": (*adam(grad_q=None, weight_q=None), 5, None,
                            True),
        "TernGrad": ("terngrad_sgd", dict(alpha=2e-2), None, None, True),
        "Blockwise-EF SGD": ("ef_sgdm", dict(alpha=2e-3, beta=0.9,
                                             grad_q="blockwise:256"),
                             None, None, True),
    }


def build(kind: str, kw: dict):
    """The optimizer of a method: ``qadam`` of a ``QAdamConfig(**kw)``,
    or ``ef_sgdm(**kw)`` / ``terngrad_sgd(**kw)``."""
    if kind == "qadam":
        return qadam(QAdamConfig(**kw))
    return {"ef_sgdm": ef_sgdm, "terngrad_sgd": terngrad_sgd}[kind](**kw)


def compare(mode="qadam", steps=400, seeds=3, workers=8, server_q="log:2",
            device="cuda", log=print):
    """Every method of ``mode`` over ``seeds`` seeds -> [(name, mean test
    accuracy, its std)]. The data is the reference's (seed 1); seed s
    draws the MLP from numpy seed s and the batches from seeds s * 100 +
    worker."""
    data = classification_dataset(ClsDataConfig(seed=1), device=device)
    xte, yte = data[2], data[3]
    rows = []
    for name, (kind, kw, wq_after, srv_q, srv_ef) in methods(
            mode, server_q).items():
        accs = []
        for s in range(seeds):
            p0 = mlp_init(s, xte.shape[1], HIDDEN, int(data[1].max()) + 1,
                          device)
            p = run(build(kind, kw), steps, data, p0, seed=s * 100,
                    n_workers=workers, server_q=srv_q, server_ef=srv_ef)
            if wq_after is not None:
                p = wquan(p, k_x=wq_after, absolute=False)
            accs.append(accuracy(p, xte, yte))
        rows.append((name, float(np.mean(accs)), float(np.std(accs))))
        log(f"{name:28s} acc {np.mean(accs) * 100:.2f} "
            f"+/- {np.std(accs) * 100:.2f}%")
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--mode", default="qadam", choices=["qadam", "efadam"],
                    help="efadam: two-way compression - the server also "
                         "quantizes the broadcast update, with its own EF")
    ap.add_argument("--server-q", default="log:2",
                    help="efadam server->worker codec spec")
    ap.add_argument("--adaptive", action="store_true",
                    help="not ported (ROADMAP.md queue 1 item 5)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.adaptive:
        raise NotImplementedError(
            "--adaptive needs the port of repro.adapt, which is not ported "
            "yet (ROADMAP.md queue 1 item 5)")
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the "
                         "plain versions on the CPU")
    rows = compare(args.mode, args.steps, args.seeds, args.workers,
                   args.server_q, args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump([{"method": n, "acc": a, "std": s}
                       for n, a, s in rows], f, indent=1)


if __name__ == "__main__":
    main()
