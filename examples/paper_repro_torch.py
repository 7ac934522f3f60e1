"""The paper's experimental comparison at small scale (Tables 2-3
analogue), on the PyTorch port (``repro_torch``).

CIFAR/ResNet are not available offline, so the comparative protocol runs
on a synthetic Gaussian-cluster classification task with an MLP, as
``examples/paper_repro.py`` does: QADAM (ours) against TernGrad,
blockwise-EF SGD (Zheng et al.) and WQuan (post-training weight
quantization), at matched wire bits, with 8 workers whose updates the
server averages (Algorithm 2). ``--mode efadam`` adds two-way
compression: the server quantizes the averaged update it broadcasts with
a ``log:2`` codec and its own error feedback. ``--adaptive`` compares
the paper's fixed k_g = 6 wire against ``repro_torch.adapt``'s per-leaf
bit allocation under a byte budget (``--budget``, replans every
``--replan-every`` steps), at measured bytes a step.

On the card every quantizer runs its kernel: the log-grid Q_g K15, K16
and K11; Q_x K3, K4 and K12; TernGrad K3 and #13; blockwise sign #14;
the server's log codec K3, #10 and K11; the adaptive arms' lanes K3 with
#10 and K11 (log), K4 and K12 (uniform_amax) or #14 (blockwise), and #5
(#14 and #9) for the measured bytes.

  PYTHONPATH=src python examples/paper_repro_torch.py --steps 400
  PYTHONPATH=src python examples/paper_repro_torch.py --mode efadam
  PYTHONPATH=src python examples/paper_repro_torch.py --device cpu \\
      --steps 20 --seeds 1
  PYTHONPATH=src python examples/paper_repro_torch.py --adaptive
"""
import argparse
import json

import numpy as np
import torch

from repro_torch.comm.codec import get_codec
from repro_torch.core import threefry
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


def _worker_states(opt, params, n_workers: int):
    """Each worker's own optimizer state, its PRNG key the optimizer's
    folded with the worker index (``fold_in(key, w)``), as the
    reference's protocol keys its workers."""
    states = [opt.init(params) for _ in range(n_workers)]
    return [s._replace(key=threefry.fold_in(s.key.cpu(), w).to(s.key.device))
            for w, s in enumerate(states)]


@torch.no_grad()
def run(opt, steps, data, params, batch=128, seed=0, n_workers=8,
        server_q=None, server_ef=True):
    """The multi-worker protocol: each worker takes its own minibatch and
    its own optimizer state (its key the optimizer's folded with the
    worker index, so TernGrad's draws are independent across workers and
    the reference's); the server
    applies the mean of the workers' (quantized) updates, Algorithm 2.
    The workers run one after another, in a loop.

    ``server_q`` (a codec spec, e.g. "log:2") turns on two-way
    compression: the server quantizes the averaged update it broadcasts,
    with its own error feedback when ``server_ef`` (the ``efadam``
    protocol, Chen et al. '22). Returns the final parameters."""
    xtr, ytr = data[0], data[1]
    params = {k: v.clone() for k, v in params.items()}
    states = _worker_states(opt, params, n_workers)
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


# ---------------------------------------------------------------------------
# --adaptive: fixed k_g against runtime-adaptive per-leaf bit allocation
# (repro_torch.adapt) under the same multi-worker protocol
# ---------------------------------------------------------------------------

def _leaf_payload_bytes(numel: int, spec: str, device) -> int:
    """Measured wire bytes of one worker's payload of one leaf: a real
    tensor encoded with the spec's codec (#5, or #14 and #9)."""
    from repro_torch.comm import bits as B
    from repro_torch.comm import codec as CD
    from repro_torch.comm import kernels as K
    from repro_torch.opt import engine
    codec = CD.get_codec(spec)
    x = torch.linspace(-1.0, 1.0, numel, dtype=torch.float32, device=device)
    if isinstance(codec, CD.BlockwiseCodec):
        codes2d, _ = engine.quantize_blockwise(x, codec.block)
        rows = B.pad_rows(codes2d.reshape(-1)[:numel], 1)
        return K.pack_rows(rows, codec.bits).nbytes
    payload, _ = CD.encode_rows(x, codec, 1)
    return payload.nbytes


def _quantize_leaf(codec, send):
    """deq(Q(send)) with the codec's own scale: the blockwise lanes'
    per-block scales (#14), else ``compute_scale`` (K3 for an amax)."""
    from repro_torch.comm import codec as CD
    from repro_torch.opt import engine
    if isinstance(codec, CD.BlockwiseCodec):
        flat = send.reshape(-1)
        codes, scales = engine.quantize_blockwise(flat, codec.block)
        deq = (codes.to(torch.float32) * scales[:, None]).reshape(-1)
        return deq[:flat.numel()].reshape(send.shape)
    scale = codec.compute_scale(send)
    return codec.dequantize(codec.quantize(send, scale), scale)


@torch.no_grad()
def run_quantized(steps, data, params, *, batch=128, seed=0, n_workers=8,
                  adaptive=False, budget_ratio=0.6, replan_every=25,
                  fixed_spec="log:6", ema_decay=0.8):
    """The Algorithm-2 worker protocol with the quantizer hoisted out of
    the optimizer (the reference's ``run_quantized``): every worker sends
    Q(delta + e) per leaf with its own EF residual, the server applies
    the worker mean. ``adaptive`` swaps the per-leaf codecs every
    ``replan_every`` steps from the repro_torch.adapt allocator fed by
    the observed (amax, meansq) EMAs; otherwise every leaf stays on
    ``fixed_spec``. Returns ``(params, info)`` with the measured bytes a
    step, the plan log and the loss curve."""
    from repro_torch.adapt import allocate as A
    from repro_torch.adapt import stats as S
    from repro_torch.comm.codec import get_codec as codec_of
    xtr, ytr, xte, yte = data
    device = xtr.device
    params = {k: v.clone() for k, v in params.items()}
    opt = qadam(QAdamConfig(alpha=2e-3, grad_q=None, weight_q=None))
    states = _worker_states(opt, params, n_workers)
    es = [{k: torch.zeros_like(v) for k, v in params.items()}
          for _ in range(n_workers)]
    names = sorted(params)

    def plan_bytes(plan):
        return n_workers * sum(_leaf_payload_bytes(params[k].numel(), s,
                                                   device)
                               for k, s in zip(names, plan))

    ema = S.StatsEMA(len(names), ema_decay)
    plan = tuple(fixed_spec for _ in names)
    its = [classification_batches(xtr, ytr, batch, seed=seed + w)
           for w in range(n_workers)]
    plan_log = [{"step": 0, "plan": list(plan),
                 "bytes_per_step": plan_bytes(plan)}]
    total_bytes = 0
    curve = []   # (cumulative bytes, train loss)
    t = 0
    loss = None
    while t < steps:
        k = min(replan_every, steps - t) if adaptive else steps - t
        codecs = {n: codec_of(s) for n, s in zip(names, plan)}
        window_rows = []
        pb = plan_log[-1]["bytes_per_step"]
        for _ in range(k):
            qs, rows, losses = [], [], []
            for w in range(n_workers):
                x, y = next(its[w])
                fp = opt.forward_params(params, states[w])
                leaves = {n: v.detach().requires_grad_()
                          for n, v in fp.items()}
                with torch.enable_grad():
                    lw = loss_fn(leaves, x, y)
                    gs = torch.autograd.grad(lw, list(leaves.values()))
                upd, states[w] = opt.update(dict(zip(leaves, gs)),
                                            states[w], params)
                q, r = {}, []
                for n in names:
                    send = upd[n] + es[w][n]
                    deq = _quantize_leaf(codecs[n], send)
                    q[n] = deq
                    es[w][n] = send - deq
                    r.append(torch.stack([send.abs().amax(),
                                          (send * send).mean()]))
                qs.append(q)
                rows.append(torch.stack(r))
                losses.append(lw.detach())
            mean_upd = {n: torch.stack([q[n] for q in qs]).mean(0)
                        for n in names}
            rows = torch.stack(rows)
            window_rows.append(torch.cat([rows[:, :, :1].amax(0),
                                          rows[:, :, 1:].mean(0)], dim=1))
            params = apply_updates(params, mean_upd)
            loss = float(torch.stack(losses).mean())
            total_bytes += pb
            curve.append((total_bytes, loss))
        t += k
        if adaptive and t < steps:
            for r in torch.stack(window_rows).cpu().numpy():
                ema.update(np.concatenate(
                    [r, np.zeros((len(names), 1))], axis=1))
            snap = ema.snapshot()
            groups = [A.Group(name=n, numel=params[n].numel(),
                              c=params[n].numel(), amax=float(snap[i, 0]),
                              meansq=float(snap[i, 1]))
                      for i, n in enumerate(names)]
            budget = int(budget_ratio *
                         A.baseline_cost(groups, n_workers, width=4))
            new = A.allocate_specs(groups, budget, n_workers)
            if new != plan:
                plan = new
                plan_log.append({"step": t, "plan": list(plan),
                                 "bytes_per_step": plan_bytes(plan)})
    curve = [(int(b), float(l)) for b, l in curve]
    return params, {"bytes_per_step": total_bytes / steps,
                    "total_bytes": total_bytes, "plan_log": plan_log,
                    "final_test_loss": float(loss_fn(params, xte, yte)),
                    "curve": curve}


def run_adaptive_compare(steps=400, seeds=3, workers=8, budget=0.6,
                         replan_every=25, device="cuda", out=None,
                         log=print):
    """The fixed k_g = 6 arm against the adaptive arm (the reference's
    ``run_adaptive_compare``): final test loss, accuracy and measured
    bytes a step over ``seeds`` seeds, the adaptive arm's plan log;
    returns ``(results, summary)`` and writes them to ``out`` (JSON)."""
    data = classification_dataset(ClsDataConfig(seed=1), device=device)
    xte, yte = data[2], data[3]
    arms = {"fixed k_g=6 (log:6)": False, "adaptive": True}
    results = {}
    for name, adaptive in arms.items():
        losses, accs, infos = [], [], []
        for s in range(seeds):
            p0 = mlp_init(s, xte.shape[1], HIDDEN, int(data[1].max()) + 1,
                          device)
            p, info = run_quantized(
                steps, data, p0, seed=s * 100, n_workers=workers,
                adaptive=adaptive, budget_ratio=budget,
                replan_every=replan_every)
            losses.append(info["final_test_loss"])
            accs.append(accuracy(p, xte, yte))
            infos.append(info)
        results[name] = {
            "loss": float(np.mean(losses)), "loss_std": float(np.std(losses)),
            "acc": float(np.mean(accs)),
            "bytes_per_step": float(np.mean(
                [i["bytes_per_step"] for i in infos])),
            "plan_log": infos[0]["plan_log"],
            "curve": infos[0]["curve"]}
        log(f"{name:22s} loss {np.mean(losses):.4f} "
            f"+/- {np.std(losses):.4f}  acc {np.mean(accs) * 100:.2f}%  "
            f"{np.mean([i['bytes_per_step'] for i in infos]) / 1e3:.1f}"
            f"KB/step")
    fx, ad = results["fixed k_g=6 (log:6)"], results["adaptive"]
    summary = {"bytes_ratio": ad["bytes_per_step"] / fx["bytes_per_step"],
               "loss_parity": fx["loss"] / ad["loss"]}
    log(f"adaptive/fixed bytes: {summary['bytes_ratio']:.3f}x  "
        f"loss parity (fixed/adaptive): {summary['loss_parity']:.4f}")
    for e in ad["plan_log"]:
        lanes = {}
        for s in e["plan"]:
            lanes[s] = lanes.get(s, 0) + 1
        log(f"  plan @{e['step']}: "
            + " ".join(f"{s}x{n}" for s, n in sorted(lanes.items()))
            + f"  ({e['bytes_per_step'] / 1e3:.1f}KB/step)")
    if out:
        with open(out, "w") as f:
            json.dump({"results": results, "summary": summary}, f, indent=1)
    return results, summary


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
                    help="compare fixed k_g=6 against repro_torch.adapt's "
                         "runtime bit allocation, measured bytes/step")
    ap.add_argument("--budget", type=float, default=0.6,
                    help="--adaptive: byte budget vs the fixed wire")
    ap.add_argument("--replan-every", type=int, default=25)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the "
                         "plain versions on the CPU")
    if args.adaptive:
        run_adaptive_compare(args.steps, args.seeds, args.workers,
                             args.budget, args.replan_every, args.device,
                             args.out)
        return
    rows = compare(args.mode, args.steps, args.seeds, args.workers,
                   args.server_q, args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump([{"method": n, "acc": a, "std": s}
                       for n, a, s in rows], f, indent=1)


if __name__ == "__main__":
    main()
