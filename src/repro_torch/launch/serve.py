"""Serving launcher: continuous-batching ServeSession with (optionally)
code-resident Q_x weights (port of ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
      --quantized --paged
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
      --quantized --paged

runs on the GPU (``--device cuda``, the default); ``--smoke --device cpu``
runs the small configuration on the CPU through the kernels' plain
versions. Weights are random, drawn from ``--seed``. gemma2-2b's head is
tied to its embedding: quantized, both read the one table of codes (the
lookup by row, the head through the transposed dequant-matmul).
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="yi-6b or gemma2-2b (repro_torch.configs)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--quantized", action="store_true",
                    help="code-resident Q_x weights (codes + scales;"
                         " projections run the fused dequant-matmul)")
    ap.add_argument("--k-x", type=int, default=6)
    ap.add_argument("--no-pack", action="store_true",
                    help="keep codes unpacked (one int8/int16 per code)"
                         " instead of the registry's 3/4/6-bit lanes")
    ap.add_argument("--no-fused-matmul", action="store_true",
                    help="dequantize-then-matmul instead of contracting"
                         " straight from codes (bypasses the dequant-matmul"
                         " kernel; counted in matmul.plain_on_cuda)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache: one physical page pool + per-slot"
                         " page tables")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=None)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--slo-mix", action="store_true",
                    help="tag requests round-robin interactive/standard/"
                         "batch to exercise priority admission+preemption")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.serve.quantized import params_nbytes, quantize_params
    from repro_torch.serve.session import Request, ServeSession

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch, smoke=args.smoke)
    model = Model(cfg)
    params = model.init(seed=args.seed, device=args.device)
    fp_bytes = params_nbytes(params)
    if args.quantized:
        params = quantize_params(params, k_x=args.k_x, pack=not args.no_pack)
        q_bytes = params_nbytes(params)
        print(f"arch={args.arch} params={fp_bytes / 1e6:.1f}MB fp32 -> "
              f"{q_bytes / 1e6:.1f}MB resident codes "
              f"({q_bytes / fp_bytes:.2f}x, measured)")
    else:
        print(f"arch={args.arch} params={fp_bytes / 1e6:.1f}MB fp32")

    session = ServeSession(model, params, slots=args.slots,
                           max_seq=args.max_seq, seed=args.seed,
                           fused_matmul=not args.no_fused_matmul,
                           paged=args.paged, page_size=args.page_size,
                           num_pages=args.num_pages,
                           prefill_chunk=args.prefill_chunk,
                           device=args.device)
    if args.paged:
        print(f"paged cache: {session.num_pages} pages x "
              f"{session.page_size} tokens "
              f"({session.num_pages * session.page_size} tokens vs "
              f"{args.slots * args.max_seq} fixed-lane)")
    rng = np.random.default_rng(args.seed)
    slos = ["interactive", "standard", "batch"]
    reqs = [Request(prompt=[int(t) for t in rng.integers(
                        1, cfg.vocab_size, size=args.prompt_len)],
                    max_new_tokens=args.max_new,
                    temperature=args.temperature,
                    slo=slos[i % 3] if args.slo_mix else "standard")
            for i in range(args.requests)]
    t0 = time.perf_counter()
    handles = [session.submit(r) for r in reqs]
    results = session.drain()
    dt = time.perf_counter() - t0
    total_new = sum(len(results[h].tokens) for h in handles)
    print(f"generated {total_new} tokens over {args.requests} requests on "
          f"{args.slots} slots in {dt:.2f}s ({total_new / dt:.1f} tok/s, "
          f"{args.device}); stats={session.stats}")
    for i, h in enumerate(handles):
        r = results[h]
        print(f"  req{i}: {r.tokens[:12]}{'...' if len(r.tokens) > 12 else ''}"
              f" [{r.finish_reason}]")
    return results


if __name__ == "__main__":
    main()
