"""Serving launcher: continuous-batching ServeSession with (optionally)
code-resident Q_x weights (port of ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b \
      --quantized --paged
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
      --quantized --paged

runs on the GPU (``--device cuda``, the default); ``--smoke --device cpu``
runs the small configuration on the CPU through the kernels' plain
versions. ``--arch`` takes the dense family of ``repro_torch.configs``:
yi-6b, gemma2-2b, gemma3-4b and qwen2.5-14b (llava-next-mistral-7b takes
embedding input, which the session does not serve, and is refused as
the reference refuses it), the MoE family: deepseek-moe-16b and
llama4-maverick-400b-a17b (the latter's 128 experts of 8192 a layer
do not fit one card at its 48 layers), and the SSM and hybrid family:
mamba2-2.7b (no K/V cache, so ``--paged`` exits with the reference's
message) and hymba-1.5b:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
      --smoke --device cpu --quantized
  PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
      --smoke --device cpu --quantized --paged

 Weights are random, drawn from
``--seed``; with ``--quantized`` each float32 leaf is dropped as soon
as its codes exist, so the start-up peak stays near the float32 tree
(qwen2.5-14b's 59 GB, deepseek-moe-16b's 67.5 GB, the largest leaf's
codes beside it). gemma2-2b's and gemma3-4b's heads are tied to their embedding:
quantized, both read the one table of codes (the lookup by row, the
head through the transposed dequant-matmul). The peak memory is
printed: the device's on a GPU, the process's resident set on the CPU.

The kernel build cache is on by default (``--compile-cache DIR``,
``--no-compile-cache``: ``repro_torch.perf.cache``), and ``--aot-dir
DIR`` keeps the decode step's kernel library as an AOT artifact: a
restart with a warm dir runs no ``nvcc`` (on a host without the CUDA
toolkit too), and ``stats`` shows ``aot_loads`` 1, ``compilations`` 0.
The start-up seconds (weights, kernel library, session) are printed.
"""
from __future__ import annotations

import argparse
import resource
import time


def quantize_in_place(params, **kw):
    """``quantize_params`` one leaf at a time, each float leaf of
    ``params`` (a nested dict, modified) replaced by its
    ``QuantizedLeaf`` as soon as its codes exist: the float tree and the
    codes never coexist whole."""
    from repro_torch.serve.quantized import quantize_params

    def walk(tree, path):
        for k in list(tree):
            if isinstance(tree[k], dict):
                walk(tree[k], path + (k,))
                continue
            sub = tree.pop(k)
            for name in reversed(path + (k,)):
                sub = {name: sub}
            q = quantize_params(sub, **kw)
            del sub
            for name in path + (k,):
                q = q[name]
            tree[k] = q
    walk(params, ())
    return params


def peak_memory(device) -> str:
    """The run's peak memory: allocated on a CUDA device, else the
    process's maximum resident set."""
    import torch
    if torch.device(device).type == "cuda":
        return (f"device peak {torch.cuda.max_memory_allocated(device)} B "
                "allocated")
    return (f"host peak resident set "
            f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024} B")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    help="yi-6b, gemma2-2b, gemma3-4b, qwen2.5-14b, "
                         "deepseek-moe-16b, llama4-maverick-400b-a17b, "
                         "mamba2-2.7b or hymba-1.5b (repro_torch.configs; "
                         "whisper-small is served through the model API "
                         "only, as in the reference)")
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
    ap.add_argument("--compile-cache", default=None, metavar="DIR",
                    help="kernel build cache dir (default "
                         "$REPRO_COMPILE_CACHE or the repository's build/)")
    ap.add_argument("--no-compile-cache", action="store_true")
    ap.add_argument("--aot-dir", default=None, metavar="DIR",
                    help="AOT artifact dir for the decode step's kernel "
                         "library (repro_torch.perf.aot): a warm restart "
                         "runs no nvcc")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.launch.train import setup_build_cache
    from repro_torch.serve import Request, ServeSession, params_nbytes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    setup_build_cache(args)
    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.arch_type == "encdec" or cfg.input_mode != "tokens":
        raise SystemExit("serve CLI demo supports token-input decoder LMs")
    if args.paged and cfg.arch_type == "ssm":
        raise SystemExit("pure-SSM models hold no KV cache to page")
    model = Model(cfg)
    params = model.init(seed=args.seed, device=args.device)
    fp_bytes = params_nbytes(params)
    if args.quantized:
        params = quantize_in_place(params, k_x=args.k_x,
                                   pack=not args.no_pack)
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
                           device=args.device, aot_dir=args.aot_dir)
    print(f"start-up {time.perf_counter() - t_start:.2f}s (weights, "
          f"kernel library, session)")
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
          f"{args.device}); stats={session.stats}; "
          f"{peak_memory(args.device)}")
    for i, h in enumerate(handles):
        r = results[h]
        print(f"  req{i}: {r.tokens[:12]}{'...' if len(r.tokens) > 12 else ''}"
              f" [{r.finish_reason}]")
    return results


if __name__ == "__main__":
    main()
