"""PyTorch + CUDA port of ``repro`` (Quantized Adam with Error Feedback).

The JAX package ``repro`` is the reference; this package mirrors its
module layout so every part has one counterpart to be held against.
It imports ``torch`` and numpy only, never ``jax`` or ``repro``.

The ported slice is code-resident quantized serving: ``Model`` (dense
GQA decoder), ``quantize_params`` (int codes + per-layer amax scales),
``ServeSession`` (slots, paged KV cache, chunked prefill, SLO
preemption) and the four hand-written Hopper kernels under ``csrc/``:

  * ``comm.matmul.dequant_matmul``   - fused dequant-matmul from codes;
  * ``serve.paged.gather_pages``     - page-table gather of the KV pool;
  * ``comm.kernels.amax_rows``       - per-row max|x|;
  * ``comm.kernels.uniform_quantize_rows`` - uniform Q_x codes.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on CPU tensors every kernel wrapper runs its plain PyTorch version.
"""
