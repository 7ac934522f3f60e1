"""PyTorch + CUDA port of ``repro`` (Quantized Adam with Error Feedback).

The JAX package ``repro`` is the reference; this package mirrors its
module layout so every part has one counterpart to be held against.
It imports ``torch`` and numpy only, never ``jax`` or ``repro``.

Three slices are ported, each through its entry point:

  * serving (``launch.serve``): code-resident Q_x weights
    (``quantize_params``) behind a paged, chunked-prefill
    ``ServeSession``;
  * single-machine training, Algorithm 1 (``core.qadam`` +
    ``TrainSession.from_optimizer``);
  * distributed training, Algorithms 2+3 (``launch.train``:
    ``dist.step.make_train_step`` on a ``launch.mesh.Grid`` of
    ``torch.distributed`` ranks + ``TrainSession.from_artifacts``), the
    paper's ``qadam`` mode and its baselines, on the flat or the
    hierarchical topology, with the model axis (context parallelism).

Their ten hand-written Hopper kernels live under ``csrc/`` (K1
dequant-matmul, K2 page gather, K3 amax, K4 uniform quantize, K6 wire
decode, K7 wire EF encode, K11 log dequantize, K12 uniform dequantize,
K15 Adam+EF moments, K16 EF quantize), each beside its plain PyTorch
version and a launch counter; ``PERF.md`` has the table.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on CPU tensors every kernel wrapper runs its plain PyTorch version.
"""
