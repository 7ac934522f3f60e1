"""The chunked single-machine step builders (port of
``repro/opt/multistep.py``, which re-exports them from the session
module, their home):

    opt = qadam(QAdamConfig(...))
    chunk = make_chunked_train_step(opt, loss_fn)
    params, state, losses = chunk(params, state, stacked_batches)

K steps a call, K the stacked batches' leading size; on the card one
CUDA-graph replay once warmed up (``repro_torch.train.session``). For a
full loop prefer ``TrainSession.from_optimizer(opt, loss_fn, params,
batches, SessionConfig(scan_chunk=K))``.
"""
from __future__ import annotations

from repro_torch.train.session import (make_chunked_train_step,  # noqa: F401
                                       make_chunked_update, stack_batches)

__all__ = ["make_chunked_update", "make_chunked_train_step",
           "stack_batches"]
