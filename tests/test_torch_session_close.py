"""``TrainSession.close()`` releases what the session holds for its
steps: the chunk runner's CUDA graph with its static batch and output
buffers, and the prefetcher's staged batches. The state stays readable,
a second ``close()`` does nothing, and a closed session that the caller
drops is freed by reference counting alone (no reference cycle keeps it
and its device memory alive until a garbage collection). The card's
side, the allocated bytes after a graphed session closes, is
``tests/test_torch_cuda_kernels.py -k close_frees``.
"""
import gc
import weakref

import pytest
import torch

from repro_torch.configs import get_config as tget
from repro_torch.core.qadam import QAdamConfig, qadam
from repro_torch.data.pipeline import batch_for_model
from repro_torch.models.model import Model
from repro_torch.train.session import SessionConfig, TrainSession

OPT = dict(alpha=1e-3, grad_q="log:6", weight_q="uniform_amax:7",
           weight_q_min_numel=2 ** 14)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _session(scan_chunk):
    model = Model(tget("yi-6b", smoke=True))

    def loss_fn(p, b):
        s, n = model.loss(p, b)
        return s / n
    return TrainSession.from_optimizer(
        qadam(QAdamConfig(**OPT)), loss_fn, model.init(seed=0, device="cpu"),
        batch_for_model(model.cfg, 16, 2), SessionConfig(
            log_every=scan_chunk, scan_chunk=scan_chunk),
        log=lambda *_: None)


@pytest.mark.parametrize("scan_chunk", [1, 2])
def test_close_releases_and_is_idempotent(scan_chunk):
    sess = _session(scan_chunk)
    sess.run(4)
    runner = sess._chunks
    if runner is not None:
        # what a capture on the card leaves behind
        runner.graph = object()
        runner._batch = {"tokens": torch.zeros(2, 16)}
        runner._outs = (torch.zeros(2),)
        runner.capture_s.append(0.5)
    state = sess.state
    sess.close()
    assert sess._chunks is None and sess._prefetch is None
    if runner is not None:
        assert runner.graph is None
        assert runner._batch is None and runner._outs is None
        assert sess.capture_seconds == [0.5]
    assert sess.state is state and len(sess.history) == 4 // scan_chunk
    sess.close()                                # a no-op
    assert sess._chunks is None and sess.state is state
    with pytest.raises(RuntimeError, match="closed"):
        sess.run(1)


@pytest.mark.parametrize("scan_chunk", [1, 2])
def test_closed_session_freed_without_collection(scan_chunk):
    """A first session warms the process (torch imports modules at the
    first checkpointed forward, and a frame of that call stays alive);
    the second, closed and dropped, goes without a collection, its
    state with it. The state's leaves pass ``tree_flatten_with_path``
    (a graph capture's check of them), which must hold none of them."""
    from repro_torch.tree import tree_flatten_with_path
    warm = _session(scan_chunk)
    warm.run(2)
    warm.close()
    del warm
    sess = _session(scan_chunk)
    sess.run(4)
    tree_flatten_with_path(sess.state)
    state_leaf = sess.state["params"]["embed"]
    gone_sess, gone_state = weakref.ref(sess), weakref.ref(state_leaf)
    del state_leaf
    gc.disable()
    try:
        sess.close()
        del sess
        assert gone_sess() is None and gone_state() is None
    finally:
        gc.enable()
