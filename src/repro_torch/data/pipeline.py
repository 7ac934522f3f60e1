"""Deterministic synthetic data (port of ``repro/data/pipeline.py``:
token, embedding-input and audio-input models, and the classification
task of the paper's comparison).

numpy only: the same seed gives the reference's data element for
element. Token streams have a Zipf-ish unigram structure plus copy
(induction) patterns, so a real LM can reduce its loss. Each batch is a
dict of host numpy arrays, ``tokens``, ``targets`` (the next token, pre-
shifted) and ``mask``; the training session stages them to the device.
The classification task is Gaussian clusters (the reference's stand-in
for the paper's MNIST/CIFAR runs), generated in numpy and handed over as
tensors on a named device; its batches index those tensors there.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class LMDataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    copy_period: int = 64   # induction structure: token repeats each period


def _zipf_probs(vocab: int, a: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-a)
    return (p / p.sum()).astype(np.float64)


def lm_batches(cfg: LMDataConfig) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(cfg.seed)
    probs = _zipf_probs(cfg.vocab_size, cfg.zipf_a)
    B, S, P = cfg.global_batch, cfg.seq_len, cfg.copy_period
    while True:
        toks = rng.choice(cfg.vocab_size, size=(B, S + 1), p=probs)
        # induction heads: second half of each period copies the first
        half = P // 2
        for start in range(0, S + 1 - P, P):
            toks[:, start + half:start + P] = toks[:, start:start + half]
        toks = toks.astype(np.int32)
        yield {
            "tokens": np.ascontiguousarray(toks[:, :-1]),
            "targets": np.ascontiguousarray(toks[:, 1:]),
            "mask": np.ones((B, S), np.float32),
        }


def batch_for_model(mcfg: ModelConfig, seq_len: int, global_batch: int,
                    seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Model-aware synthetic batches, bitwise the reference's. The stubbed
    front-ends draw from ``default_rng(seed + 1)``, once a batch after
    its tokens, ``normal(scale=0.7)`` in float32: an embedding-input
    model (llava's vision tower) gets ``embeds`` (B, S, d) in place of
    ``tokens``; an audio-input model (whisper's mel+conv front-end) gets
    ``audio`` (B, encoder_seq, d) frame embeddings beside them."""
    if mcfg.input_mode not in ("tokens", "embeddings", "audio+tokens"):
        raise NotImplementedError(
            f"input_mode={mcfg.input_mode!r}: the port's data pipeline "
            "makes token, embedding and audio batches")
    base = lm_batches(LMDataConfig(vocab_size=mcfg.vocab_size,
                                   seq_len=seq_len,
                                   global_batch=global_batch, seed=seed))
    if mcfg.input_mode == "tokens":
        return base
    return _with_stub(base, mcfg, seq_len, global_batch, seed)


def _with_stub(base, mcfg: ModelConfig, seq_len: int, global_batch: int,
               seed: int) -> Iterator[Dict[str, np.ndarray]]:
    rng = np.random.default_rng(seed + 1)
    for b in base:
        b = dict(b)
        if mcfg.input_mode == "embeddings":
            b.pop("tokens")
            b["embeds"] = rng.normal(size=(global_batch, seq_len,
                                           mcfg.d_model),
                                     scale=0.7).astype(np.float32)
        else:
            b["audio"] = rng.normal(size=(global_batch, mcfg.encoder_seq,
                                          mcfg.d_model),
                                    scale=0.7).astype(np.float32)
        yield b


@dataclasses.dataclass
class ClsDataConfig:
    # the reference's defaults: full-precision 8-worker Adam lands at
    # ~60-70 % test accuracy in a few hundred steps, where the paper's
    # method comparisons (Tables 2-3) differentiate
    n_features: int = 32
    n_classes: int = 50
    n_train: int = 8192
    n_test: int = 2048
    cluster_std: float = 2.2
    seed: int = 0


def classification_dataset(cfg: ClsDataConfig, device="cuda"):
    """Gaussian clusters with class-dependent low-rank structure ->
    (x_train, y_train, x_test, y_test): float32 features and int32
    labels, on ``device``, bitwise the reference's arrays."""
    rng = np.random.default_rng(cfg.seed)
    centers = rng.normal(size=(cfg.n_classes, cfg.n_features)) * 1.5
    mix = rng.normal(size=(cfg.n_features, cfg.n_features)) / np.sqrt(
        cfg.n_features)

    def sample(n):
        y = rng.integers(0, cfg.n_classes, size=n)
        x = centers[y] + rng.normal(size=(n, cfg.n_features)) * cfg.cluster_std
        x = np.tanh(x @ mix)  # nonconvex twist
        return x.astype(np.float32), y.astype(np.int32)

    xtr, ytr = sample(cfg.n_train)
    xte, yte = sample(cfg.n_test)
    return tuple(torch.from_numpy(a).to(device) for a in (xtr, ytr, xte, yte))


def classification_batches(x: torch.Tensor, y: torch.Tensor, batch: int,
                           seed: int = 0):
    """Endless minibatches (x[idx], y[idx]), the indices drawn as the
    reference draws them (numpy, ``seed``), gathered on x's device."""
    rng = np.random.default_rng(seed)
    n = int(x.shape[0])
    replace = batch > n
    if replace:
        warnings.warn(
            f"classification_batches: batch={batch} exceeds dataset size "
            f"n={n}; sampling with replacement", stacklevel=2)
    while True:
        idx = torch.from_numpy(rng.choice(n, size=batch, replace=replace))
        idx = idx.to(x.device)
        yield x[idx], y[idx]
