"""Deterministic synthetic token batches (port of
``repro/data/pipeline.py``, token models).

numpy only: the same seed gives the reference's batches element for
element. Token streams have a Zipf-ish unigram structure plus copy
(induction) patterns, so a real LM can reduce its loss. Each batch is a
dict of host numpy arrays, ``tokens``, ``targets`` (the next token, pre-
shifted) and ``mask``; the training session stages them to the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

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
    """Model-aware synthetic batches. The port's models take tokens; the
    reference's embedding and audio front-end stubs are not ported."""
    if mcfg.input_mode != "tokens":
        raise NotImplementedError(
            f"input_mode={mcfg.input_mode!r}: the port's data pipeline "
            "makes token batches only (ROADMAP.md queue 1)")
    return lm_batches(LMDataConfig(vocab_size=mcfg.vocab_size,
                                   seq_len=seq_len,
                                   global_batch=global_batch, seed=seed))
