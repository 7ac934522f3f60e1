"""Device-resident gradient statistics for adaptive quantization (port of
``repro/adapt/stats.py``).

Per-leaf statistics are computed inside the train step (the ``adaptive``
mode's updater gives one row per leaf), reduced over the process group
and written into a device stats ring that ``TrainSession`` keeps beside
its loss ring: the rows stay on the device and are harvested in one
transfer at replan boundaries, so steady state adds no host sync.

Row layout (``STAT_FIELDS`` order, float32):

  ====  ==========  ==================================================
  col   field       reduction across workers
  ====  ==========  ==================================================
  0     ``amax``    max  - max |delta + e| over workers
  1     ``meansq``  mean - mean (delta + e)^2 (quantizer input power)
  2     ``gsq``     mean - mean g^2 (raw gradient power)
  ====  ==========  ==================================================

``local_stats`` and ``reduce_stats`` are plain tensor code (the
reference's are plain jnp, no Pallas kernel): the amax comes from K15's
fold where the updater has it, the two powers from one dot product each
(float32 sums in the library's order, not XLA's: the power columns agree
with the reference's to rounding, the amax bitwise). ``StatsEMA`` is the
host-side history the controller feeds to the allocator; its state
crosses to and from the reference's as the same JSON.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

STAT_FIELDS: Tuple[str, ...] = ("amax", "meansq", "gsq")
N_FIELDS = len(STAT_FIELDS)


def local_stats(de: torch.Tensor, g: torch.Tensor,
                amax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One ``(N_FIELDS,)`` float32 row for this worker's leaf.

    ``de`` is the quantizer input (delta + EF residual), the tensor whose
    amax and power drive grid selection; ``g`` the raw gradient. ``amax``
    (a 0-d float32 tensor, max |de|) spares the max pass where K15 has
    folded it."""
    de = de.reshape(-1).to(torch.float32)
    g = g.reshape(-1).to(torch.float32)
    if amax is None:
        amax = torch.linalg.vector_norm(de, ord=float("inf"))
    return torch.stack([amax.reshape(()).to(torch.float32),
                        torch.dot(de, de) / de.numel(),
                        torch.dot(g, g) / g.numel()])


def reduce_stats(rows: torch.Tensor, group=None,
                 n_workers: int = 1) -> torch.Tensor:
    """Reduce stacked ``(n_leaves, N_FIELDS)`` local rows over the
    group's workers: amax by an all-reduce MAX, the power columns as the
    reference's pmean, a sum over workers divided by their number (each
    worker's leaf is the same size, so the mean of means is the mean).
    One worker: the rows as they are (x / 1 is x). Written in place."""
    if n_workers == 1:
        return rows
    amax = rows[:, :1].contiguous()
    power = rows[:, 1:].contiguous()
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(power, op=dist.ReduceOp.SUM, group=group)
    rows[:, :1].copy_(amax)
    rows[:, 1:].copy_(power / n_workers)
    return rows


class StatsEMA:
    """Host-side debiased EMA over harvested stats rows.

    amax tracks a peak-hold EMA (max of decayed history and the new
    observation) so transient spikes do not immediately shrink the grid
    range; the power columns use plain debiased EMAs. float64 numpy, the
    reference's arithmetic in its order."""

    def __init__(self, n_leaves: int, decay: float = 0.8):
        if not 0.0 <= decay < 1.0:
            raise ValueError(f"decay must be in [0, 1), got {decay}")
        self.decay = float(decay)
        self._ema = np.zeros((n_leaves, N_FIELDS), np.float64)
        self._amax_peak = np.zeros(n_leaves, np.float64)
        self._weight = 0.0

    @property
    def count(self) -> float:
        return self._weight

    def update(self, rows: np.ndarray) -> None:
        rows = np.asarray(rows, np.float64)
        if rows.shape != self._ema.shape:
            raise ValueError(
                f"stats row shape {rows.shape} != {self._ema.shape}")
        d = self.decay
        self._ema = d * self._ema + (1.0 - d) * rows
        self._weight = d * self._weight + (1.0 - d)
        self._amax_peak = np.maximum(d * self._amax_peak, rows[:, 0])

    def _debiased(self) -> np.ndarray:
        if self._weight <= 0.0:
            raise RuntimeError("StatsEMA.update never called")
        return self._ema / self._weight

    @property
    def amax(self) -> np.ndarray:
        """Peak-held amax per leaf (never below the debiased EMA)."""
        return np.maximum(self._debiased()[:, 0], self._amax_peak)

    @property
    def meansq(self) -> np.ndarray:
        return self._debiased()[:, 1]

    @property
    def gsq(self) -> np.ndarray:
        return self._debiased()[:, 2]

    def snapshot(self) -> Optional[np.ndarray]:
        """Debiased ``(n_leaves, N_FIELDS)`` view, or None before data."""
        if self._weight <= 0.0:
            return None
        out = self._debiased().copy()
        out[:, 0] = np.maximum(out[:, 0], self._amax_peak)
        return out

    def state_dict(self) -> dict:
        """JSON-serializable full state (the reference's keys): rides in
        the checkpoint manifest's ``extra`` so an adaptive resume replans
        from the history an unbroken run would have had."""
        return {"decay": self.decay,
                "ema": self._ema.tolist(),
                "amax_peak": self._amax_peak.tolist(),
                "weight": self._weight}

    @classmethod
    def from_state(cls, state: dict) -> "StatsEMA":
        ema = np.asarray(state["ema"], np.float64)
        if ema.ndim != 2 or ema.shape[1] != N_FIELDS:
            raise ValueError(f"bad EMA state shape {ema.shape}")
        obj = cls(ema.shape[0], float(state["decay"]))
        obj._ema = ema
        obj._amax_peak = np.asarray(state["amax_peak"], np.float64)
        if obj._amax_peak.shape != (ema.shape[0],):
            raise ValueError(
                f"bad amax_peak shape {obj._amax_peak.shape}")
        obj._weight = float(state["weight"])
        return obj
