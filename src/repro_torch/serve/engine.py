"""Batch API: ``Engine.generate`` as a thin shim over
:class:`repro_torch.serve.session.ServeSession` (port of
``repro/serve/engine.py``)."""
from __future__ import annotations

from typing import List, Optional

from repro_torch.core import threefry as TF
from repro_torch.serve.quantized import quantize_params
from repro_torch.serve.session import Request, Result, ServeSession

__all__ = ["Engine", "Request", "Result"]


class Engine:
    """One-shot batch generation over one session per batch width."""

    def __init__(self, model, params, max_seq: int = 256,
                 quantized: bool = False, k_x: int = 6, device="cuda"):
        self.model = model
        self.cfg = model.cfg
        self.max_seq = max_seq
        self.device = device
        self.params = (quantize_params(params, k_x=k_x) if quantized
                       else params)
        self._session: Optional[ServeSession] = None

    def generate(self, requests: List[Request], key=None) -> List[Result]:
        # one session, grown only when a larger batch arrives; smaller
        # batches ride idle slots
        if self._session is None or self._session.slots < len(requests):
            self._session = ServeSession(self.model, self.params,
                                         slots=len(requests),
                                         max_seq=self.max_seq, seed=0,
                                         device=self.device)
        session = self._session
        # identical (requests, key) -> identical draws, the reference's
        session.reseed(key if key is not None else TF.prng_key(0))
        handles = [session.submit(r) for r in requests]
        results = session.drain()
        return [results[h] for h in handles]
