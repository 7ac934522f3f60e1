"""Efficient-Adam-style two-way compression (Chen et al. '22; port of
``repro/dist/modes/efadam.py``): the paper's ``qadam`` worker channel
(K15 Adam+EF, log-grid Q_g on the exchange) PLUS server-side error
feedback on the weight broadcast:

    q_t    = Q_x(x_t + es_t)     (what every worker computes at)
    es_t+1 = (x_t + es_t) - q_t

``es`` is a chunk-sized state leaf; the broadcast in ``dist.step`` (keyed
off ``broadcast_ef``) sends K7's payload of ``chunk + es`` with its
scale computed from ``chunk + es`` and keeps K7's residual as ``es'``.
With ``weight_k=None`` the broadcast is float32, ``es`` stays zero and
the mode is ``qadam``.
"""
from __future__ import annotations

from repro_torch.dist.modes import qadam
from repro_torch.dist.modes.base import ModeSpec

SPEC = ModeSpec(name="efadam", chunk_sharded_moments=False,
                make_updater=qadam.make_updater,
                wire_codec=qadam.wire_codec,
                extra_state=("es",), broadcast_ef=True)
