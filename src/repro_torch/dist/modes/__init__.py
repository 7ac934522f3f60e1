"""Per-mode distributed optimizer plugins (port of
``repro/dist/modes``): the paper's ``qadam``, the baselines it is
measured against, ``dp_adam`` (fp32 data-parallel Adam), ``efadam``
(two-way EF), ``terngrad`` (Wen et al. '17) and ``ef_sgd`` (Zheng et al.
'19), and ``adaptive`` (qadam with a per-leaf wire plan from
``repro_torch.adapt``)."""
from repro_torch.dist.modes.base import (  # noqa: F401
    ModeSpec,
    WorkerCtx,
    blockwise_exchange,
    ctx_groups,
    ctx_tiers,
    identity_codec,
    tier_grad_mean,
    worker_mean,
)
from repro_torch.dist.modes import (adaptive, dp_adam, ef_sgd, efadam,
                                    qadam, terngrad)

MODES = {m.SPEC.name: m.SPEC
         for m in (qadam, dp_adam, terngrad, ef_sgd, efadam, adaptive)}


def get_mode(name: str) -> ModeSpec:
    if name not in MODES:
        raise ValueError(f"unknown mode {name!r}; available: "
                         f"{sorted(MODES)}")
    return MODES[name]
