"""Per-mode distributed optimizer plugins (port of
``repro/dist/modes``): the paper's ``qadam`` mode. The reference's other
modes (``dp_adam``, ``efadam``, ``terngrad``, ``ef_sgd``, ``adaptive``)
are queued in ROADMAP.md and raise ``NotImplementedError``."""
from repro_torch.dist.modes.base import (  # noqa: F401
    ModeSpec,
    WorkerCtx,
    ctx_tiers,
    worker_mean,
)
from repro_torch.dist.modes import qadam

MODES = {qadam.SPEC.name: qadam.SPEC}
NOT_PORTED = ("dp_adam", "efadam", "terngrad", "ef_sgd", "adaptive")


def get_mode(name: str) -> ModeSpec:
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"mode {name!r} is not ported yet (ROADMAP.md queue 1); the "
            f"port runs {sorted(MODES)}")
    if name not in MODES:
        raise ValueError(f"unknown mode {name!r}; available: "
                         f"{sorted(MODES)}")
    return MODES[name]
