"""repro_torch.adapt - runtime-adaptive, accuracy-aware quantization (port
of ``repro.adapt``).

Three layers, host-driven, no steady-state host sync:

  * :mod:`repro_torch.adapt.stats`      - per-leaf gradient statistics
    (amax / mean-square) computed inside the train step and kept in the
    session's device stats ring, and their host-side EMA.
  * :mod:`repro_torch.adapt.allocate`   - the bit-allocation policy:
    per-leaf lane widths from the 2/3/4/6/8/16 set under a total
    wire-byte budget, minimizing expected quantization distortion.
  * :mod:`repro_torch.adapt.controller` - the host replan loop: harvest
    the stats, re-solve the plan, swap the step at replan boundaries
    with the state (masters, moments, EF residuals) carried bitwise.

``controller`` pulls in the dist/train stack, which itself imports the
``adaptive`` mode (-> this package), so it is loaded lazily through
``__getattr__`` to keep the import graph acyclic.
"""
from repro_torch.adapt import allocate, stats  # noqa: F401
from repro_torch.adapt.allocate import (  # noqa: F401
    Group,
    WIDTH_SPECS,
    WIDTHS,
    allocate_specs,
    baseline_cost,
    expected_distortion,
    plan_cost,
)
from repro_torch.adapt.stats import N_FIELDS, STAT_FIELDS, StatsEMA  # noqa: F401

_CONTROLLER_NAMES = ("AdaptConfig", "AdaptiveController", "plan_for_model",
                     "leaf_groups_for", "measured_exchange_bytes",
                     "measured_tier_bytes", "verify_accounting")


def __getattr__(name):
    if name in _CONTROLLER_NAMES or name == "controller":
        # importlib, not a from-import: that form probes this attribute
        # again before the submodule lands on the package and recurses
        import importlib
        controller = importlib.import_module("repro_torch.adapt.controller")
        return controller if name == "controller" else getattr(controller,
                                                               name)
    raise AttributeError(
        f"module 'repro_torch.adapt' has no attribute {name!r}")
