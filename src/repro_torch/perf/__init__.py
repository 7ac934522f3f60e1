"""Performance tooling of the port (port of ``repro/perf``):

  * :mod:`repro_torch.perf.profiling` - ``torch.profiler`` trace harness
    with named scopes (NVTX ranges on the card);
  * :mod:`repro_torch.perf.cache`     - the kernel build cache, addressed
    per object, shared by the launchers and sessions;
  * :mod:`repro_torch.perf.aot`       - ahead-of-time step artifacts: the
    linked kernel library a step launches, keyed on (config digest,
    grid, mode, codec, arguments, card, sources);
  * :mod:`repro_torch.perf.autotune`  - the kernels' launch geometry on
    the card (K1's tensor-core plan, the codec's blocks an SM) and the
    exchange bucket size.
"""
from repro_torch.perf import aot, autotune, cache, profiling
from repro_torch.perf.aot import load_or_compile, step_key
from repro_torch.perf.cache import (cache_entries, disable_persistent_cache,
                                    enable_persistent_cache,
                                    ensure_persistent_cache)
from repro_torch.perf.profiling import annotate, trace

__all__ = [
    "aot", "autotune", "cache", "profiling",
    "annotate", "trace",
    "cache_entries", "disable_persistent_cache", "enable_persistent_cache",
    "ensure_persistent_cache",
    "load_or_compile", "step_key",
]
