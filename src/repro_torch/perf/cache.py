"""The kernel build cache (port of ``repro/perf/cache.py``, whose XLA
persistent compilation cache has no counterpart here: the port compiles
nothing but its CUDA kernels).

One switch for the whole repo: the launchers enable it by default (opt
out with ``--no-compile-cache``), the sessions enable it when the
``REPRO_COMPILE_CACHE`` variable names a directory (a library must not
repoint a process-wide setting on its own). Entries are addressed per
object (``build.object_key``: the source's bytes, the headers, the
flags, ``nvcc --version`` and the card's compute capability), and each
linked library by its objects, so processes sharing a directory never
compile an object twice, and a change to one source recompiles that
object alone and relinks.

Environment::

  REPRO_COMPILE_CACHE=<dir>   enable and place the cache (sessions too)
  REPRO_COMPILE_CACHE=0|off   force-disable, even in launchers

:data:`DEFAULT_CACHE_DIR` is the repository's ``build/`` (git-ignored),
where builds go when nothing is configured. Disabled, builds go to a
process-private temporary directory that is removed at exit, so every
process pays the build.
"""
from __future__ import annotations

import os
from typing import Optional

from repro_torch import build

ENV_VAR = "REPRO_COMPILE_CACHE"
DEFAULT_CACHE_DIR = str(build.DEFAULT_CACHE_DIR)

_OFF = ("0", "off", "false", "no")


def enable_persistent_cache(cache_dir: Optional[str] = None
                            ) -> Optional[str]:
    """Point the kernel builds at ``cache_dir``.

    Resolution order: explicit ``cache_dir`` > ``$REPRO_COMPILE_CACHE``
    > :data:`DEFAULT_CACHE_DIR`; an environment value of ``0``/``off``
    disables the cache and returns None. Where the library has loaded
    already, its objects are written into the directory now (so the
    next process hits). Returns the directory in use."""
    env = os.environ.get(ENV_VAR, "").strip()
    if cache_dir is None:
        if env.lower() in _OFF:
            disable_persistent_cache()
            return None
        cache_dir = env or DEFAULT_CACHE_DIR
    cache_dir = os.path.abspath(os.path.expanduser(cache_dir))
    os.makedirs(cache_dir, exist_ok=True)
    build.set_cache_dir(cache_dir)
    return cache_dir


def ensure_persistent_cache() -> Optional[str]:
    """Session-side hook: enable the cache iff ``$REPRO_COMPILE_CACHE``
    opts in (a directory configured in this process already wins)."""
    env = os.environ.get(ENV_VAR, "").strip()
    if not env or env.lower() in _OFF:
        return None
    current, configured = build.cache_setting()
    if configured and current is not None:
        return str(current)
    return enable_persistent_cache(env)


def disable_persistent_cache() -> None:
    """Later builds go to a process-private temporary directory."""
    build.set_cache_dir(None)


def cache_entries(cache_dir: str) -> int:
    """Objects and libraries on disk (temporary and partial files
    excluded)."""
    if not os.path.isdir(cache_dir):
        return 0
    return sum(1 for f in os.listdir(cache_dir)
               if f.endswith((".o", ".so")) and not f.startswith(".")
               and ".tmp" not in f)
