"""Ahead-of-time step artifacts (port of ``repro/perf/aot.py``).

The reference serializes a compiled XLA executable. The port's step
compiles nothing but its kernel library: the model runs eagerly or as a
CUDA graph, and a captured graph cannot be written to disk (neither
PyTorch nor the CUDA runtime serializes one). So a step's artifact is
the linked kernel library it launches, with the facts it was built for,
stored under a key digesting everything its machine code depends on:
the caller's facts (train or serve config, grid, mode, codecs), the
abstract arguments (shapes, dtypes, devices), the card (name, compute
capability, count), the PyTorch and CUDA versions, and the digest of
the checkout's kernel sources and flags. A restart with a warm
``aot_dir`` loads the library with ``ctypes`` and runs no ``nvcc`` and
no link, so it serves and trains on a host without the CUDA toolkit.
Graph capture still happens in each process.

Artifact layout: ``<aot_dir>/<sha256[:24]>.aotstep``, a pickle of
``{format, torch, cuda, key_facts, library, payload}`` (``payload`` the
library's bytes); a load writes the library beside it as
``<key>.so``. Any load failure (missing, torn, another version, a
library that will not load) is a miss that builds: an AOT dir is a
cache, never a correctness dependency. On the CPU there is no library:
nothing is loaded, saved or counted.
"""
from __future__ import annotations

import dataclasses
import glob
import hashlib
import json
import os
import pickle
from typing import Any, Optional

import torch

from repro_torch import build

FORMAT = 1
SUFFIX = ".aotstep"


def _canon(obj):
    """Canonicalize config-ish objects into JSON-able structure."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {"__dc__": type(obj).__name__,
                **{f.name: _canon(getattr(obj, f.name))
                   for f in dataclasses.fields(obj)}}
    if isinstance(obj, dict):
        return {str(k): _canon(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_canon(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


def digest(facts: Any) -> str:
    blob = json.dumps(_canon(facts), sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:24]


def _abstract(tree) -> Any:
    """Shape/dtype/device signature of an argument tree. Python scalars
    abstract to their TYPE only: a step's value arguments (a ring slot,
    a step count) must not fork the key."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), str(tree.dtype), tree.device.type)
    if isinstance(tree, (bool, int, float)):
        return ("py", type(tree).__name__)
    if isinstance(tree, dict):
        return {str(k): _abstract(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return [_abstract(v) for v in tree]
    if hasattr(tree, "_fields") or dataclasses.is_dataclass(tree):
        names = (tree._fields if hasattr(tree, "_fields")
                 else [f.name for f in dataclasses.fields(tree)])
        return {"__type__": type(tree).__name__,
                **{n: _abstract(getattr(tree, n)) for n in names}}
    return tree if isinstance(tree, (str, type(None))) else repr(tree)


def _device_facts() -> dict:
    cuda = torch.cuda.is_available()
    return {
        "platform": "gpu" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "capability": list(torch.cuda.get_device_capability(0))
        if cuda else None,
        "n_devices": torch.cuda.device_count() if cuda else 0,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }


def step_key(facts: Any, args: tuple = ()) -> str:
    """Digest of (caller facts, abstract args, device, kernel sources) -
    the name the step's artifact is stored under."""
    return digest({"facts": facts, "args": _abstract(args),
                   "device": _device_facts(),
                   "sources": build.source_digest()})


def artifact_path(aot_dir: str, key: str) -> str:
    return os.path.join(aot_dir, key + SUFFIX)


def save(aot_dir: str, key: str, library_path, facts: Any = None) -> str:
    """Store the library at ``library_path`` under ``key``. Atomic
    (tmp + rename) so a crashed writer never leaves a torn artifact."""
    os.makedirs(aot_dir, exist_ok=True)
    with open(library_path, "rb") as f:
        payload = f.read()
    blob = pickle.dumps({
        "format": FORMAT,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "key_facts": _canon(facts),
        "library": os.path.basename(str(library_path)),
        "payload": payload,
    })
    path = artifact_path(aot_dir, key)
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
    return path


def _read(path: str) -> Optional[dict]:
    """The artifact at ``path`` (written by :func:`save`), or None when
    it is torn or of another format or version."""
    try:
        with open(path, "rb") as f:
            art = pickle.load(f)
    except Exception:   # a torn or foreign file is a miss, whatever broke
        return None
    if not isinstance(art, dict) or art.get("format") != FORMAT or \
            art.get("torch") != torch.__version__ or \
            art.get("cuda") != torch.version.cuda or \
            not isinstance(art.get("payload"), bytes):
        return None
    return art


def load(aot_dir: Optional[str], key: str):
    """Load the library stored under ``key`` and make it the one the
    kernels launch; returns its ``ctypes`` handle, or None when absent,
    torn, of another version or not loadable (every failure is a miss,
    never an error)."""
    if not aot_dir:
        return None
    path = artifact_path(aot_dir, key)
    if not os.path.exists(path):
        return None
    art = _read(path)
    if art is None:
        return None
    so = os.path.join(aot_dir, key + ".so")
    try:
        tmp = so + f".tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(art["payload"])
        os.replace(tmp, so)
        return build.install(so, "aot")
    except (OSError, AttributeError):   # unwritable, not loadable, or
        return None                     # without the kernels' symbols


def preload(aot_dir: Optional[str]) -> bool:
    """Before anything launches a kernel (a launcher's weights are
    quantized before its session exists): load the newest artifact in
    ``aot_dir`` built from this checkout's sources for this card, so
    nothing is compiled; the session's :func:`load_or_compile` then
    checks its own key. True when a library was loaded."""
    if not aot_dir or build._lib is not None or \
            not torch.cuda.is_available():
        return False
    arts = sorted(glob.glob(os.path.join(aot_dir, "*" + SUFFIX)),
                  key=os.path.getmtime, reverse=True)
    want = {"sources": build.source_digest(), "device": _device_facts()}
    for path in arts:
        art = _read(path)
        if art is None or art.get("key_facts", {}).get("built") != \
                _canon(want):
            continue
        key = os.path.basename(path)[:-len(SUFFIX)]
        if load(aot_dir, key) is not None:
            return True
    return False


def load_or_compile(step, args: tuple, *, aot_dir: Optional[str],
                    facts: Any, stats: Optional[dict] = None,
                    device=None):
    """The session-side entry point: make the kernel library that
    ``step(*args)`` launches ready, loading it from ``aot_dir`` when an
    artifact matches and building (the build cache first) and exporting
    one otherwise; returns ``step``.

    ``stats`` counters incremented: ``aot_loads`` on a hit,
    ``compilations`` when this process ran ``nvcc`` for the library,
    ``aot_saves`` after an export. On a non-CUDA ``device`` nothing is
    loaded, built or counted."""
    def bump(name):
        if stats is not None:
            stats[name] = stats.get(name, 0) + 1

    if device is None or torch.device(device).type != "cuda":
        return step
    key = step_key(facts, args) if aot_dir else None
    if aot_dir:
        if build._lib is None:
            load(aot_dir, key)
        if build.origin == "aot" and os.path.exists(
                artifact_path(aot_dir, key)):
            bump("aot_loads")
            return step
    runs = dict(build.stats)
    build.library()
    if build.stats != runs:            # nvcc compiled or linked just now
        bump("compilations")
    if aot_dir:
        save(aot_dir, key, build.loaded_path(),
             facts={"step": facts, "built": {
                 "sources": build.source_digest(),
                 "device": _device_facts()}})
        bump("aot_saves")
    return step
