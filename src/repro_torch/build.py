"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``. Objects and
libraries live in a build cache (``perf.cache``; ``build/`` at the
repository root unless set), each object named by the hash of its
source, the headers, the flags, the compiler's version and the card's
compute capability, so a checkout builds on first use, a changed source
recompiles its own object alone, and a warm cache compiles nothing.
Every build, warm or cold, needs ``nvcc`` (its version is part of each
object's key); a host without the toolkit starts from an AOT artifact
(``perf.aot``). Nothing here runs at import time.

Flags keep IEEE division, square root and rounding (no
``--use_fast_math``): the quantize, dequantize, Adam+EF, wire codec,
blockwise, lane pack, gather and threefry kernels are held bitwise against
their plain versions; the two products (K1 and K1t dequant-matmul) and
flash attention (#17) sum in fp32 in orders of their own. The grids and lanes
they share live in ``csrc/grids.cuh``, the tensor-core and copy
primitives of the tensor-core routes (K1, K1t, #17) in ``csrc/mma.cuh``;
the hash covers both.
"""
from __future__ import annotations

import atexit
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# --split-compile 0: the device code's optimization on every core (the
# K1 routes' templates make dequant_matmul.cu the longest object: 228 s
# alone, 96 s split, on the 8 host cores beside an NVIDIA H100 80GB HBM3
# at 700 W)
CFLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                       "-Xptxas", "-v", "--split-compile", "0"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_U = ctypes.c_uint
# every C entry point returns cudaGetLastError() after its launch
SIGNATURES = {
    # x, codes, scale, out, ws, M, K, N, code_bits, k_x, x_bf16, w_bf16,
    # cast_bf16, m_tile, k_slice, slices, stream
    "rt_dequant_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _I, _I, _I, _I, _P],
    # x, codes, scale, out, M, d, V, code_bits, k_x, x_bf16, w_bf16,
    # cast_bf16, m_tile, stream
    "rt_dequant_matmul_t": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                            _I, _P],
    # x, codes, scale, out, ws, M, K, N, code_bits, k_x, tile_n, k_slice,
    # slices, out_bf16, stream
    "rt_dequant_matmul_tc": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _I, _I, _P],
    # x, codes, scale, out, M, d, V, code_bits, k_x, out_bf16, stream
    "rt_dequant_matmul_t_tc": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # q, k, v, out, B, Sq, Skv, H, K, hd, causal, window, q_offset,
    # softcap, sm_scale, stream (_tc: bf16; _tc32: float32 in 3xTF32)
    "rt_flash_attention_tc": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _I, _I, _F, _F, _P],
    "rt_flash_attention_tc32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                _I, _I, _F, _F, _P],
    # pool_k, pool_v (or null), ptab, out_k, out_v (or null), B, npag,
    # num_pages, page_bytes, stream
    "rt_gather_pages": [_P, _P, _P, _P, _P, _I, _I, _I, _L, _P],
    # x, out_bits, rows, n, stream
    "rt_amax_rows": [_P, _P, _I, _L, _P],
    # x, scale, grid, codes, n, k_g, stream
    "rt_log_quantize": [_P, _P, _P, _P, _L, _I, _P],
    # x, u, scale, codes, n, stream
    "rt_ternary_quantize": [_P, _P, _P, _P, _L, _P],
    # codes, payload, rows, c, row_bytes, bits, code_bytes, stream
    "rt_pack_rows": [_P, _P, _I, _L, _L, _I, _I, _P],
    # payload, codes, rows, c, row_bytes, bits, stream
    "rt_unpack_rows": [_P, _P, _I, _L, _L, _I, _P],
    # x, scale, codes, rows, n, k_x, code_bytes, stream
    "rt_uniform_quantize_rows": [_P, _P, _P, _I, _L, _I, _I, _P],
    # g, m, v, e, hp, m_out, v_out, de_out, amax_bits, n, stream
    "rt_adam_moments": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _P],
    # de, scale, grid, table, half, codes, e_out, n, k_g, stream
    "rt_ef_quantize": [_P, _P, _P, _P, _I, _P, _P, _L, _I, _P],
    # codes, scale, table, half, out, n, stream
    "rt_log_dequantize": [_P, _P, _P, _I, _P, _L, _P],
    # codes, scale, out, rows, n, k_x, code_bytes, stream
    "rt_uniform_dequantize_rows": [_P, _P, _P, _I, _L, _I, _I, _P],
    # x, scale, payload, e_out, n, n_rows, c, row_bytes, kind, bits, k,
    # clip_abs, grid, table, half, blocks_per_sm, stream
    "rt_ef_encode_rows": [_P, _P, _P, _P, _L, _I, _L, _L, _I, _I, _I, _I,
                          _P, _P, _I, _I, _P],
    # x, u, scale, guard, scale_out, payload, n, n_rows, c, row_bytes, kind,
    # bits, k, clip_abs, grid, table, half, blocks_per_sm, stream
    "rt_encode_rows": [_P, _P, _P, _I, _P, _P, _L, _I, _L, _L, _I, _I, _I,
                       _I, _P, _P, _I, _I, _P],
    # payload, scales, table, half, out, out_n, n_rows, c, row_bytes, kind,
    # bits, k, blocks_per_sm, stream
    "rt_decode_rows": [_P, _P, _P, _I, _P, _L, _I, _L, _L, _I, _I, _I, _I,
                       _P],
    # keys_out, key, seed_hi, seed_lo, t, n_leaves, worker, mode, stream
    "rt_threefry_keys": [_P, _P, _U, _U, _P, _I, _U, _I, _P],
    # out, n, start, keys, leaf, stream
    "rt_threefry_uniform": [_P, _L, _L, _P, _I, _P],
    # out, n, start, keys, n_rows, a, span, std, stream
    "rt_threefry_trunc_normal": [_P, _L, _L, _P, _I, _F, _F, _F, _P],
    # logits, temp, rng, B, V, partials, greedy, sampled, stream
    "rt_threefry_categorical": [_P, _P, _P, _I, _I, _P, _P, _P, _P],
    # x, codes, scales, n, nb, log2 block, stream
    "rt_blockwise_quantize": [_P, _P, _P, _L, _L, _I, _P],
    # x, payload, scales, n, nb, payload_bytes, log2 block, stream
    "rt_blockwise_encode": [_P, _P, _P, _L, _L, _L, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None
build_log = ""   # nvcc's output of the last build in this process
# where the loaded library came from: "built" (this process ran nvcc),
# "cache" (a build directory held it), "aot" (an AOT artifact,
# ``perf.aot``); None before the first load
origin: Optional[str] = None
# nvcc runs of this process: objects compiled and libraries linked
stats = {"objects_compiled": 0, "links": 0}

# the build cache (``perf.cache``): ``DEFAULT_CACHE_DIR`` unless set; None
# is a process-private temporary directory (every process builds)
DEFAULT_CACHE_DIR = BUILD_DIR
_cache_dir: Optional[Path] = DEFAULT_CACHE_DIR
_cache_set = False        # set_cache_dir was called in this process
_private: Optional[Path] = None
_lib_path: Optional[Path] = None
_lib_objects: List[Path] = []   # the objects the loaded library came from
_nvcc_version: Dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (without it, start "
                       "from a warm --aot-dir: repro_torch.perf.aot)")


def _sources(csrc: Path = CSRC):
    return sorted(csrc.glob("*.cu")), sorted(csrc.glob("*.cuh"))


def source_digest(csrc: Path = CSRC) -> str:
    """Digest of every source and header and the flags: what a library
    built from this checkout is, known without the toolkit (the AOT
    artifacts' key holds it)."""
    cus, hdrs = _sources(csrc)
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for p in cus + hdrs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def capability() -> str:
    """The card's compute capability, e.g. ``"sm_90"``."""
    major, minor = torch.cuda.get_device_capability()
    return f"sm_{major}{minor}"


def _nvcc_version_of(nvcc: str) -> str:
    if nvcc not in _nvcc_version:
        res = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True)
        _nvcc_version[nvcc] = res.stdout
    return _nvcc_version[nvcc]


def object_key(src: Path, hdrs, nvcc_version: str, cc: str) -> str:
    """An object's cache key: its source's bytes, every header's, the
    flags, the compiler's version and the card's compute capability."""
    h = hashlib.sha256(src.name.encode() + b"\0" + src.read_bytes())
    for p in hdrs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(CFLAGS).encode())
    h.update(nvcc_version.encode())
    h.update(cc.encode())
    return h.hexdigest()[:20]


def _atomic_write(path: Path, data: bytes) -> None:
    tmp = path.with_name(f".{path.name}.tmp.{os.getpid()}")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def build_library(cache: Path, csrc: Path = CSRC):
    """The library of ``csrc``'s sources in the cache directory ``cache``,
    built where missing: each object keyed by :func:`object_key`
    (``<stem>-<key>.o``), compiled only when its key is absent, all
    missing ones by their own ``nvcc`` started together; the library
    keyed by its objects' keys and linked only when absent. Returns
    ``(library path, [objects compiled], linked, objects, log)``."""
    cache = Path(cache)
    cache.mkdir(parents=True, exist_ok=True)
    cus, hdrs = _sources(csrc)
    cc = capability()
    nvcc = nvcc_path()
    version = _nvcc_version_of(nvcc)
    objs = [cache / f"{src.stem}-{object_key(src, hdrs, version, cc)}.o"
            for src in cus]
    libkey = hashlib.sha256(" ".join(
        [o.name for o in objs] + ARCH_FLAGS).encode()).hexdigest()[:16]
    lib = cache / f"librepro_torch_{libkey}.so"
    compiled, logs, linked = [], [], False
    if not lib.exists():
        procs = []
        for src, obj in zip(cus, objs):
            if obj.exists():
                continue
            tmp = obj.with_name(f".{obj.name}.tmp.{os.getpid()}")
            cmd = [nvcc, *CFLAGS, "-I", str(csrc), "-c", str(src),
                   "-o", str(tmp)]
            procs.append((src, obj, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, obj, tmp, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode:
                failed.append(src.name)
            else:
                os.replace(tmp, obj)
                compiled.append(src.name)
        stats["objects_compiled"] += len(compiled)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_so = lib.with_name(f".{lib.name}.tmp.{os.getpid()}")
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_so),
                *(str(o) for o in objs), "-lcudart"]
        res = subprocess.run(link, capture_output=True, text=True)
        logs.append(f"== link\n{res.stdout}{res.stderr}")
        if res.returncode:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(logs))
        os.replace(tmp_so, lib)
        stats["links"] += 1
        linked = True
    return lib, compiled, linked, objs, "\n".join(logs)


def cache_dir() -> Path:
    """The directory builds go to: the configured cache, or this
    process's private temporary directory when the cache is off."""
    global _private
    if _cache_dir is not None:
        return _cache_dir
    if _private is None:
        _private = Path(tempfile.mkdtemp(prefix="repro_torch_build_"))
        atexit.register(shutil.rmtree, str(_private), True)
    return _private


def cache_setting() -> Tuple[Optional[Path], bool]:
    """``(cache dir or None when off, whether set in this process)``."""
    return _cache_dir, _cache_set


def set_cache_dir(path: Optional[os.PathLike]) -> None:
    """Point later builds at ``path`` (None: a private temporary
    directory). Where the library has loaded already, its objects and
    the library itself are written into ``path`` now, so the next
    process finds them there."""
    global _cache_dir, _cache_set
    _cache_dir = None if path is None else Path(path)
    _cache_set = True
    if _cache_dir is None or _lib_path is None:
        return
    _cache_dir.mkdir(parents=True, exist_ok=True)
    for src in [_lib_path] + list(_lib_objects):
        dst = _cache_dir / src.name
        if src.exists() and not dst.exists():
            _atomic_write(dst, src.read_bytes())


def install(path: os.PathLike, how: str) -> ctypes.CDLL:
    """Load the library at ``path`` with the C signatures and make it the
    one the wrappers launch; ``how`` becomes :data:`origin`."""
    global _lib, _lib_path, origin
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib, _lib_path, origin = lib, Path(path), how
    return lib


def loaded_path() -> Optional[Path]:
    """The file of the loaded library (None before the first load)."""
    return _lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first where the cache lacks it."""
    global build_log, _lib_objects
    if _lib is None:
        path, compiled, linked, objs, log = build_library(cache_dir())
        if log:
            build_log = log
        _lib_objects = objs
        install(path, "built" if linked or compiled else "cache")
    return _lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
