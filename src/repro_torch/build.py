"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``. The library
lives in ``build/`` at the repository root, named by a hash of the
sources and flags, so a checkout builds it on first use and reuses it
after. Nothing here runs at import time.

Flags keep IEEE division, square root and rounding (no
``--use_fast_math``): the quantize, dequantize, Adam+EF, wire codec,
blockwise, lane pack and gather kernels are held bitwise against their plain
versions; the two products (K1 and K1t dequant-matmul) and flash
attention (#17) sum in fp32 in orders of their own. The grids and lanes
they share live in ``csrc/grids.cuh``, the tensor-core and copy
primitives of the tensor-core routes (K1, K1t, #17) in ``csrc/mma.cuh``;
the hash covers both.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                       "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
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
    # clip_abs, grid, table, half, stream
    "rt_ef_encode_rows": [_P, _P, _P, _P, _L, _I, _L, _L, _I, _I, _I, _I,
                          _P, _P, _I, _P],
    # x, u, scale, guard, scale_out, payload, n, n_rows, c, row_bytes, kind,
    # bits, k, clip_abs, grid, table, half, stream
    "rt_encode_rows": [_P, _P, _P, _I, _P, _P, _L, _I, _L, _L, _I, _I, _I,
                       _I, _P, _P, _I, _P],
    # payload, scales, table, half, out, out_n, n_rows, c, row_bytes, kind,
    # bits, k, stream
    "rt_decode_rows": [_P, _P, _P, _I, _P, _L, _I, _L, _L, _I, _I, _I, _P],
    # x, codes, scales, n, nb, log2 block, stream
    "rt_blockwise_quantize": [_P, _P, _P, _L, _L, _I, _P],
    # x, payload, scales, n, nb, payload_bytes, log2 block, stream
    "rt_blockwise_encode": [_P, _P, _P, _L, _L, _L, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None
build_log = ""   # nvcc's output of the last build in this process


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cus, hdrs = _sources()
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for p in cus + hdrs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> str:
    nvcc = nvcc_path()
    cus, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    logs = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in cus:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *CFLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, obj, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_so = Path(tmp) / out.name
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_so),
                *(str(obj) for _, obj, _ in procs), "-lcudart"]
        res = subprocess.run(link, capture_output=True, text=True)
        logs.append(f"== link\n{res.stdout}{res.stderr}")
        if res.returncode:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(logs))
        os.replace(tmp_so, out)
    return "\n".join(logs)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this checkout lacks it."""
    global _lib, build_log
    if _lib is None:
        path = library_path()
        if not path.exists():
            build_log = _compile(path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
