"""K1 fused dequant-matmul for code-resident Q_x weights (the serving hot
path; port of ``repro/comm/matmul.py``).

Replaces ``_matmul_pallas``: ``_mm_body``/``_mm_lut_body`` (K1,
``x @ W``) and the transposed branch ``_mm_t_body`` (K1t, ``x @ W.T``
from code rows, the tied logit head). The kernels live in
``csrc/dequant_matmul.cu`` (design notes there). All are bound by the
bytes of codes they stream at decode and chunk sizes, dequantize in
registers with the reference's exact cast chain and accumulate in fp32.
K1 and K1t each have two routes, picked by type (:func:`route`), each
with its own launch counter:

- ``"tc"``, tensor cores (``launches_tc``; the packed-lane calls among
  them also in ``launches_tc_packed``): bf16 activations against
  int8/int16 codes or packed 2/3/4/6-bit lanes whose weight is a bf16
  number. One pass over the codes for M <= 64, split across blocks along
  K where the columns alone cannot fill the card (:func:`k1_plan`), the
  slices' partial sums folded by a second kernel in a fixed order. The
  packed lanes are unpacked in registers as int8 codes are dequantized.
  Faster than ``torch.matmul`` on the dequantized bf16 weight at M = 4
  and 32 (``PERF.md``).
- ``"fma"``, CUDA cores (``launches_fma``): float32 activations or
  float32 weights, on any code type. Codes stream from device memory
  into registers in 16-byte loads, x is staged once a block, and each
  code byte is read once for M <= 32; K is split across blocks where the
  columns alone cannot fill the card (:func:`fma_plan`), the slices'
  partial sums folded by the same second kernel in a fixed order.

K1t's ``"tc"`` (``t_launches_tc``) computes ``out.T = W x.T``: 16 code
rows are the A operand of one MMA and up to 8 activation rows one n8 B
tile, the codes streamed from device memory straight into registers;
its ``"fma"`` (``t_launches_fma``) has the same structure with fp32 FMAs
for the MMA: persistent warps over groups of code rows streamed into
registers, x staged once a block in shared memory in 1-, 4- or 8-row
tiles (:func:`t_fma_plan`). ``t_launches`` counts both.

``launches`` counts both K1 routes. A failure of any route raises; none
falls back to the other or to the plain version. They cover every M, K,
N by masking the ragged edges, so the TPU tiling knobs (``mm_cols``,
``_MAX_FUSED_ROWS``, ``_pallas_covers``) have no counterpart here.

The plain version ``_matmul_torch`` is dequantize-then-matmul with the
product taken in float32 and rounded once to the output dtype.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from repro_torch import build
from repro_torch.comm import bits as B
from repro_torch.comm.codec import resolve_backend
from repro_torch.kernels.meta import charged
from repro_torch.opt import grids

launches = 0        # K1 launches, either route
launches_tc = 0     # K1 on tensor cores (route "tc")
launches_tc_packed = 0   # ... of them on packed 2/3/4/6-bit lanes
launches_fma = 0    # K1 on CUDA cores (route "fma")
t_launches = 0      # K1t (transposed) launches, either route
t_launches_tc = 0   # K1t on tensor cores (route "tc")
t_launches_fma = 0  # K1t on CUDA cores (route "fma")
plain_on_cuda = 0   # plain versions run on CUDA tensors

# the tensor-core route's tiles (csrc/dequant_matmul.cu, namespace tc)
TC_TILE_N = (128, 256)   # output columns a block: 4 or 8 warps
TC_TILE_K = 64      # K rows a pipeline stage
TC_TILE_M = 64      # activation rows a block (in 16-row MMA tiles)
TC_SLICE_ROWS = 32  # K slices are multiples of this many rows
TC_MAX_SLICES = 128
TC_CODE_BITS = (2, 3, 4, 6, 8, 16)   # packed lanes, int8, int16
SMS = 132           # streaming multiprocessors of an H100 SXM
# a block's fixed cost (pipeline fill, epilogue) in stages, for the
# split-K choice
TC_BLOCK_OVERHEAD = 4

_FLOATS = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(name: str) -> torch.dtype:
    if name not in _FLOATS:
        raise ValueError(f"dtype {name!r} not in {sorted(_FLOATS)}")
    return _FLOATS[name]


def dequant_codes(codes, scale, *, k_x, n, pack_bits, w_dtype, cast_dtype):
    """Codes (K, payload|n) -> weights, replicating the unfused cast chain
    ``dequantize() -> .astype(leaf dtype) -> .astype(cast dtype)``."""
    full = B.unpack_rows(codes, pack_bits, n) if pack_bits else codes
    w = grids.uniform_dequantize(full, scale, k_x).to(_dtype(w_dtype))
    if cast_dtype is not None:
        w = w.to(_dtype(cast_dtype))
    return w


def _out_dtype(x_dtype, w_dtype, cast_dtype):
    return torch.promote_types(x_dtype, _dtype(cast_dtype or w_dtype))


def _matmul_torch(x2, codes, scale, *, k_x, n, pack_bits, w_dtype,
                  cast_dtype, transpose=False):
    w = dequant_codes(codes, scale, k_x=k_x, n=n, pack_bits=pack_bits,
                      w_dtype=w_dtype, cast_dtype=cast_dtype).to(torch.float32)
    out = x2.to(torch.float32) @ (w.T if transpose else w)
    return out.to(_out_dtype(x2.dtype, w_dtype, cast_dtype))


def route(x_dtype, codes_dtype, pack_bits, w_dtype, cast_dtype) -> str:
    """Which kernel computes K1 (``x @ W``), or K1t (``x @ W.T``), on CUDA
    tensors: ``"tc"``
    (tensor cores) for bfloat16 activations against int8/int16 codes or
    packed uint8 lanes whose weight is a bf16 number (the leaf or the
    pending cast is bfloat16, so every product is exact in fp32);
    ``"fma"`` (CUDA cores, fmaf) for float32 activations and float32
    weights (on tensor cores their product would be TF32)."""
    bf16_w = _dtype(w_dtype) == torch.bfloat16 or (
        cast_dtype is not None and _dtype(cast_dtype) == torch.bfloat16)
    codes_ok = (codes_dtype == torch.uint8 if pack_bits
                else codes_dtype in (torch.int8, torch.int16))
    if x_dtype == torch.bfloat16 and bf16_w and codes_ok:
        return "tc"
    return "fma"


@dataclasses.dataclass(frozen=True)
class K1Plan:
    """A K1 route's launch for x (M, K) @ codes (K, N)."""
    m_tile: int                  # activation rows a block (a row tile)
    tile_n: int                  # output columns a block
    grid: Tuple[int, int, int]   # (column tiles, row tiles, K slices)
    k: int                       # K
    k_slice: int                 # K rows a slice (the last may be fewer)
    workspace: int               # fp32 partial sums (slices, M, N); 0 unsplit

    @property
    def slices(self) -> List[Tuple[int, int]]:
        """The K rows [k0, k1) each slice sums, in the fold's order."""
        return [(z * self.k_slice, min(self.k, (z + 1) * self.k_slice))
                for z in range(self.grid[2])]

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


# tuned tensor-core plans (``perf.autotune.tune_mm_cols``): (row tile, K,
# N, code bits) -> (tile_n, K slices). A launch geometry: a different
# slice count changes the fp32 sum order, so a tuned K1 is held to K1's
# tolerance, not bitwise. Install before any graph capture.
_MM_COLS_OVERRIDE: dict = {}


def mm_key(M: int, K: int, N: int, code_bits: int) -> tuple:
    """The key a tuned plan is installed under: K1's row tile for M, K,
    N and the code width."""
    return (16 if M <= 16 else 32 if M <= 32 else TC_TILE_M, int(K),
            int(N), int(code_bits))


def set_mm_cols(value: Optional[Tuple[int, int]], *, key: tuple) -> None:
    """Install ``(tile_n, slices)`` as K1's tensor-core plan for ``key``
    (:func:`mm_key`), or remove the override with None."""
    if value is None:
        _MM_COLS_OVERRIDE.pop(key, None)
        return
    tile_n, slices = (int(v) for v in value)
    if tile_n not in TC_TILE_N or not 1 <= slices <= TC_MAX_SLICES:
        raise ValueError(f"tile_n {tile_n} not in {TC_TILE_N} or slices "
                         f"{slices} outside [1, {TC_MAX_SLICES}]")
    _MM_COLS_OVERRIDE[key] = (tile_n, slices)


def _plan_of(M, K, N, m_tile, tile_n, slices) -> K1Plan:
    units = -(-K // TC_SLICE_ROWS)
    per = -(-units // max(1, min(slices, units)))
    s_eff = -(-units // per)
    return K1Plan(m_tile=m_tile, tile_n=tile_n,
                  grid=(-(-N // tile_n), -(-M // m_tile), s_eff), k=K,
                  k_slice=per * TC_SLICE_ROWS,
                  workspace=s_eff * M * N if s_eff > 1 else 0)


def k1_plan(M: int, K: int, N: int, code_bits: int) -> K1Plan:
    """The tensor-core route's grid, a pure function of the shapes and the
    code width (2, 3, 4, 6, 8 or 16 bits; a stage holds
    ``TC_TILE_K * tile_n * code_bits / 8`` code bytes, so narrower codes
    weigh the workspace's traffic more). Every code byte is read once for
    M <= 64 (one row tile). K is cut into slices of whole ``TC_SLICE_ROWS``
    units; their fp32 partial sums go to a workspace that a second pass
    folds in slice order. The count minimizes the waves of blocks over
    the SMs times a block's stages plus its fixed cost, plus the
    workspace's traffic, among the counts that give at least one block an
    SM where K allows. A plan that :func:`set_mm_cols` installed for
    these shapes takes precedence."""
    if code_bits not in TC_CODE_BITS or min(M, K, N) <= 0:
        raise ValueError(f"no tensor-core plan for M={M} K={K} N={N} "
                         f"{code_bits}-bit codes")
    m_tile = 16 if M <= 16 else 32 if M <= 32 else TC_TILE_M
    tuned = _MM_COLS_OVERRIDE.get(mm_key(M, K, N, code_bits))
    if tuned is not None:     # a plan tune_mm_cols installed
        return _plan_of(M, K, N, m_tile, *tuned)
    # 256 columns (wider rows of codes a copy) where that still gives a
    # quarter of the SMs a column tile each
    tile_n = TC_TILE_N[1] if -(-N // TC_TILE_N[1]) >= SMS // 4 \
        else TC_TILE_N[0]
    tiles = -(-N // tile_n) * -(-M // m_tile)
    units = -(-K // TC_SLICE_ROWS)
    stage_codes = TC_TILE_K * tile_n * code_bits // 8   # bytes a stage
    best = None
    for s in range(1, min(units, TC_MAX_SLICES) + 1):
        per = -(-units // s)                 # units a slice
        s_eff = -(-units // per)
        stages = -(-per * TC_SLICE_ROWS // TC_TILE_K)
        cost = -(-tiles * s_eff // SMS) * (stages + TC_BLOCK_OVERHEAD)
        if s_eff > 1:   # the workspace written and folded, in stages
            cost += 8 * s_eff * M * N / (SMS * stage_codes)
        key = (tiles * s_eff < SMS, cost, s_eff)
        if best is None or key < best[0]:
            best = (key, per, s_eff)
    _, per, slices = best
    k_slice = per * TC_SLICE_ROWS
    return K1Plan(m_tile=m_tile, tile_n=tile_n,
                  grid=(-(-N // tile_n), -(-M // m_tile), slices), k=K,
                  k_slice=k_slice,
                  workspace=slices * M * N if slices > 1 else 0)


# the CUDA-core route's tiles (csrc/dequant_matmul.cu, namespace fm)
FMA_TILE_N = 128          # output columns a block (8 warps, 4 a lane)
FMA_M_TILES = (4, 8, 16, 32)   # activation rows a block
FMA_SLICE_ROWS = 32       # K slices are multiples of this many rows
FMA_MAX_SLICES = 128
FMA_X_FLOATS = 16384      # staged x floats a block (64 KB of shared memory)
# a block's fixed cost (staging x, folding its warps) in 32-row units
FMA_BLOCK_OVERHEAD = 2


def fma_plan(M: int, K: int, N: int, code_bits: int) -> K1Plan:
    """The CUDA-core route's grid, a pure function of the shapes and the
    code width (2, 3, 4, 6, 8 or 16 bits). One row tile of x for M <= 32,
    so every code byte is read once a call. K is cut into slices of whole
    ``FMA_SLICE_ROWS`` units, no longer than the shared memory that
    stages x allows (``FMA_X_FLOATS / m_tile`` rows); their fp32 partial
    sums go to a workspace that a second pass folds in slice order. The
    count minimizes the waves of blocks over the SMs times a block's units
    plus its fixed cost, plus the workspace's traffic, among the counts
    that give at least one block an SM where K allows."""
    if code_bits not in TC_CODE_BITS or min(M, K, N) <= 0:
        raise ValueError(f"no CUDA-core plan for M={M} K={K} N={N} "
                         f"{code_bits}-bit codes")
    m_tile = next((t for t in FMA_M_TILES if M <= t), FMA_M_TILES[-1])
    tiles = -(-N // FMA_TILE_N) * -(-M // m_tile)
    units = -(-K // FMA_SLICE_ROWS)
    max_units = FMA_X_FLOATS // m_tile // FMA_SLICE_ROWS
    unit_codes = FMA_SLICE_ROWS * FMA_TILE_N * code_bits // 8   # bytes
    best = None
    for s in range(1, min(units, FMA_MAX_SLICES) + 1):
        per = -(-units // s)                 # units a slice
        if per > max_units:
            continue
        s_eff = -(-units // per)
        cost = -(-tiles * s_eff // SMS) * (per + FMA_BLOCK_OVERHEAD)
        if s_eff > 1:   # the workspace written and folded, in units
            cost += 8 * s_eff * M * N / (SMS * unit_codes)
        key = (tiles * s_eff < SMS, cost, s_eff)
        if best is None or key < best[0]:
            best = (key, per, s_eff)
    if best is None:
        raise ValueError(f"K={K} needs more than {FMA_MAX_SLICES} slices of "
                         f"{max_units * FMA_SLICE_ROWS} rows")
    _, per, slices = best
    return K1Plan(m_tile=m_tile, tile_n=FMA_TILE_N,
                  grid=(-(-N // FMA_TILE_N), -(-M // m_tile), slices), k=K,
                  k_slice=per * FMA_SLICE_ROWS,
                  workspace=slices * M * N if slices > 1 else 0)


# K1t on CUDA cores (csrc/dequant_matmul.cu, namespace ft): a block's
# shared memory, and the tiles of activation rows it stages
SMEM_BYTES = 232448       # a block's shared memory on sm_90
T_FMA_M_TILES = (1, 4, 8)


def t_fma_smem(d: int, code_bits: int, m_tile: int) -> int:
    """Bytes of K1t's staged x on CUDA cores: d in chunks of four code
    spans of a 16-byte vector's multiple (``tt::Span``), each span's
    positions ``m_tile`` floats a slot, then 16 bytes of pad."""
    span_bytes = {2: 16, 3: 48, 4: 32, 6: 48, 8: 32, 16: 32}[code_bits]
    cs = span_bytes * 8 // code_bits          # codes a span
    nchunks = -(-d // (4 * cs))
    return 4 * 4 * nchunks * (cs * m_tile + 4)


def t_fma_plan(M: int, d: int, code_bits: int) -> int:
    """K1t's row tile on CUDA cores: 1 for one activation row, 4 up to
    four, else 8 (a grid row per 8 more), or the largest smaller tile
    whose staged x fits a block's shared memory. Each code byte is read
    once per tile of rows."""
    if code_bits not in TC_CODE_BITS or min(M, d) <= 0:
        raise ValueError(f"no K1t CUDA-core plan for M={M} d={d} "
                         f"{code_bits}-bit codes")
    want = next((t for t in T_FMA_M_TILES if M <= t), T_FMA_M_TILES[-1])
    for m_tile in reversed(T_FMA_M_TILES):
        if m_tile <= want and t_fma_smem(d, code_bits, m_tile) <= SMEM_BYTES:
            if -(-M // m_tile) > 65535:
                break
            return m_tile
    raise ValueError(f"K1t on CUDA cores stages x in shared memory: d={d} "
                     f"at M={M} does not fit {SMEM_BYTES} bytes a block")


def _matmul_tc(x2, codes, scale, *, k_x, n, code_bits, out_dtype):
    """K1 on tensor cores (route "tc"), codes (K, n) int8/int16 or (K,
    payload) packed lanes of ``code_bits``."""
    global launches, launches_tc, launches_tc_packed
    M, K = x2.shape
    N = n
    plan = k1_plan(M, K, N, code_bits)
    out = torch.empty((M, N), dtype=out_dtype, device=x2.device)
    ws = (torch.empty(plan.workspace, dtype=torch.float32, device=x2.device)
          if plan.workspace else None)
    err = build.library().rt_dequant_matmul_tc(
        build.ptr(x2), build.ptr(codes), build.ptr(scale), build.ptr(out),
        build.ptr(ws) if ws is not None else None, M, K, N, code_bits, k_x,
        plan.tile_n, plan.k_slice, plan.grid[2],
        int(out_dtype == torch.bfloat16),
        build.stream_ptr(x2.device))
    build.check(err, "dequant_matmul_tc")
    launches += 1
    launches_tc += 1
    launches_tc_packed += code_bits < 8
    return out


def _matmul_t_tc(x2, codes, scale, *, k_x, n, code_bits, out_dtype):
    """K1t on tensor cores (route "tc"), code rows (V, n) int8/int16 or
    (V, payload) packed lanes of ``code_bits``."""
    global t_launches, t_launches_tc
    M = x2.shape[0]
    V = codes.shape[0]
    out = torch.empty((M, V), dtype=out_dtype, device=x2.device)
    err = build.library().rt_dequant_matmul_t_tc(
        build.ptr(x2), build.ptr(codes), build.ptr(scale), build.ptr(out),
        M, n, V, code_bits, k_x, int(out_dtype == torch.bfloat16),
        build.stream_ptr(x2.device))
    build.check(err, "dequant_matmul_t_tc")
    t_launches += 1
    t_launches_tc += 1
    return out


def _matmul_cuda(x2, codes, scale, *, k_x, n, pack_bits, w_dtype,
                 cast_dtype, transpose=False):
    """K1 (``x @ W``, codes (K, n)) or, with ``transpose``, K1t
    (``x @ W.T``, codes (rows, n) contracted along n)."""
    global launches, launches_fma, t_launches, t_launches_fma
    M, K = x2.shape
    rows = codes.shape[0]
    if transpose and K != n:
        raise ValueError(f"x width {K} != code row width {n}")
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"activation dtype {x2.dtype} not float32/bfloat16")
    if pack_bits:
        if pack_bits not in (2, 3, 4, 6) or codes.dtype != torch.uint8:
            raise ValueError(f"packed codes need uint8 2/3/4/6-bit lanes, "
                             f"got {codes.dtype} at {pack_bits} bits")
        code_bits, width = pack_bits, B.payload_nbytes(n, pack_bits)
    elif codes.dtype == torch.int8:
        code_bits, width = 8, n
    elif codes.dtype == torch.int16:
        code_bits, width = 16, n
    else:
        raise ValueError(f"codes dtype {codes.dtype} not int8/int16/uint8")
    if codes.dim() != 2 or codes.shape[1] != width or (
            not transpose and rows != K):
        raise ValueError(f"codes {tuple(codes.shape)} != "
                         f"({'rows' if transpose else K}, {width})")
    if k_x > 14:
        raise ValueError(f"k_x={k_x} > 14")
    out_dtype = _out_dtype(x2.dtype, w_dtype, cast_dtype)
    if x2.dtype == torch.float32 and out_dtype != torch.float32:
        raise ValueError("float32 activations give float32 outputs")
    x2 = x2.contiguous()
    codes = codes.contiguous()
    scale = scale.to(torch.float32).reshape(()).contiguous()
    if route(x2.dtype, codes.dtype, pack_bits, w_dtype, cast_dtype) == "tc":
        tc = _matmul_t_tc if transpose else _matmul_tc
        return tc(x2, codes, scale, k_x=k_x, n=n, code_bits=code_bits,
                  out_dtype=out_dtype)
    lib = build.library()
    flags = (code_bits, k_x, int(x2.dtype == torch.bfloat16),
             int(_dtype(w_dtype) == torch.bfloat16),
             int(cast_dtype is not None
                 and _dtype(cast_dtype) == torch.bfloat16),
             int(out_dtype == torch.bfloat16), build.stream_ptr(x2.device))
    if out_dtype != torch.float32:
        raise ValueError(f"the CUDA-core route writes float32, not "
                         f"{out_dtype}")
    if transpose:
        m_tile = t_fma_plan(M, n, code_bits)
        out = torch.empty((M, rows), dtype=out_dtype, device=x2.device)
        err = lib.rt_dequant_matmul_t(
            build.ptr(x2), build.ptr(codes), build.ptr(scale),
            build.ptr(out), M, n, rows, *flags[:5], m_tile, flags[6])
        build.check(err, "dequant_matmul_t")
        t_launches += 1
        t_launches_fma += 1
        return out
    plan = fma_plan(M, K, n, code_bits)
    out = torch.empty((M, n), dtype=out_dtype, device=x2.device)
    ws = (torch.empty(plan.workspace, dtype=torch.float32, device=x2.device)
          if plan.workspace else None)
    err = lib.rt_dequant_matmul(
        build.ptr(x2), build.ptr(codes), build.ptr(scale), build.ptr(out),
        build.ptr(ws) if ws is not None else None, M, K, n, *flags[:5],
        plan.m_tile, plan.k_slice, plan.grid[2], flags[6])
    build.check(err, "dequant_matmul")
    launches += 1
    launches_fma += 1
    return out


def _flops(x, codes, scale, *, n, transpose=False, **_):
    """2 M K N: K1's (``x @ W``) or K1t's (``x @ W.T``) products (the
    dry run's operation count)."""
    M = x.numel() // x.shape[-1]
    other = codes.shape[0] if transpose else n
    return 2.0 * M * x.shape[-1] * other


@charged("K1 dequant_matmul", flops=_flops)
def dequant_matmul(x, codes, scale, *, k_x: int, n: int, pack_bits: int = 0,
                   w_dtype: str = "float32", cast_dtype: Optional[str] = None,
                   transpose: bool = False,
                   backend: Optional[str] = None) -> torch.Tensor:
    """``x @ W`` (or ``x @ W.T``) where W exists only as integer codes.

    x: (..., K) activations ((..., n) against code rows for
    ``transpose``). codes: (K, n) int8/int16 codes, or packed uint8 rows
    (K, payload_nbytes(n, pack_bits)); for ``transpose`` (rows, n) or
    (rows, payload), contracted along their unpacked width n, giving
    (..., rows). scale: the per-tensor f32 scale (a 0-d tensor; a
    stacked leaf's caller passes one layer's). n: the logical width of a
    code row. w_dtype / cast_dtype: the leaf's dtype and the pending
    ``astype`` target, replicated in that order.
    """
    global plain_on_cuda
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    kw = dict(k_x=k_x, n=n, pack_bits=pack_bits, w_dtype=w_dtype,
              cast_dtype=cast_dtype, transpose=transpose)
    if resolve_backend(backend, x2, codes) == "cuda":
        out2 = _matmul_cuda(x2, codes, scale, **kw)
    else:
        plain_on_cuda += x2.is_cuda
        out2 = _matmul_torch(x2, codes, scale, **kw)
    return out2.reshape(lead + (out2.shape[-1],))
