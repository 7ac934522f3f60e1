"""K3 per-row amax, K4 per-row uniform quantize, K12 per-row uniform
dequantize and K11 log-grid dequantize: the Q_x passes behind
``quantize_params`` and the training forward copy, and the Q_g decode of
the update. #10 log quantize and #13 ternary quantize: the code-level
Q_g and TernGrad quantizers (``LogCodec.quantize``,
``TernaryCodec.quantize``). #9 lane pack and unpack of (rows, c) codes.
K7 fused EF encode, #5 fused encode and K6 fused decode: the wire of the
distributed step (both channels, every codec with one scale per row).
#14 blockwise quantize and #8 blockwise encode: the sign codes and
per-block scales of the ``ef_sgd`` baselines.

Replace ``repro/comm/kernels.py`` ``amax_pallas``,
``uniform_quantize_pallas``, ``uniform_dequantize_pallas``,
``log_quantize_pallas``, ``log_dequantize_pallas``,
``ternary_quantize_pallas``, ``pack_pallas``, ``unpack_pallas``,
``ef_encode_pallas``, ``encode_pallas``, ``decode_pallas``,
``blockwise_quantize_pallas`` and ``encode_blockwise_pallas``. The
kernels live in ``csrc/quantize.cu``, ``csrc/dequantize.cu``,
``csrc/pack.cu``, ``csrc/codec.cu`` and ``csrc/blockwise.cu`` (design
notes there): all are bound by bytes. One launch covers every
row of a ``(rows, n)`` view, so a stacked ``(L, ...)`` leaf gets its L
per-layer scales (the reference's vmap over layers) in one launch, and a
whole leaf its one scale with rows = 1. K7, #5, K6 and #9 work in the
flat per-row lane layout of ``comm/bits.py`` ``pack_rows``/``unpack_rows``
(the wire contract), not the reference's VMEM tiling; #5's amax is K3's
kernel, launched on the flat x before the encode kernel, on one stream.

Beside each kernel: its plain PyTorch version, which a wrapper runs only
for CPU tensors or when asked with ``backend="torch"``, and plain-int
launch counters.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import build
from repro_torch.comm import bits as B
from repro_torch.comm.codec import resolve_backend
from repro_torch.opt import grids

amax_launches = 0          # K3 kernel launches
quantize_launches = 0      # K4 kernel launches
dequantize_launches = 0    # K12 kernel launches
log_dequantize_launches = 0  # K11 kernel launches
log_quantize_launches = 0    # #10 kernel launches
ternary_quantize_launches = 0  # #13 kernel launches
pack_launches = 0          # #9 pack kernel launches
unpack_launches = 0        # #9 unpack kernel launches
ef_encode_log_launches = 0       # K7 kernel launches, log codes
ef_encode_uniform_launches = 0   # K7 kernel launches, uniform codes
encode_log_launches = 0          # #5 encode launches, log codes
encode_uniform_launches = 0      # #5 encode launches, uniform codes
encode_ternary_launches = 0      # #5 encode launches, ternary codes
decode_log_launches = 0          # K6 kernel launches, log codes
decode_uniform_launches = 0      # K6 kernel launches, uniform codes
decode_ternary_launches = 0      # K6 kernel launches, ternary codes
blockwise_quantize_launches = 0  # #14 kernel launches
blockwise_encode_launches = 0    # #8 kernel launches
plain_on_cuda = 0          # plain versions run on CUDA tensors
# the same launches by codec spec (K7, #5, K6) or log grid (#10, K11): the
# adaptive plan's lanes counted apart (clear a dict to reset it)
by_spec = {"ef_encode": {}, "encode": {}, "decode": {}, "log_quantize": {},
           "log_dequantize": {}}


def _count(kernel: str, key) -> None:
    d = by_spec[kernel]
    d[key] = d.get(key, 0) + 1


def _check_rows(x2d: torch.Tensor) -> None:
    if x2d.dim() != 2 or x2d.dtype != torch.float32:
        raise ValueError(f"need a (rows, n) float32 tensor, got "
                         f"{tuple(x2d.shape)} {x2d.dtype}")
    if not 1 <= x2d.shape[0] <= 65535:
        raise ValueError(f"rows={x2d.shape[0]} outside [1, 65535]")


def _amax_rows_torch(x2d: torch.Tensor) -> torch.Tensor:
    return x2d.abs().amax(dim=1)


def _amax_rows_cuda(x2d: torch.Tensor) -> torch.Tensor:
    global amax_launches
    lib = build.library()
    x2d = x2d.contiguous()
    out = torch.zeros(x2d.shape[0], dtype=torch.float32, device=x2d.device)
    err = lib.rt_amax_rows(build.ptr(x2d), build.ptr(out), x2d.shape[0],
                           x2d.shape[1], build.stream_ptr(x2d.device))
    build.check(err, "amax_rows")
    amax_launches += 1
    return out


def amax_rows(x2d: torch.Tensor, backend: Optional[str] = None) -> torch.Tensor:
    """max|x| of every row of a (rows, n) float32 tensor -> (rows,)."""
    global plain_on_cuda
    _check_rows(x2d)
    if resolve_backend(backend, x2d) == "cuda":
        return _amax_rows_cuda(x2d)
    plain_on_cuda += x2d.is_cuda
    return _amax_rows_torch(x2d)


def _uniform_quantize_torch(x2d, scale, k_x):
    return grids.uniform_quantize(x2d, scale[:, None], k_x)


def _uniform_quantize_cuda(x2d, scale, k_x):
    global quantize_launches
    dtype = grids.uniform_code_dtype(k_x)
    if dtype not in (torch.int8, torch.int16):
        raise ValueError(f"k_x={k_x}: the kernel writes int8/int16 codes")
    lib = build.library()
    x2d = x2d.contiguous()
    scale = scale.to(torch.float32).contiguous()
    codes = torch.empty(x2d.shape, dtype=dtype, device=x2d.device)
    err = lib.rt_uniform_quantize_rows(
        build.ptr(x2d), build.ptr(scale), build.ptr(codes), x2d.shape[0],
        x2d.shape[1], k_x, codes.element_size(), build.stream_ptr(x2d.device))
    build.check(err, "uniform_quantize_rows")
    quantize_launches += 1
    return codes


def uniform_quantize_rows(x2d: torch.Tensor, scale: torch.Tensor, k_x: int,
                          backend: Optional[str] = None) -> torch.Tensor:
    """Uniform Q_x codes of a (rows, n) float32 tensor against one scale
    per row ((rows,) float32). int8 for k_x <= 6, int16 above."""
    global plain_on_cuda
    _check_rows(x2d)
    if scale.shape != (x2d.shape[0],):
        raise ValueError(f"scale {tuple(scale.shape)} != ({x2d.shape[0]},)")
    if resolve_backend(backend, x2d, scale) == "cuda":
        return _uniform_quantize_cuda(x2d, scale, k_x)
    plain_on_cuda += x2d.is_cuda
    return _uniform_quantize_torch(x2d, scale, k_x)


def _uniform_dequantize_cuda(codes2d, scale, k_x):
    global dequantize_launches
    if codes2d.dtype not in (torch.int8, torch.int16):
        raise ValueError(f"the kernel reads int8/int16 codes, got "
                         f"{codes2d.dtype}")
    lib = build.library()
    codes2d = codes2d.contiguous()
    scale = scale.to(torch.float32).contiguous()
    out = torch.empty(codes2d.shape, dtype=torch.float32,
                      device=codes2d.device)
    err = lib.rt_uniform_dequantize_rows(
        build.ptr(codes2d), build.ptr(scale), build.ptr(out),
        codes2d.shape[0], codes2d.shape[1], k_x, codes2d.element_size(),
        build.stream_ptr(codes2d.device))
    build.check(err, "uniform_dequantize_rows")
    dequantize_launches += 1
    return out


def uniform_dequantize_rows(codes2d: torch.Tensor, scale: torch.Tensor,
                            k_x: int, backend: Optional[str] = None
                            ) -> torch.Tensor:
    """``codes / 2^k_x * scale`` in float32 for a (rows, n) code tensor
    and one scale per row ((rows,) float32)."""
    global plain_on_cuda
    if codes2d.dim() != 2 or not 1 <= codes2d.shape[0] <= 65535:
        raise ValueError(f"need (rows, n) codes with 1 <= rows <= 65535, "
                         f"got {tuple(codes2d.shape)}")
    if scale.shape != (codes2d.shape[0],):
        raise ValueError(f"scale {tuple(scale.shape)} != "
                         f"({codes2d.shape[0]},)")
    if resolve_backend(backend, codes2d, scale) == "cuda":
        return _uniform_dequantize_cuda(codes2d, scale, k_x)
    plain_on_cuda += codes2d.is_cuda
    return grids.uniform_dequantize(codes2d, scale[:, None], k_x)


def _log_dequantize_cuda(codes, scale, k_g):
    global log_dequantize_launches
    lib = build.library()
    codes = codes.contiguous()
    scale = scale.reshape(1).contiguous()
    table = grids.log_table_on(k_g, codes.device)
    out = torch.empty(codes.shape, dtype=torch.float32, device=codes.device)
    err = lib.rt_log_dequantize(build.ptr(codes), build.ptr(scale),
                                build.ptr(table), table.shape[0] // 2,
                                build.ptr(out), codes.numel(),
                                build.stream_ptr(codes.device))
    build.check(err, "log_dequantize")
    log_dequantize_launches += 1
    _count("log_dequantize", f"log:{k_g}")
    return out


def log_dequantize(codes: torch.Tensor, scale: torch.Tensor, k_g: int,
                   backend: Optional[str] = None) -> torch.Tensor:
    """Q_g decode: int8 log-grid codes of any shape and one float32
    scale -> ``sign(c) * 2^(|c|-k_g-1) * scale`` in float32."""
    global plain_on_cuda
    if codes.dtype != torch.int8:
        raise ValueError(f"need int8 codes, got {codes.dtype}")
    if scale.numel() != 1 or scale.dtype != torch.float32:
        raise ValueError("scale must be one float32 value")
    if not 0 <= k_g <= grids.MAX_LOG_K:
        raise ValueError(f"k_g={k_g} outside [0, {grids.MAX_LOG_K}]")
    if resolve_backend(backend, codes, scale) == "cuda":
        return _log_dequantize_cuda(codes, scale, k_g)
    plain_on_cuda += codes.is_cuda
    return grids.log_dequantize(codes, scale.reshape(()), k_g)


def _check_scale(scale: torch.Tensor) -> None:
    if scale.numel() != 1 or scale.dtype != torch.float32:
        raise ValueError("scale must be one float32 value")


def _log_quantize_cuda(x, scale, k_g):
    global log_quantize_launches
    lib = build.library()
    x = x.contiguous()
    scale = scale.reshape(1).contiguous()
    codes = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    err = lib.rt_log_quantize(build.ptr(x), build.ptr(scale),
                              build.ptr(grids.log_grid_on(x.device)),
                              build.ptr(codes), x.numel(), k_g,
                              build.stream_ptr(x.device))
    build.check(err, "log_quantize")
    log_quantize_launches += 1
    _count("log_quantize", f"log:{k_g}")
    return codes


def log_quantize(x: torch.Tensor, scale: torch.Tensor, k_g: int,
                 backend: Optional[str] = None) -> torch.Tensor:
    """#10: int8 log-grid codes of float32 x (any shape) against one
    float32 scale on x's device: 0 encodes 0, and |c| in [1, k_g+1]
    encodes +/- 2^-(k_g+1-|c|), taken nearest in linear space
    (``grids.log_quantize``; the divisor is max(scale, 1e-30))."""
    global plain_on_cuda
    if x.dtype != torch.float32 or x.numel() < 1:
        raise ValueError(f"need a nonempty float32 tensor, got {x.dtype}")
    _check_scale(scale)
    if not 0 <= k_g <= grids.MAX_LOG_K:
        raise ValueError(f"k_g={k_g} outside [0, {grids.MAX_LOG_K}]")
    if resolve_backend(backend, x, scale) == "cuda":
        return _log_quantize_cuda(x, scale, k_g)
    plain_on_cuda += x.is_cuda
    return grids.log_quantize(x, scale.reshape(()), k_g)


def _ternary_quantize_cuda(x, u, scale):
    global ternary_quantize_launches
    lib = build.library()
    x, u = x.contiguous(), u.contiguous()
    scale = scale.reshape(1).contiguous()
    codes = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    err = lib.rt_ternary_quantize(build.ptr(x), build.ptr(u),
                                  build.ptr(scale), build.ptr(codes),
                                  x.numel(), build.stream_ptr(x.device))
    build.check(err, "ternary_quantize")
    ternary_quantize_launches += 1
    return codes


def ternary_quantize(x: torch.Tensor, u: torch.Tensor, scale: torch.Tensor,
                     backend: Optional[str] = None) -> torch.Tensor:
    """#13: TernGrad's int8 codes ``sign(x) * [u < |x| / max(s, 1e-30)]``
    of float32 x (any shape), from the uniforms ``u`` in [0, 1) (float32,
    x's numel, read at x's flat index, drawn by the caller) and one
    float32 scale on x's device. The division is the IEEE one."""
    global plain_on_cuda
    if x.dtype != torch.float32 or x.numel() < 1:
        raise ValueError(f"need a nonempty float32 tensor, got {x.dtype}")
    if u.dtype != torch.float32 or u.numel() != x.numel():
        raise ValueError("u must be float32 uniforms of x's numel")
    _check_scale(scale)
    if resolve_backend(backend, x, u, scale) == "cuda":
        return _ternary_quantize_cuda(x, u, scale)
    plain_on_cuda += x.is_cuda
    return grids.ternary_quantize(x, u.reshape(x.shape), scale.reshape(()))


# ---------------------------------------------------------------------------
# #9 lane pack and unpack (csrc/pack.cu)
# ---------------------------------------------------------------------------

_CODE_TYPES = (torch.int8, torch.int16)


def _check_lane(bits: int) -> None:
    if bits not in B.SUPPORTED_BITS:
        raise ValueError(f"lane width {bits} not in {B.SUPPORTED_BITS}")


def pack_rows(codes_rows: torch.Tensor, bits: int,
              backend: Optional[str] = None) -> torch.Tensor:
    """#9: (R, c) signed codes (int8 or int16) -> (R,
    ``payload_nbytes(c, bits)``) uint8 in ``comm/bits.py``'s lane layout,
    each row packed on its own (the tail group padded with zero codes),
    as ``bits.pack_rows``."""
    global plain_on_cuda, pack_launches
    _check_lane(bits)
    if codes_rows.dim() != 2 or codes_rows.dtype not in _CODE_TYPES:
        raise ValueError(f"need (rows, c) int8/int16 codes, got "
                         f"{tuple(codes_rows.shape)} {codes_rows.dtype}")
    rows, c = codes_rows.shape
    if not 1 <= rows <= 65535 or c < 1:
        raise ValueError(f"codes {tuple(codes_rows.shape)}: need 1 <= rows "
                         f"<= 65535 and c >= 1")
    if resolve_backend(backend, codes_rows) == "cuda":
        lib = build.library()
        codes_rows = codes_rows.contiguous()
        row_bytes = B.payload_nbytes(c, bits)
        payload = torch.empty((rows, row_bytes), dtype=torch.uint8,
                              device=codes_rows.device)
        err = lib.rt_pack_rows(build.ptr(codes_rows), build.ptr(payload),
                               rows, c, row_bytes, bits,
                               codes_rows.element_size(),
                               build.stream_ptr(codes_rows.device))
        build.check(err, "pack_rows")
        pack_launches += 1
        return payload
    plain_on_cuda += codes_rows.is_cuda
    return B.pack_rows(codes_rows, bits)


def unpack_rows(payload_rows: torch.Tensor, bits: int, c: int,
                backend: Optional[str] = None) -> torch.Tensor:
    """#9: (R, ``payload_nbytes(c, bits)``) uint8 -> (R, c) codes, int8
    (int16 for 16-bit lanes), as ``bits.unpack_rows``."""
    global plain_on_cuda, unpack_launches
    _check_lane(bits)
    if payload_rows.dim() != 2 or payload_rows.dtype != torch.uint8:
        raise ValueError(f"need (rows, nbytes) uint8 payload rows, got "
                         f"{tuple(payload_rows.shape)} {payload_rows.dtype}")
    rows, row_bytes = payload_rows.shape
    if not 1 <= rows <= 65535 or c < 1 or \
            row_bytes != B.payload_nbytes(c, bits):
        raise ValueError(f"payload rows {tuple(payload_rows.shape)} do not "
                         f"hold {c} codes of {bits} bits each")
    if resolve_backend(backend, payload_rows) == "cuda":
        lib = build.library()
        payload_rows = payload_rows.contiguous()
        codes = torch.empty((rows, c), dtype=torch.int16 if bits == 16
                            else torch.int8, device=payload_rows.device)
        err = lib.rt_unpack_rows(build.ptr(payload_rows), build.ptr(codes),
                                 rows, c, row_bytes, bits,
                                 build.stream_ptr(payload_rows.device))
        build.check(err, "unpack_rows")
        unpack_launches += 1
        return codes
    plain_on_cuda += payload_rows.is_cuda
    return B.unpack_rows(payload_rows, bits, c)


# ---------------------------------------------------------------------------
# K7 fused EF encode, #5 fused encode and K6 fused decode (the wire,
# csrc/codec.cu)
# ---------------------------------------------------------------------------

_KINDS = {"log": 0, "uniform": 1, "ternary": 2}


def _check_wire_codec(codec) -> None:
    if codec.kind not in _KINDS:
        raise ValueError(f"the wire kernels take log, uniform and ternary "
                         f"codecs, got {codec.kind!r}")
    if codec.bits not in B.SUPPORTED_BITS:
        raise ValueError(f"lane width {codec.bits} not in "
                         f"{B.SUPPORTED_BITS}")


def _wire_quantize(codec, x, scale, u=None):
    """The codec's codes of float32 x against ``scale`` (broadcasting),
    clipped to its lane where it clips (the reference's ``_quant``);
    ternary codes draw on the uniforms ``u`` of x's shape."""
    if codec.kind == "log":
        return grids.log_quantize(x, scale, codec.k)
    if codec.kind == "ternary":
        return grids.ternary_quantize(x, u, scale)
    codes = grids.uniform_quantize(x, scale, codec.k)
    if codec.clip_abs is not None:
        codes = torch.clamp(codes, -codec.clip_abs, codec.clip_abs)
    return codes


def _wire_dequantize(codec, codes, scale):
    if codec.kind == "log":
        return grids.log_dequantize(codes, scale, codec.k)
    if codec.kind == "ternary":
        return grids.ternary_dequantize(codes, scale)
    return grids.uniform_dequantize(codes, scale, codec.k)


def _check_flat_x(x: torch.Tensor, n_rows: int) -> None:
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"need a contiguous float32 tensor, got {x.dtype}")
    if not 1 <= n_rows <= 65535 or x.numel() < 1:
        raise ValueError(f"n_rows={n_rows} outside [1, 65535] or empty x")


def _log_tables(codec, device):
    """(grid, levels, half) pointers of a log codec's tables on
    ``device`` for the encode kernels; nulls for the other kinds."""
    if codec.kind != "log":
        return None, None, 0
    table = grids.log_table_on(codec.k, device)
    return (build.ptr(grids.log_grid_on(device)), build.ptr(table),
            table.shape[0] // 2)


def _ef_encode_rows_torch(flat, scale, codec, n_rows):
    s = scale.reshape(())
    codes = _wire_quantize(codec, flat, s)
    e_new = flat - _wire_dequantize(codec, codes, s)
    return B.pack_rows(B.pad_rows(codes, n_rows), codec.bits), e_new


def _ef_encode_rows_cuda(flat, scale, codec, n_rows, e_new):
    global ef_encode_log_launches, ef_encode_uniform_launches
    lib = build.library()
    n = flat.numel()
    c = -(-n // n_rows)
    row_bytes = B.payload_nbytes(c, codec.bits)
    scale = scale.reshape(1).contiguous()
    payload = torch.empty((n_rows, row_bytes), dtype=torch.uint8,
                          device=flat.device)
    clip = codec.clip_abs if codec.kind == "uniform" else None
    grid, table, half = _log_tables(codec, flat.device)
    err = lib.rt_ef_encode_rows(
        build.ptr(flat), build.ptr(scale), build.ptr(payload),
        build.ptr(e_new), n, n_rows, c, row_bytes, _KINDS[codec.kind],
        codec.bits, codec.k, clip or 0, grid, table, half,
        build.stream_ptr(flat.device))
    build.check(err, "ef_encode_rows")
    if codec.kind == "log":
        ef_encode_log_launches += 1
    else:
        ef_encode_uniform_launches += 1
    _count("ef_encode", codec.spec)
    return payload


def ef_encode_rows(x: torch.Tensor, scale: torch.Tensor, codec,
                   n_rows: int, backend: Optional[str] = None, out=None):
    """K7: quantize x (float32, any shape, read flat) against one scale
    (a 1-element float32 tensor on x's device) with a log or uniform
    codec, pack the codes into ``n_rows`` worker-ownership rows of
    ``ceil(numel / n_rows)`` elements (zero codes past the end) and keep
    the residual. Returns ``(payload (n_rows, codec.payload_nbytes(c))
    uint8, e' = x - deq(codes))``, e' in x's shape, written into ``out``
    when given (it may be x itself)."""
    global plain_on_cuda
    _check_wire_codec(codec)
    if codec.kind == "ternary":
        raise ValueError("K7 keeps a residual for log and uniform codes; "
                         "the ternary wire has no error feedback")
    _check_flat_x(x, n_rows)
    if scale.numel() != 1 or scale.dtype != torch.float32:
        raise ValueError("scale must be one float32 value")
    if out is not None and (out.dtype != torch.float32 or
                            out.shape != x.shape or
                            not out.is_contiguous()):
        raise ValueError("out must be a contiguous float32 tensor of x's "
                         "shape")
    flat = x.reshape(-1)
    if resolve_backend(backend, x, scale) == "cuda":
        e_new = out if out is not None else torch.empty_like(x)
        payload = _ef_encode_rows_cuda(flat, scale, codec, n_rows,
                                       e_new.reshape(-1))
        return payload, e_new
    plain_on_cuda += x.is_cuda
    payload, e_new = _ef_encode_rows_torch(flat, scale, codec, n_rows)
    e_new = e_new.reshape(x.shape)
    return payload, (e_new if out is None else out.copy_(e_new))


def _encode_rows_torch(flat, codec, n_rows, u):
    if codec.static_scale is not None:
        scale = torch.full((), codec.static_scale, dtype=torch.float32,
                           device=flat.device)
    else:
        scale = grids.amax_scale(flat)
    codes = _wire_quantize(codec, flat, scale, u)
    return B.pack_rows(B.pad_rows(codes, n_rows), codec.bits), scale


def _encode_rows_cuda(flat, codec, n_rows, u):
    global encode_log_launches, encode_uniform_launches
    global encode_ternary_launches
    lib = build.library()
    n = flat.numel()
    c = -(-n // n_rows)
    row_bytes = B.payload_nbytes(c, codec.bits)
    payload = torch.empty((n_rows, row_bytes), dtype=torch.uint8,
                          device=flat.device)
    if codec.static_scale is not None:
        # _encode1_body: the known scale, launch 2 alone
        scale = torch.full((), codec.static_scale, dtype=torch.float32,
                           device=flat.device)
        scale_in, scale_out, guard = scale, None, 0
    else:
        # launch 1: K3 folds max|x| into a device word; launch 2 reads it
        # under the zero guard and writes the scale it used
        scale_in = _amax_rows_cuda(flat.reshape(1, -1))
        scale = torch.empty((), dtype=torch.float32, device=flat.device)
        scale_out, guard = build.ptr(scale), 1
    grid, table, half = _log_tables(codec, flat.device)
    err = lib.rt_encode_rows(
        build.ptr(flat), None if u is None else build.ptr(u),
        build.ptr(scale_in), guard, scale_out, build.ptr(payload), n, n_rows,
        c, row_bytes, _KINDS[codec.kind], codec.bits, codec.k,
        codec.clip_abs or 0, grid, table, half,
        build.stream_ptr(flat.device))
    build.check(err, "encode_rows")
    if codec.kind == "log":
        encode_log_launches += 1
    elif codec.kind == "uniform":
        encode_uniform_launches += 1
    else:
        encode_ternary_launches += 1
    _count("encode", codec.spec)
    return payload, scale


def encode_rows(x: torch.Tensor, codec, n_rows: int,
                u: Optional[torch.Tensor] = None,
                backend: Optional[str] = None):
    """#5: the fused amax + quantize + pack of x (float32, any shape,
    read flat) with a log, uniform or ternary codec into ``n_rows``
    worker-ownership rows of ``ceil(numel / n_rows)`` elements (zero
    codes past the end). The scale is the codec's static one (the
    absolute uniform grid: one launch) or ``where(amax > 0, amax, 1)``
    (K3's amax launch, then the encode launch, no host sync). ``u``:
    the ternary codec's uniforms in [0, 1), float32 of x's numel, read at
    x's flat index. Returns ``(payload (n_rows, codec.payload_nbytes(c))
    uint8, scale)``, the scale a 0-d float32 tensor on x's device."""
    global plain_on_cuda
    _check_wire_codec(codec)
    _check_flat_x(x, n_rows)
    flat = x.reshape(-1)
    if codec.kind == "ternary":
        if u is None or u.dtype != torch.float32 or \
                u.numel() != flat.numel() or not u.is_contiguous():
            raise ValueError("the ternary codec needs contiguous float32 "
                             "uniforms u of x's numel")
        u = u.reshape(-1)
    else:
        u = None
    if resolve_backend(backend, x) == "cuda":
        if u is not None and not u.is_cuda:
            raise ValueError("u must lie on x's device")
        return _encode_rows_cuda(flat, codec, n_rows, u)
    plain_on_cuda += x.is_cuda
    return _encode_rows_torch(flat, codec, n_rows, u)


def _decode_rows_cuda(payload_rows, scales, codec, c, out):
    global decode_log_launches, decode_uniform_launches
    global decode_ternary_launches
    lib = build.library()
    n_rows, row_bytes = payload_rows.shape
    if codec.kind == "log":
        table = grids.log_table_on(codec.k, payload_rows.device)
        half = table.shape[0] // 2
    else:
        table, half = scales, 0      # read by the log kind only
    err = lib.rt_decode_rows(
        build.ptr(payload_rows), build.ptr(scales), build.ptr(table), half,
        build.ptr(out), out.numel(), n_rows, c, row_bytes,
        _KINDS[codec.kind], codec.bits, codec.k,
        build.stream_ptr(payload_rows.device))
    build.check(err, "decode_rows")
    if codec.kind == "log":
        decode_log_launches += 1
    elif codec.kind == "uniform":
        decode_uniform_launches += 1
    else:
        decode_ternary_launches += 1
    _count("decode", codec.spec)
    return out


def decode_rows(payload_rows: torch.Tensor, scales: torch.Tensor, codec,
                c: int, backend: Optional[str] = None, out=None):
    """K6: unpack ``(n_rows, codec.payload_nbytes(c))`` uint8 payload
    rows and dequantize row r against ``scales[r]`` ((n_rows,) float32,
    each source worker's own). Returns ``(n_rows, c)`` float32, or
    fills ``out`` (contiguous float32 of at most n_rows * c elements) with
    the first ``out.numel()`` values in row-major order, dropping the
    rows' padding, and returns it."""
    global plain_on_cuda
    _check_wire_codec(codec)
    if payload_rows.dim() != 2 or payload_rows.dtype != torch.uint8:
        raise ValueError(f"need (n_rows, nbytes) uint8 payload rows, got "
                         f"{tuple(payload_rows.shape)} {payload_rows.dtype}")
    n_rows, row_bytes = payload_rows.shape
    if not 1 <= n_rows <= 65535 or c < 1 or \
            row_bytes != B.payload_nbytes(c, codec.bits):
        raise ValueError(f"payload rows {tuple(payload_rows.shape)} do not "
                         f"hold {c} codes of {codec.bits} bits each")
    if scales.shape != (n_rows,) or scales.dtype != torch.float32:
        raise ValueError(f"scales must be ({n_rows},) float32")
    if out is not None and (out.dtype != torch.float32 or
                            not out.is_contiguous() or
                            out.numel() > n_rows * c):
        raise ValueError(f"out must be contiguous float32 of at most "
                         f"{n_rows * c} elements")
    if resolve_backend(backend, payload_rows, scales) == "cuda":
        if out is None:
            out = torch.empty((n_rows, c), dtype=torch.float32,
                              device=payload_rows.device)
        return _decode_rows_cuda(payload_rows.contiguous(),
                                 scales.contiguous(), codec, c, out)
    plain_on_cuda += payload_rows.is_cuda
    codes = B.unpack_rows(payload_rows, codec.bits, c)
    vals = _wire_dequantize(codec, codes, scales[:, None])
    if out is None:
        return vals
    return out.copy_(vals.reshape(-1)[:out.numel()].reshape(out.shape))


# ---------------------------------------------------------------------------
# #14 blockwise quantize and #8 blockwise encode (csrc/blockwise.cu)
# ---------------------------------------------------------------------------

BLOCK = 256          # the default block
MAX_LOG_BLOCK = 30   # the kernels take blocks of 2^0 .. 2^30 elements


def _blocks(flat: torch.Tensor, block: int) -> torch.Tensor:
    """Flat x -> (nb, block), the tail zero-padded (the reference's)."""
    n = flat.numel()
    nb = -(-n // block)
    return torch.nn.functional.pad(flat, (0, nb * block - n)).reshape(
        nb, block)


def _blockwise_args(x: torch.Tensor, block: int, backend):
    if x.dtype != torch.float32 or x.numel() < 1:
        raise ValueError(f"need a nonempty float32 tensor, got {x.dtype}")
    flat = x.reshape(-1).contiguous()
    bk = resolve_backend(backend, x)
    if bk == "cuda" and (block < 1 or block & (block - 1)
                         or block > 2 ** MAX_LOG_BLOCK):
        raise ValueError(f"the blockwise kernels take power-of-two blocks "
                         f"of 1 .. 2^{MAX_LOG_BLOCK} elements, got {block}")
    return flat, -(-flat.numel() // block), bk


def blockwise_quantize(x: torch.Tensor, block: int = BLOCK,
                       backend: Optional[str] = None):
    """#14: sign codes and per-block mean |x| over flat blocks of
    ``block`` elements of float32 x (any shape, read flat; the tail block
    zero-padded). Returns ((nb, block) int8 codes, (nb,) float32
    scales)."""
    global plain_on_cuda, blockwise_quantize_launches
    flat, nb, bk = _blockwise_args(x, block, backend)
    if bk == "cuda":
        lib = build.library()
        codes = torch.empty((nb, block), dtype=torch.int8, device=x.device)
        scales = torch.empty(nb, dtype=torch.float32, device=x.device)
        err = lib.rt_blockwise_quantize(build.ptr(flat), build.ptr(codes),
                                        build.ptr(scales), flat.numel(), nb,
                                        block.bit_length() - 1,
                                        build.stream_ptr(x.device))
        build.check(err, "blockwise_quantize")
        blockwise_quantize_launches += 1
        return codes, scales
    plain_on_cuda += x.is_cuda
    return grids.blockwise_quantize(_blocks(flat, block))


def blockwise_encode(x: torch.Tensor, block: int = BLOCK,
                     backend: Optional[str] = None):
    """#8: #14's codes packed to 2-bit lanes in one pass: float32 x (any
    shape, read flat) -> (flat payload of ``payload_nbytes(numel, 2)``
    uint8, (nb,) float32 scales), the payload that of ``pack_flat`` of
    the padded codes, cut to the numel's bytes."""
    global plain_on_cuda, blockwise_encode_launches
    flat, nb, bk = _blockwise_args(x, block, backend)
    nbytes = B.payload_nbytes(flat.numel(), 2)
    if bk == "cuda":
        lib = build.library()
        payload = torch.empty(nbytes, dtype=torch.uint8, device=x.device)
        scales = torch.empty(nb, dtype=torch.float32, device=x.device)
        err = lib.rt_blockwise_encode(build.ptr(flat), build.ptr(payload),
                                      build.ptr(scales), flat.numel(), nb,
                                      nbytes, block.bit_length() - 1,
                                      build.stream_ptr(x.device))
        build.check(err, "blockwise_encode")
        blockwise_encode_launches += 1
        return payload, scales
    plain_on_cuda += x.is_cuda
    codes, scales = grids.blockwise_quantize(_blocks(flat, block))
    return B.pack_flat(codes, 2)[:nbytes], scales
