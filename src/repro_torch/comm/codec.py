"""Backend policy, the codecs and the wire's row entry points (port of
``repro/comm/codec.py``): the log Q_g and uniform Q_x grids, the
baselines' TernGrad ternary and blockwise sign codecs and the f32
identity codec, each with its code-level primitives (``compute_scale``,
``quantize``, ``dequantize``) and lane width, exact byte accounting
(``payload_nbytes``, ``wire_nbytes``), the spec registry
(``get_codec``), the single-tensor ``WireBuffer`` of ``Codec.encode``
(#5, or #8 for the blockwise codec) and ``Codec.decode`` (K6), and the
worker-ownership rows of Algorithm 2 (``encode_rows``, #5;
``encode_rows_ef``, K7; ``decode_rows``, K6), whose payloads are byte
for byte the reference's.

Backends: ``"torch"`` is the plain PyTorch version of a kernel (what the
CPU tests run, and the yardstick a kernel is held against on the card);
``"cuda"`` is the hand-written Hopper kernel. ``backend=None`` picks the
kernel for CUDA tensors and the plain version for CPU tensors. An
explicit backend always wins; ``"cuda"`` on a CPU tensor raises.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.comm import bits as B
from repro_torch.opt import grids

BACKENDS = ("torch", "cuda")


def resolve_backend(backend: Optional[str], *tensors: torch.Tensor) -> str:
    """Pick the implementation for ``tensors`` (all on one device)."""
    on_cuda = all(t.is_cuda for t in tensors)
    if backend is None:
        return "cuda" if on_cuda else "torch"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; "
                         f"expected one of {BACKENDS}")
    if backend == "cuda" and not on_cuda:
        raise ValueError("backend='cuda' needs CUDA tensors")
    return backend


def _amax_scale(x: torch.Tensor, backend: Optional[str]) -> torch.Tensor:
    """The reference's per-tensor amax scale, ``where(amax > 0, amax, 1)``
    (``grids.amax_scale``), its amax from K3; a 0-d float32 tensor. (The
    kernel modules import this one for ``resolve_backend``, hence the
    imports inside the functions.)"""
    from repro_torch.comm import kernels as K
    from repro_torch.opt import engine
    amax = K.amax_rows(x.to(torch.float32).reshape(1, -1), backend=backend)
    return engine.amax_scale(amax[0])


def _scale_tensor(scale, like: torch.Tensor) -> torch.Tensor:
    """A scale given as a number or a tensor -> float32 on like's device."""
    return torch.as_tensor(scale, dtype=torch.float32, device=like.device)


class Codec:
    """Base of the codecs. The code-level primitives: ``compute_scale``
    (the codec's static scale, else the amax scale), ``quantize`` (codes
    of the unpacked tensor against a scale) and ``dequantize``, each
    codec's own kernel on CUDA tensors. Byte accounting:
    ``payload_nbytes`` counts the packed codes (what the collectives
    move), ``wire_nbytes`` adds the float32 scale side-channel.
    ``encode``/``decode`` of the one-scale codecs (log, uniform, ternary)
    run #5 and K6 over one payload row."""

    stochastic = False
    static_scale = None   # a data-independent scale, else an amax pass

    def scale_numel(self, numel: int) -> int:
        return 1

    def payload_nbytes(self, numel: int) -> int:
        return B.payload_nbytes(numel, self.bits)

    def wire_nbytes(self, numel: int) -> int:
        return self.payload_nbytes(numel) + 4 * self.scale_numel(numel)

    def dequant_lut(self):
        """Scale-1 dequant table by lane code, or None where dequant is a
        single multiply."""
        return None

    def compute_scale(self, x: torch.Tensor, *,
                      backend: Optional[str] = None) -> torch.Tensor:
        """The scale ``quantize`` takes, a 0-d float32 tensor on x's
        device: the static one, else ``where(amax > 0, amax, 1)`` with
        the amax from K3."""
        if self.static_scale is not None:
            return torch.full((), self.static_scale, dtype=torch.float32,
                              device=x.device)
        return _amax_scale(x, backend)

    def quantize(self, x: torch.Tensor, scale, *,
                 u: Optional[torch.Tensor] = None,
                 backend: Optional[str] = None) -> torch.Tensor:
        raise NotImplementedError

    def dequantize(self, codes: torch.Tensor, scale, *,
                   backend: Optional[str] = None) -> torch.Tensor:
        raise NotImplementedError

    def encode(self, x: torch.Tensor, *, u: Optional[torch.Tensor] = None,
               backend: Optional[str] = None) -> "WireBuffer":
        """Fused amax + quantize + pack (#5) of x, read flat ->
        :class:`WireBuffer`. A stochastic codec takes its uniforms ``u``
        (float32, x's numel)."""
        if self.stochastic and u is None:
            raise ValueError(f"{self.name} codec is stochastic; pass u=")
        flat = x.reshape(-1).to(torch.float32).contiguous()
        payload, scale = encode_rows(flat, self, 1, u=u, backend=backend)
        return WireBuffer(payload=payload.reshape(-1), scale=scale,
                          spec=self.spec, shape=tuple(x.shape))

    def decode(self, wb: "WireBuffer", *, backend: Optional[str] = None,
               out_dtype=torch.float32) -> torch.Tensor:
        """Fused unpack + dequantize (K6) of a :class:`WireBuffer`."""
        n = wb.numel
        vals = decode_rows(wb.payload.reshape(1, -1),
                           wb.scale.reshape(1).to(torch.float32), self, n,
                           backend=backend)
        return vals.reshape(wb.shape).to(out_dtype)


@dataclasses.dataclass(frozen=True)
class LogCodec(Codec):
    """The paper's Q_g: log grid, per-tensor amax scale. Codes live in
    [-(k_g+1), k_g+1] and pack to the smallest lane holding them."""

    k_g: int = 6
    name = "log"
    kind = "log"
    clip_abs = None

    @property
    def spec(self) -> str:
        return f"log:{self.k_g}"

    @property
    def bits(self) -> int:
        return B.lane_bits_for(self.k_g + 1)

    @property
    def k(self) -> int:
        return self.k_g

    def dequant_lut(self):
        return grids.log_dequant_table(self.k_g, self.bits)

    def quantize(self, x: torch.Tensor, scale, *,
                 u: Optional[torch.Tensor] = None,
                 backend: Optional[str] = None) -> torch.Tensor:
        """Log-grid int8 codes of x against a scale (#10)."""
        from repro_torch.comm import kernels as K
        x = x.to(torch.float32)
        return K.log_quantize(x, _scale_tensor(scale, x), self.k_g,
                              backend=backend)

    def dequantize(self, codes: torch.Tensor, scale, *,
                   backend: Optional[str] = None) -> torch.Tensor:
        """``sign(c) * 2^(|c|-k_g-1) * scale`` in float32 (K11)."""
        from repro_torch.opt import engine
        return engine.dequantize_log(codes, _scale_tensor(scale, codes),
                                     self.k_g, backend=backend)


@dataclasses.dataclass(frozen=True)
class UniformCodec(Codec):
    """The paper's Q_x: uniform grid over [-scale, scale] (``absolute``:
    scale = 0.5, else a per-tensor amax scale). Codes reach +/- 2^k_x and
    by default pack exactly into the next lane up, the residency lane.
    ``wire_bits`` pins a narrower lane and clips the extreme codes into
    it (see :func:`uniform_wire_codec`)."""

    k_x: int = 7
    absolute: bool = True
    wire_bits: Optional[int] = None
    name = "uniform"
    kind = "uniform"

    def __post_init__(self):
        if self.wire_bits is not None and \
                self.wire_bits not in B.SUPPORTED_BITS:
            raise ValueError(f"wire_bits={self.wire_bits} not in "
                             f"{B.SUPPORTED_BITS}")

    @property
    def spec(self) -> str:
        base = "uniform" if self.absolute else "uniform_amax"
        suffix = f":w{self.wire_bits}" if self.wire_bits else ""
        return f"{base}:{self.k_x}{suffix}"

    @property
    def bits(self) -> int:
        if self.wire_bits is not None:
            return self.wire_bits
        return B.lane_bits_for(2 ** self.k_x)

    @property
    def k(self) -> int:
        return self.k_x

    @property
    def clip_abs(self) -> Optional[int]:
        top = 2 ** (self.bits - 1) - 1
        return top if 2 ** self.k_x > top else None

    @property
    def static_scale(self) -> Optional[float]:
        return 0.5 if self.absolute else None

    def quantize(self, x: torch.Tensor, scale, *,
                 u: Optional[torch.Tensor] = None,
                 backend: Optional[str] = None) -> torch.Tensor:
        """Codes of the whole tensor against one scale (K4), clipped to
        the lane where it clips. (The scale from ``compute_scale`` has the
        zero guard 1, not the 1e-30 floor of ``engine.quantize_uniform``.)"""
        from repro_torch.comm import kernels as K
        x = x.to(torch.float32)
        codes = K.uniform_quantize_rows(
            x.reshape(1, -1), _scale_tensor(scale, x).reshape(1), self.k_x,
            backend=backend)
        if self.clip_abs is not None:
            codes = torch.clamp(codes, -self.clip_abs, self.clip_abs)
        return codes.reshape(x.shape)

    def dequantize(self, codes: torch.Tensor, scale, *,
                   backend: Optional[str] = None) -> torch.Tensor:
        """``codes / 2^k_x * scale`` in float32 (K12)."""
        from repro_torch.opt import engine
        return engine.dequantize_uniform(codes, _scale_tensor(scale, codes),
                                         self.k_x, backend=backend)


def uniform_wire_codec(k_x: int, absolute: bool = True) -> UniformCodec:
    """The weight-broadcast wire's Q_x lanes: the smallest lane whose
    clipped range loses only the two extreme codes (+/- 2^k_x -> the lane
    edge): k_x = 7 rides 8-bit lanes at +/-127, k_x = 3 4-bit lanes."""
    return UniformCodec(k_x=k_x, absolute=absolute,
                        wire_bits=B.lane_bits_for(2 ** k_x - 1))


@dataclasses.dataclass(frozen=True)
class TernaryCodec(Codec):
    """TernGrad: unbiased stochastic ternary {-1, 0, +1} against the
    per-tensor amax scale, 2-bit lanes."""

    name = "terngrad"
    kind = "ternary"
    stochastic = True
    spec = "terngrad"
    bits = 2
    k = 0
    clip_abs = None

    def quantize(self, x: torch.Tensor, scale, *,
                 u: Optional[torch.Tensor] = None,
                 backend: Optional[str] = None) -> torch.Tensor:
        """Codes ``sign(x) * [u < |x| / max(scale, 1e-30)]`` (#13) from
        the uniforms ``u`` (float32, x's numel; the reference draws them
        from its key)."""
        from repro_torch.comm import kernels as K
        if u is None:
            raise ValueError("terngrad codec is stochastic; pass u=")
        x = x.to(torch.float32)
        return K.ternary_quantize(x, u, _scale_tensor(scale, x),
                                  backend=backend)

    def dequantize(self, codes: torch.Tensor, scale, *,
                   backend: Optional[str] = None) -> torch.Tensor:
        """``codes * scale`` in float32 (one multiply, as the reference's;
        no kernel of its own)."""
        return grids.ternary_dequantize(codes, _scale_tensor(scale, codes))


@dataclasses.dataclass(frozen=True)
class BlockwiseCodec(Codec):
    """Zheng et al. '19: sign codes + per-block mean |x| scales, 2-bit
    lanes. Outside the ``encode_rows``/``decode_rows`` contract (one
    scale per source row): the ``ef_sgd`` mode packs its rows itself and
    slices the scale columns of its chunk
    (``dist.modes.base.blockwise_exchange``)."""

    block: int = 256
    name = "blockwise"
    kind = "blockwise"
    bits = 2
    k = 0
    clip_abs = None

    @property
    def spec(self) -> str:
        return f"blockwise:{self.block}"

    def scale_numel(self, numel: int) -> int:
        return -(-int(numel) // self.block)

    def compute_scale(self, x: torch.Tensor, *,
                      backend: Optional[str] = None) -> torch.Tensor:
        raise NotImplementedError("blockwise scales ride encode()")

    def quantize(self, x: torch.Tensor, scale=None, *,
                 u: Optional[torch.Tensor] = None,
                 backend: Optional[str] = None) -> torch.Tensor:
        """Sign codes, int8 (plain, as the reference's; #14 computes them
        with their block scales in ``engine.quantize_blockwise``)."""
        return torch.sign(x.to(torch.float32)).to(torch.int8)

    def dequantize(self, codes: torch.Tensor, scale, *,
                   backend: Optional[str] = None) -> torch.Tensor:
        """``codes * scale`` in float32, the per-block scale broadcast
        over the block dim by the caller."""
        return codes.to(torch.float32) * _scale_tensor(scale, codes)

    def encode(self, x: torch.Tensor, *, u=None,
               backend: Optional[str] = None) -> "WireBuffer":
        """Sign + block scale + 2-bit pack in one launch (#8)."""
        from repro_torch.comm import kernels as K
        payload, scales = K.blockwise_encode(
            x.reshape(-1).to(torch.float32), self.block, backend=backend)
        return WireBuffer(payload=payload, scale=scales, spec=self.spec,
                          shape=tuple(x.shape))

    def decode(self, wb: "WireBuffer", *, backend: Optional[str] = None,
               out_dtype=torch.float32) -> torch.Tensor:
        """Unpack and dequantize in plain tensor code, as the reference
        (no kernel of its own)."""
        n = wb.numel
        nb = self.scale_numel(n)
        codes = B.unpack_flat(wb.payload, self.bits, n)
        codes2d = torch.nn.functional.pad(
            codes, (0, nb * self.block - n)).reshape(nb, self.block)
        vals = grids.blockwise_dequantize(codes2d, wb.scale)
        return vals.reshape(-1)[:n].to(out_dtype).reshape(wb.shape)


@dataclasses.dataclass(frozen=True)
class IdentityCodec(Codec):
    """No compression: the payload is the float32 bytes (4 per element),
    no scale."""

    name = "identity"
    kind = "identity"
    clip_abs = None
    spec = "identity"
    bits = 32

    def scale_numel(self, numel: int) -> int:
        return 0

    def payload_nbytes(self, numel: int) -> int:
        return 4 * int(numel)

    def compute_scale(self, x: torch.Tensor, *,
                      backend: Optional[str] = None) -> torch.Tensor:
        return torch.ones((), dtype=torch.float32, device=x.device)

    def quantize(self, x: torch.Tensor, scale=None, *,
                 u: Optional[torch.Tensor] = None,
                 backend: Optional[str] = None) -> torch.Tensor:
        """The float32 values themselves (a copy)."""
        return x.to(torch.float32, copy=True)

    def dequantize(self, codes: torch.Tensor, scale=None, *,
                   backend: Optional[str] = None) -> torch.Tensor:
        return codes.to(torch.float32)

    def encode(self, x: torch.Tensor, *, u=None,
               backend: Optional[str] = None) -> "WireBuffer":
        flat = x.reshape(-1).to(torch.float32).contiguous()
        return WireBuffer(payload=flat.view(torch.uint8),
                          scale=torch.zeros(0, dtype=torch.float32,
                                            device=x.device),
                          spec=self.spec, shape=tuple(x.shape))

    def decode(self, wb: "WireBuffer", *, backend: Optional[str] = None,
               out_dtype=torch.float32) -> torch.Tensor:
        return wb.payload.view(torch.float32).to(out_dtype).reshape(wb.shape)


@dataclasses.dataclass
class WireBuffer:
    """One tensor in wire form: the packed uint8 payload
    (``codec.payload_nbytes(numel)`` bytes, flat) and its float32
    scale(s): () per tensor, (nb,) per block (blockwise), (0,) for the
    identity codec. ``spec`` and ``shape`` name the codec and the
    logical shape, enough to decode."""

    payload: torch.Tensor
    scale: torch.Tensor
    spec: str
    shape: Tuple[int, ...]

    @property
    def numel(self) -> int:
        return math.prod(self.shape)

    @property
    def bits(self) -> int:
        return get_codec(self.spec).bits

    @property
    def nbytes(self) -> int:
        """The buffer's bytes, payload and scales."""
        return self.payload.nbytes + self.scale.nbytes

    def decode(self, *, backend: Optional[str] = None,
               out_dtype=torch.float32) -> torch.Tensor:
        return get_codec(self.spec).decode(self, backend=backend,
                                           out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def get_codec(spec: Optional[str]):
    """Parse a codec spec string (the reference's grammar): 'none',
    'log:k', 'uniform:k', 'uniform_amax:k', 'terngrad' (or 'ternary'),
    'blockwise:b'; a trailing ':wire' or ':wN' on the uniform specs
    selects the clipped wire lanes."""
    if spec is None or spec in ("none", "identity", "fp32"):
        return IdentityCodec()
    parts = spec.split(":")
    head, args = parts[0], parts[1:]
    wire_bits = None
    if "wire" in args:
        args.remove("wire")
        wire_bits = "wire"
    for a in list(args):
        if a.startswith("w") and a[1:].isdigit():
            wire_bits = int(a[1:])
            args.remove(a)
    arg = args[0] if args else ""
    if head == "log":
        return LogCodec(k_g=int(arg or 6))
    if head in ("uniform", "uniform_amax"):
        k_x = int(arg or 7)
        absolute = head == "uniform"
        if wire_bits == "wire":
            return uniform_wire_codec(k_x, absolute)
        return UniformCodec(k_x=k_x, absolute=absolute, wire_bits=wire_bits)
    if head in ("terngrad", "ternary"):
        return TernaryCodec()
    if head == "blockwise":
        return BlockwiseCodec(block=int(arg or 256))
    raise ValueError(f"unknown codec spec: {spec}")


CODEC_NAMES = ("identity", "log", "uniform", "uniform_amax", "terngrad",
               "blockwise")


# ---------------------------------------------------------------------------
# row-chunked wire entry points (the layout the collectives move)
# ---------------------------------------------------------------------------

def _check_row_codec(codec) -> None:
    if codec.kind == "blockwise":
        raise NotImplementedError(
            "the blockwise codec's per-block scales are outside the "
            "one-scale-per-row contract of encode_rows/decode_rows (as in "
            "the reference): ef_sgd runs dist.modes.base.blockwise_exchange")


def encode_rows(x: torch.Tensor, codec, n_rows: int, *,
                u: Optional[torch.Tensor] = None,
                backend: Optional[str] = None):
    """Fused encode (#5) into worker-ownership rows: flat x ->
    ``(n_rows, payload_nbytes(c))`` uint8 payload (byte-aligned per row,
    the array the all-to-all moves) and the per-tensor scale (0-d). A
    stochastic codec (TernGrad) takes its uniforms ``u`` over the flat
    x (the reference draws them from its key)."""
    from repro_torch.comm import kernels as K
    _check_row_codec(codec)
    if codec.stochastic and u is None:
        raise ValueError(f"{codec.name} codec is stochastic; pass u=")
    flat = x.reshape(-1).to(torch.float32).contiguous()
    return K.encode_rows(flat, codec, n_rows, u=u, backend=backend)


def encode_rows_ef(x: torch.Tensor, scale: torch.Tensor, codec,
                   n_rows: int, *, backend: Optional[str] = None, out=None):
    """Fused encode + error feedback (K7): flat x -> (payload rows
    ``(n_rows, codec.payload_nbytes(c))`` uint8, residual
    ``e' = x - deq(codes)`` in x's shape, into ``out`` when given). The
    scale arrives from the caller (the Adam moment pass, or the weight
    codec's); the codes are never written unpacked."""
    from repro_torch.comm import kernels as K
    return K.ef_encode_rows(x, scale, codec, n_rows, backend=backend,
                            out=out)


def decode_rows(payload_rows: torch.Tensor, scales: torch.Tensor, codec,
                c: int, *, backend: Optional[str] = None,
                out=None) -> torch.Tensor:
    """Fused decode of received payload rows (K6): ``(n_rows, nbytes)``
    uint8 + per-source-row scales -> ``(n_rows, c)`` float32 values, or
    the first ``out.numel()`` of them written into ``out``."""
    from repro_torch.comm import kernels as K
    _check_row_codec(codec)
    return K.decode_rows(payload_rows, scales, codec, c, backend=backend,
                         out=out)
