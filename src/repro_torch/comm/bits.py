"""Bit-lane packing (port of ``repro/comm/bits.py``, all of it).

Supported lane widths are ``SUPPORTED_BITS`` = (2, 3, 4, 6, 8, 16). The
odd widths pack across byte boundaries in groups: ``lcm(bits, 8)`` bits
of codes become whole bytes (3-bit: 8 codes -> 3 bytes; 6-bit: 4 codes
-> 3 bytes). Lanes below 8 bits store signed codes biased by
``2^(bits-1)``, little-endian within the group; 8-bit lanes are the
two's-complement int8 view, 16-bit lanes the little-endian int16 view.

Integer-only arithmetic on int32 tensors, so payloads are byte for byte
the reference's.
"""
from __future__ import annotations

import math

import torch

SUPPORTED_BITS = (2, 3, 4, 6, 8, 16)


def group_codes(bits: int) -> int:
    """Codes per whole-byte packing group: lcm(bits, 8) / bits."""
    return math.lcm(bits, 8) // bits


def group_nbytes(bits: int) -> int:
    """Bytes per packing group: lcm(bits, 8) / 8."""
    return math.lcm(bits, 8) // 8


def payload_nbytes(numel: int, bits: int) -> int:
    """Exact payload bytes for ``numel`` codes at a lane width: whole
    groups only (the tail group is padded with zero codes). Any positive
    width is accepted for accounting."""
    if bits <= 0:
        raise ValueError(f"bits={bits} must be positive")
    g, b = group_codes(bits), group_nbytes(bits)
    return -(-int(numel) // g) * b


def lane_bits_for(max_abs_code: int) -> int:
    """Smallest supported lane whose signed range [-(2^(b-1)),
    2^(b-1)-1] holds codes with |c| <= max_abs_code."""
    for b in SUPPORTED_BITS:
        if max_abs_code <= 2 ** (b - 1) - 1:
            return b
    raise ValueError(f"codes of magnitude {max_abs_code} exceed 16 bits")


def _bias(bits: int) -> int:
    return (1 << (bits - 1)) if bits < 8 else 0


def pack_lanes(codes2d: torch.Tensor, bits: int) -> torch.Tensor:
    """(R, L) signed int codes -> (R, L*bits/8) uint8, each row packed
    independently. L must be a multiple of group_codes(bits)."""
    if bits not in SUPPORTED_BITS:
        raise ValueError(f"bits={bits} not in {SUPPORTED_BITS}")
    rows, L = codes2d.shape
    g, nb = group_codes(bits), group_nbytes(bits)
    if L % g:
        raise ValueError(f"row length {L} is not a multiple of {g}")
    u = codes2d.to(torch.int32) + _bias(bits)
    if bits == 16:
        u = u & 0xFFFF
        out = torch.stack([u & 0xFF, (u >> 8) & 0xFF], dim=-1)
        return out.reshape(rows, 2 * L).to(torch.uint8)
    if bits == 8:
        return (u & 0xFF).to(torch.uint8)
    grp = u.reshape(rows, L // g, g)
    val = torch.zeros((rows, L // g), dtype=torch.int32, device=u.device)
    for j in range(g):  # <= 24 bits per group, fits int32
        val = val | (grp[:, :, j] << (j * bits))
    out = torch.stack([(val >> (8 * b)) & 0xFF for b in range(nb)], dim=-1)
    return out.reshape(rows, (L // g) * nb).to(torch.uint8)


def unpack_lanes(payload2d: torch.Tensor, bits: int, L: int) -> torch.Tensor:
    """Inverse of pack_lanes -> (R, L) codes (int8, or int16 for 16-bit
    lanes)."""
    if bits not in SUPPORTED_BITS:
        raise ValueError(f"bits={bits} not in {SUPPORTED_BITS}")
    rows = payload2d.shape[0]
    g, nb = group_codes(bits), group_nbytes(bits)
    u = payload2d.to(torch.int32)
    if bits == 16:
        pair = u.reshape(rows, L, 2)
        val = pair[:, :, 0] | (pair[:, :, 1] << 8)
        return (((val + 0x8000) & 0xFFFF) - 0x8000).to(torch.int16)
    if bits == 8:
        return (((u + 0x80) & 0xFF) - 0x80).to(torch.int8)
    grp = u.reshape(rows, L // g, nb)
    val = torch.zeros((rows, L // g), dtype=torch.int32, device=u.device)
    for b in range(nb):
        val = val | (grp[:, :, b] << (8 * b))
    mask = (1 << bits) - 1
    cols = [((val >> (j * bits)) & mask) - _bias(bits) for j in range(g)]
    return torch.stack(cols, dim=-1).reshape(rows, L).to(torch.int8)


# ---------------------------------------------------------------------------
# flat / row-chunked views
# ---------------------------------------------------------------------------

def _pad_last(x: torch.Tensor, pad: int) -> torch.Tensor:
    if not pad:
        return x
    return torch.nn.functional.pad(x, (0, pad))


def pack_flat(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Any-shape codes -> flat uint8 payload of payload_nbytes(numel)."""
    flat = codes.reshape(-1)
    flat = _pad_last(flat, (-flat.shape[0]) % group_codes(bits))
    return pack_lanes(flat.reshape(1, -1), bits).reshape(-1)


def unpack_flat(payload: torch.Tensor, bits: int, numel: int) -> torch.Tensor:
    """Inverse of pack_flat -> (numel,) codes."""
    g = group_codes(bits)
    padded = -(-numel // g) * g
    return unpack_lanes(payload.reshape(1, -1), bits, padded)[0, :numel]


def pack_rows(codes_rows: torch.Tensor, bits: int) -> torch.Tensor:
    """(n_rows, c) codes -> (n_rows, payload_nbytes(c)) uint8; each row
    packed independently so row boundaries stay byte-aligned."""
    c = codes_rows.shape[1]
    return pack_lanes(_pad_last(codes_rows, (-c) % group_codes(bits)), bits)


def unpack_rows(payload_rows: torch.Tensor, bits: int, c: int) -> torch.Tensor:
    """Inverse of pack_rows -> (n_rows, c) codes."""
    g = group_codes(bits)
    padded = -(-c // g) * g
    return unpack_lanes(payload_rows, bits, padded)[:, :c]


def pad_rows(x: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Flatten and zero-pad into (n_rows, ceil(numel/n_rows)) ownership
    rows (the worker-chunk layout of Algorithm 2)."""
    flat = x.reshape(-1)
    c = -(-flat.shape[0] // n_rows)
    return _pad_last(flat, n_rows * c - flat.shape[0]).reshape(n_rows, c)


def packed_nbytes(numel: int, bits: int) -> int:
    """Alias of :func:`payload_nbytes` (the reference's
    ``repro.core.packing`` name)."""
    return payload_nbytes(numel, bits)
