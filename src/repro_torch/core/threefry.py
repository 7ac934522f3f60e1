"""The reference's counter-based generator, threefry2x32 (``jax.random``
with ``jax_threefry_partitionable``, the default since jax 0.5), in plain
PyTorch: the key algebra (``prng_key``, ``fold_in``, ``split``) and the
draws (``random_bits``, ``uniform``), bitwise ``jax.random``'s.

A key is a (2,) ``torch.int32`` tensor on the caller's device holding the
bit patterns of the reference's two uint32 words (``uint32_key`` /
``key_from_uint32`` convert, ``key_data`` and ``as_key`` take either form; a
checkpoint stores its ``torch.uint32`` view), so a kernel reads it as
two ``unsigned int``. ``split``, ``fold_in`` and the draws also take a
stack of keys, (..., 2) or an (R, 2) table, each key drawn as if it were
alone (the reference's ``vmap`` over keys). The arithmetic runs on int64
tensors holding uint32 values, masked after every add; no shift ever
sees a negative value.

A draw is a pure function of (key, element index): element i of
``uniform(key, shape)`` is ``threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))``
folded to 32 bits (``y0 ^ y1``), its 23 high bits the mantissa of a float
in [1, 2), minus 1. ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``
and ``split(key, n)[i]`` is ``threefry2x32(key, (0, i))``.

On those uniforms, the reference's other draws, in jax 0.9.0's float32
formulas: ``truncated_normal`` (``Model.init``'s weights: the uniform
mapped onto [erf(-√2), erf(√2)], then √2 times XLA's float32
``erf_inv`` polynomial), ``gumbel`` (``mode="low"``) and ``categorical``
(the Gumbel-max draw of the serving session's sampled tokens). Every
float operation is a separate IEEE operation (no fused multiply-add),
so the card's kernels are bitwise these on the card; against XLA's CPU
build they agree to float32 rounding (its ``log1p`` and contractions
are its own).

These are the plain versions of the kernels in ``csrc/threefry.cu``
(wrappers in ``repro_torch.kernels.prng``), which the wrappers run for
CPU tensors and the tests hold the kernels against.
"""
from __future__ import annotations

import math
import struct
from typing import Sequence, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA      # the key schedule's constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds: the words (k0, k1) of a key and the
    counter words (x0, x1), int64 tensors (or ints) holding uint32 values
    that broadcast together -> (y0, y1), int64 tensors of uint32 values."""
    k0 = torch.as_tensor(k0, dtype=torch.int64) & MASK
    k1 = torch.as_tensor(k1, dtype=torch.int64, device=k0.device) & MASK
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (torch.as_tensor(x0, dtype=torch.int64, device=k0.device)
          + ks[0]) & MASK
    x1 = (torch.as_tensor(x1, dtype=torch.int64, device=k0.device)
          + ks[1]) & MASK
    for j in range(5):
        for r in _ROTATIONS[j % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(j + 1) % 3]) & MASK
        x1 = (x1 + ks[(j + 2) % 3] + j + 1) & MASK
    return x0, x1


def _words(key: torch.Tensor):
    """A (..., 2) int32 key -> its two words as int64 uint32 values."""
    k = key.to(torch.int64) & MASK
    return k[..., 0], k[..., 1]


def _key(y0: torch.Tensor, y1: torch.Tensor) -> torch.Tensor:
    """Two int64 uint32 words -> an int32 key (the bit patterns)."""
    w = torch.stack([y0, y1], dim=-1)
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def seed_words(seed: int):
    """The two words of ``jax.random.PRNGKey(seed)`` as ints: [seed >> 32,
    seed & 0xFFFFFFFF], as ``threefry_seed`` makes them; a seed that fits
    an int32 is one (the reference without x64: its high word 0)."""
    s = int(seed)
    return (0 if -2 ** 31 <= s < 2 ** 31 else (s >> 32) & MASK), s & MASK


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` (:func:`seed_words`)."""
    hi, lo = seed_words(seed)
    return _key(torch.tensor(hi), torch.tensor(lo)).to(device)


def uint32_key(key: torch.Tensor):
    """A key -> a numpy uint32 (2,) array, the reference's form."""
    return key.detach().cpu().numpy().view("uint32")


def key_from_uint32(words, device=None) -> torch.Tensor:
    """The reference's uint32 key (anything numpy reads) -> a key."""
    a = np.asarray(words, dtype=np.uint32).reshape(-1)
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def fold_in(key: torch.Tensor, data: Union[int, torch.Tensor]) \
        -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: data as a uint32 (an int, or an
    integer tensor of one element on the key's device: the step count
    the device holds)."""
    k0, k1 = _words(key)
    if isinstance(data, torch.Tensor):
        d = data.reshape(()).to(torch.int64) & MASK
    else:
        d = int(data) & MASK
    return _key(*threefry2x32(k0, k1, 0, d))


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)``: (n, 2) keys, row i
    ``threefry2x32(key, (0, i))``; a (..., 2) stack of keys gives
    (..., n, 2), each key split alone (``vmap(split)``)."""
    k0, k1 = _words(key)
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    return _key(*threefry2x32(k0[..., None], k1[..., None], i >> 32,
                              i & MASK))


def random_bits(key: torch.Tensor, n: int, start: int = 0) -> torch.Tensor:
    """Elements start .. start + n - 1 of the reference's 32-bit draw
    under ``key`` (``_threefry_random_bits_partitionable``): 64-bit
    element counters, so ``start`` reaches the high word. int64 tensor of
    uint32 values, (n,) for a (2,) key, (R, n) for an (R, 2) table."""
    k0, k1 = _words(key)
    i = torch.arange(start, start + n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(k0[..., None], k1[..., None], i >> 32, i & MASK)
    return y0 ^ y1


def _shape(shape) -> tuple:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _floats(bits: torch.Tensor) -> torch.Tensor:
    """The bits' 23 high bits as the mantissa of a float in [1, 2), minus
    1: float32 in [0, 1)."""
    bits = (bits >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def _rows_shape(key: torch.Tensor, shape) -> tuple:
    return tuple(key.shape[:-1]) + _shape(shape)


def uniform(key: torch.Tensor, shape: Union[int, Sequence[int]],
            start: int = 0) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32 in [0, 1)): the bits'
    23 high bits as the mantissa of a float in [1, 2), minus 1, then
    ``max(0, .)`` as ``_uniform`` does. ``start`` offsets the flat
    element index. An (R, 2) table gives (R, *shape), row r under key r."""
    n = math.prod(_shape(shape))
    f = _floats(random_bits(key, n, start))
    return torch.clamp_min(f, 0.0).reshape(_rows_shape(key, shape))


def _f32(bits: int) -> float:
    return struct.unpack("<f", struct.pack("<I", bits))[0]


# jax 0.9.0's float32 erf(lower / sqrt2), erf(upper / sqrt2) of
# truncated_normal's bounds (XLA's float32 erf), by their bit patterns;
# the reference draws with (-2, 2) alone
TRUNC_ERF_BITS = {(-2.0, 2.0): (0xBF745A18, 0x3F745A18)}
SQRT2 = float(np.float32(np.sqrt(2)))
# XLA's float32 ErfInv (chlo.erf_inv's lowering; Giles, "Approximating the
# erfinv function", 2010): p(w) of w = -log1p(-u^2) - 2.5 below 5, of
# sqrt(w) - 3 from 5 on, Horner from the first coefficient
ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682)
TINY = float(np.finfo(np.float32).tiny)
# elements of one piece of a plain draw: the int64 threefry's temporaries
# stay a few times 2^22 elements whatever the leaf's size
PIECE = 1 << 22


def erf_inv(u: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` on a float32 tensor with |u| < 1 (the
    edge case |u| = 1 does not arise in ``truncated_normal``), each
    multiply and add its own rounding."""
    f32 = dict(dtype=torch.float32, device=u.device)
    w = -torch.log1p(-(u * u))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, torch.tensor(ERFINV_LT5[i], **f32),
                           torch.tensor(ERFINV_GE5[i], **f32))
    p = coef(0)
    for i in range(1, len(ERFINV_LT5)):
        p = coef(i) + p * w
    return p * u


def _pieces(key: torch.Tensor, shape, start: int, draw) -> torch.Tensor:
    """``draw(bits)`` over the flat elements of ``shape`` under each key
    row, piece by piece: float32 (R, *shape), or shape for a (2,) key."""
    n = math.prod(_shape(shape))
    rows = key.reshape(-1, 2)
    out = torch.empty((rows.shape[0], n), dtype=torch.float32,
                      device=key.device)
    step = max(1, PIECE // rows.shape[0])
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        out[:, lo:hi] = draw(random_bits(rows, hi - lo, start + lo))
    return out.reshape(_rows_shape(key, shape))


def truncated_normal(key: torch.Tensor, lower: float, upper: float,
                     shape: Union[int, Sequence[int]],
                     start: int = 0) -> torch.Tensor:
    """``jax.random.truncated_normal(key, lower, upper, shape)`` in
    float32: ``u = max(a, f (b - a) + a)`` on the uniform f with ``a, b =
    erf(lower / sqrt2), erf(upper / sqrt2)`` (jax's float32 constants,
    ``TRUNC_ERF_BITS``), ``sqrt2 * erf_inv(u)``, clamped to
    ``nextafter(lower, +inf) .. nextafter(upper, -inf)``. ``start``
    offsets the flat element index; an (R, 2) table gives (R, *shape)."""
    bounds = (float(lower), float(upper))
    if bounds not in TRUNC_ERF_BITS:
        raise ValueError(f"truncated_normal's erf constants are held for "
                         f"{sorted(TRUNC_ERF_BITS)}, not {bounds}")
    a, b = (_f32(x) for x in TRUNC_ERF_BITS[bounds])
    lo = float(np.nextafter(np.float32(lower), np.float32(np.inf)))
    hi = float(np.nextafter(np.float32(upper), np.float32(-np.inf)))
    span = float(np.float32(b) - np.float32(a))

    def draw(bits):
        u = torch.clamp_min(_floats(bits) * span + a, a)
        return torch.clamp(SQRT2 * erf_inv(u), lo, hi)
    return _pieces(key, shape, start, draw)


def gumbel(key: torch.Tensor, shape: Union[int, Sequence[int]],
           start: int = 0) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` (``mode="low"``) in float32:
    ``-log(-log(u))`` on ``u = max(tiny, f (1 - tiny) + tiny)`` (1 - tiny
    is 1 in float32). An (R, 2) table gives (R, *shape)."""
    def draw(bits):
        u = torch.clamp_min(_floats(bits) * 1.0 + TINY, TINY)
        return -torch.log(-torch.log(u))
    return _pieces(key, shape, start, draw)


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis: the
    argmax of ``gumbel(key, V) + logits``, the first index on ties (as
    ``jnp.argmax``). A (2,) key with (V,) logits gives a 0-d int64, an
    (R, 2) table with (R, V) logits one index a row (``vmap``)."""
    if tuple(key.shape[:-1]) != tuple(logits.shape[:-1]):
        raise ValueError(f"keys {tuple(key.shape)} do not match logits "
                         f"{tuple(logits.shape)}")
    g = gumbel(key, logits.shape[-1])
    return torch.argmax(g + logits.to(torch.float32), dim=-1)


def key_data(key) -> torch.Tensor:
    """A key or a stack of keys, as the port's int32 tensor or as the
    reference's uint32 words (anything numpy reads as uint32 or int32, a
    jax key's data among them) -> a CPU int32 tensor of the words' bit
    patterns, its shape kept."""
    if isinstance(key, torch.Tensor):
        if key.dtype != torch.int32:
            raise ValueError(f"a threefry key tensor is int32, not "
                             f"{key.dtype}")
        return key.detach().cpu().clone()
    a = np.asarray(key)
    if a.dtype not in (np.uint32, np.int32):
        raise ValueError(f"a threefry key holds uint32 words, not "
                         f"{a.dtype}")
    return torch.from_numpy(a.view(np.int32).copy())


def as_key(key, who: str) -> torch.Tensor:
    """``key_data`` of one (2,) key; any other shape raises the
    reference's ``ValueError``, naming ``who`` needs the key."""
    key = key_data(key)
    if tuple(key.shape) != (2,):
        raise ValueError(f"{who} needs a threefry PRNG key (2 uint32 "
                         f"words); got key data {tuple(key.shape)}")
    return key
