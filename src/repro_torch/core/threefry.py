"""The reference's counter-based generator, threefry2x32 (``jax.random``
with ``jax_threefry_partitionable``, the default since jax 0.5), in plain
PyTorch: the key algebra (``prng_key``, ``fold_in``, ``split``) and the
draws (``random_bits``, ``uniform``), bitwise ``jax.random``'s.

A key is a (2,) ``torch.int32`` tensor on the caller's device holding the
bit patterns of the reference's two uint32 words (``uint32_key`` /
``key_from_uint32`` convert; a checkpoint stores its ``torch.uint32``
view), so a kernel reads it as two ``unsigned int``. The arithmetic runs
on int64 tensors holding uint32 values, masked after every add; no
shift ever sees a negative value.

A draw is a pure function of (key, element index): element i of
``uniform(key, shape)`` is ``threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))``
folded to 32 bits (``y0 ^ y1``), its 23 high bits the mantissa of a float
in [1, 2), minus 1. ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``
and ``split(key, n)[i]`` is ``threefry2x32(key, (0, i))``.

These are the plain versions of the kernels in ``csrc/threefry.cu``
(wrappers in ``repro_torch.kernels.prng``), which the wrappers run for
CPU tensors and the tests hold the kernels against.
"""
from __future__ import annotations

from typing import Sequence, Union

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
    import numpy as np
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
    ``threefry2x32(key, (0, i))``."""
    k0, k1 = _words(key)
    i = torch.arange(n, dtype=torch.int64, device=key.device)
    return _key(*threefry2x32(k0, k1, i >> 32, i & MASK))


def random_bits(key: torch.Tensor, n: int, start: int = 0) -> torch.Tensor:
    """Elements start .. start + n - 1 of the reference's 32-bit draw
    under ``key`` (``_threefry_random_bits_partitionable``): 64-bit
    element counters, so ``start`` reaches the high word. int64 tensor of
    uint32 values."""
    k0, k1 = _words(key)
    i = torch.arange(start, start + n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(k0, k1, i >> 32, i & MASK)
    return y0 ^ y1


def uniform(key: torch.Tensor, shape: Union[int, Sequence[int]],
            start: int = 0) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32 in [0, 1)): the bits'
    23 high bits as the mantissa of a float in [1, 2), minus 1, then
    ``max(0, .)`` as ``_uniform`` does. ``start`` offsets the flat
    element index."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    n = 1
    for s in shape:
        n *= s
    bits = (random_bits(key, n, start) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f, 0.0).reshape(shape)
