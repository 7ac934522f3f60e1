"""The reference's threefry draws on the card (``csrc/threefry.cu``):

  * ``step_keys(seed, t, n_leaves, worker)``: the distributed chain's
    (L, 2) key table of a step, row l
    ``fold_in(fold_in(fold_in(PRNGKey(seed), t), l), worker)``, with
    ``t`` read from device memory (``repro/dist/step.py``);
  * ``advance_keys(key, n_leaves)``: Algorithm 1's chain, ``key, sub =
    split(key)`` with the state key written over in place, and the (L, 2)
    table ``split(sub, L)`` (``repro/core/qadam.py``);
  * ``uniform(keys, leaf, n)``: ``jax.random.uniform(keys[leaf], (n,))``;
  * ``trunc_normal(keys, shape, std)``: ``Model.init``'s draw of a stacked
    leaf, ``vmap(lambda k: truncated_normal(k, -2, 2, shape) * std)`` over
    an (L, 2) key table, in one launch (``repro/models/model.py``
    ``_dense``);
  * ``categorical_step(logits, temp, rng)``: the serving session's
    sampling step, the greedy and the sampled token of each slot and its
    key advanced where it samples (``repro/serve/session.py``), graph-safe.

Replace no Pallas kernel: the reference draws with XLA's threefry behind
``jax.random``. Beside each kernel its plain version
(``repro_torch.core.threefry``), which a wrapper runs only for CPU (or
meta) tensors or when asked with ``backend="torch"``, and plain-int
launch counters. A key is a (2,) int32 tensor of the two words' bit
patterns, a key table (L, 2) int32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch import build
from repro_torch.comm.codec import resolve_backend
from repro_torch.core import threefry as TF
from repro_torch.kernels.meta import charged

keys_launches = 0       # rt_threefry_keys launches (both chains)
uniform_launches = 0    # rt_threefry_uniform launches
trunc_normal_launches = 0   # rt_threefry_trunc_normal launches
categorical_launches = 0    # rt_threefry_categorical launches (and its fold)
plain_on_cuda = 0       # plain versions run on CUDA tensors
# elements of V one block of rt_threefry_categorical scores (kCatChunk)
CAT_CHUNK = 4096


def _launch_keys(out, key, seed, t, n_leaves, worker, mode, dev):
    global keys_launches
    hi, lo = TF.seed_words(seed) if mode == 0 else (0, 0)
    err = build.library().rt_threefry_keys(
        build.ptr(out) if n_leaves else None,
        build.ptr(key) if key is not None else None, hi, lo,
        build.ptr(t) if t is not None else None, n_leaves,
        int(worker) & TF.MASK, mode, build.stream_ptr(dev))
    build.check(err, "threefry_keys")
    keys_launches += 1


def _step_keys_torch(seed, t, n_leaves, worker):
    base = TF.fold_in(TF.prng_key(seed, t.device), t)
    k0, k1 = TF._words(TF.split(base, n_leaves))
    return TF._key(*TF.threefry2x32(k0, k1, 0, int(worker) & TF.MASK))


@charged("threefry step_keys")
def step_keys(seed: int, t: torch.Tensor, n_leaves: int, worker: int,
              backend: Optional[str] = None) -> torch.Tensor:
    """The distributed chain's (n_leaves, 2) int32 key table of step
    ``t`` (an int64 tensor of one element on the device, read there):
    row l is the key of leaf l (the reference's leaf order) at
    ``worker``."""
    global plain_on_cuda
    if t.dtype != torch.int64 or t.numel() != 1:
        raise ValueError("t must be one int64 on the device")
    if n_leaves < 1:
        raise ValueError(f"n_leaves={n_leaves} < 1")
    if resolve_backend(backend, t) == "cuda":
        out = torch.empty((n_leaves, 2), dtype=torch.int32, device=t.device)
        _launch_keys(out, None, seed, t.contiguous(), n_leaves, worker, 0,
                     t.device)
        return out
    plain_on_cuda += t.is_cuda
    return _step_keys_torch(seed, t, n_leaves, worker)


@charged("threefry advance_keys")
def advance_keys(key: torch.Tensor, n_leaves: int,
                 backend: Optional[str] = None) -> torch.Tensor:
    """Algorithm 1's step: ``key, sub = split(key)``, the new key written
    over ``key`` (a (2,) int32 tensor, in place), and the (n_leaves, 2)
    int32 table ``split(sub, n_leaves)`` (n_leaves may be 0: the key
    advances, as the reference's does every step, and no table)."""
    global plain_on_cuda
    if key.dtype != torch.int32 or key.shape != (2,) or \
            not key.is_contiguous():
        raise ValueError("key must be a contiguous (2,) int32 tensor")
    if n_leaves < 0:
        raise ValueError(f"n_leaves={n_leaves} < 0")
    out = torch.empty((n_leaves, 2), dtype=torch.int32, device=key.device)
    if resolve_backend(backend, key) == "cuda":
        _launch_keys(out, key, 0, None, n_leaves, 0, 1, key.device)
        return out
    plain_on_cuda += key.is_cuda
    nxt, sub = TF.split(key, 2)
    if n_leaves:
        out.copy_(TF.split(sub, n_leaves))
    key.copy_(nxt)
    return out


@charged("threefry uniform")
def uniform(keys: torch.Tensor, leaf: int, n: int, start: int = 0,
            backend: Optional[str] = None,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``jax.random.uniform(keys[leaf], (n,))`` as float32 (elements
    ``start`` .. ``start + n - 1`` of the draw), from an (L, 2) int32 key
    table on the device (a (2,) key is a table of one row). ``out``, a
    float32 tensor of n elements, receives it."""
    global plain_on_cuda, uniform_launches
    keys = keys.reshape(-1, 2)
    if keys.dtype != torch.int32 or not 0 <= leaf < keys.shape[0]:
        raise ValueError(f"need an (L, 2) int32 key table and a leaf in "
                         f"[0, L), got {keys.dtype} {tuple(keys.shape)}, "
                         f"leaf {leaf}")
    if n < 1 or start < 0:
        raise ValueError(f"n={n}, start={start}")
    if out is None:
        out = torch.empty(n, dtype=torch.float32, device=keys.device)
    elif out.dtype != torch.float32 or out.numel() != n or \
            not out.is_contiguous() or out.device != keys.device:
        raise ValueError("out must be a contiguous float32 tensor of n "
                         "elements on the keys' device")
    if resolve_backend(backend, keys, out) == "cuda":
        keys = keys.contiguous()
        err = build.library().rt_threefry_uniform(
            build.ptr(out), n, start, build.ptr(keys), leaf,
            build.stream_ptr(keys.device))
        build.check(err, "threefry_uniform")
        uniform_launches += 1
        return out
    plain_on_cuda += keys.is_cuda
    return out.copy_(TF.uniform(keys[leaf], out.shape, start))


@charged("threefry trunc_normal")
def trunc_normal(keys: torch.Tensor, shape, std: float = 0.02,
                 start: int = 0, backend: Optional[str] = None,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``jax.random.truncated_normal(key, -2, 2, shape) * std`` in float32
    under a (2,) int32 key (-> ``shape``) or each row of an (L, 2) table
    (-> (L, *shape), row l under key l: the reference's ``vmap`` of
    ``_dense`` over a layer stack), elements ``start`` onwards of each
    row's draw. ``out``, a contiguous float32 tensor of that shape on the
    keys' device, receives it."""
    global plain_on_cuda, trunc_normal_launches
    if keys.dtype != torch.int32 or keys.shape[-1:] != (2,) or \
            keys.dim() > 2:
        raise ValueError(f"need a (2,) or (L, 2) int32 key table, got "
                         f"{keys.dtype} {tuple(keys.shape)}")
    shape = TF._shape(shape)
    full = tuple(keys.shape[:-1]) + shape
    n = math.prod(shape)
    if n < 1 or start < 0:
        raise ValueError(f"shape {shape}, start={start}")
    if out is None:
        out = torch.empty(full, dtype=torch.float32, device=keys.device)
    elif out.dtype != torch.float32 or tuple(out.shape) != full or \
            not out.is_contiguous() or out.device != keys.device:
        raise ValueError(f"out must be a contiguous float32 {full} tensor "
                         f"on the keys' device")
    if resolve_backend(backend, keys, out) == "cuda":
        keys = keys.reshape(-1, 2).contiguous()
        a, b = (TF._f32(x) for x in TF.TRUNC_ERF_BITS[(-2.0, 2.0)])
        err = build.library().rt_threefry_trunc_normal(
            build.ptr(out), n, start, build.ptr(keys), keys.shape[0], a,
            b - a, std, build.stream_ptr(keys.device))
        build.check(err, "threefry_trunc_normal")
        trunc_normal_launches += 1
        return out
    plain_on_cuda += keys.is_cuda
    return out.copy_(TF.truncated_normal(keys, -2.0, 2.0, shape, start)
                     .mul_(std))


def _categorical_torch(logits, temp, rng):
    k0, k1 = TF._words(rng)
    nxt = TF._key(*TF.threefry2x32(k0, k1, 0, 0))
    draw = TF._key(*TF.threefry2x32(k0, k1, 0, 1))
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits / torch.clamp_min(temp, 1e-6)[:, None]
    sampled = TF.categorical(draw, scaled).to(torch.int32)
    rng.copy_(torch.where((temp > 0.0)[:, None], nxt, rng))
    return greedy, sampled


@charged("threefry categorical")
def categorical_step(logits: torch.Tensor, temp: torch.Tensor,
                     rng: torch.Tensor, backend: Optional[str] = None):
    """One sampling step of B slots, the reference's: ``keys =
    vmap(split)(rng)``; ``greedy = argmax(logits)``; ``sampled =
    vmap(categorical)(keys[:, 1], logits / max(temp, 1e-6))``; and
    ``rng[b] = keys[b, 0]`` where ``temp[b] > 0``, written in place.
    ``logits`` (B, V) float32, ``temp`` (B,) float32, ``rng`` (B, 2)
    int32, all on one device and read there (graph-safe). Returns the
    (B,) int32 greedy and sampled tokens."""
    global plain_on_cuda, categorical_launches
    if logits.dtype != torch.float32 or logits.dim() != 2:
        raise ValueError(f"logits must be (B, V) float32, got "
                         f"{logits.dtype} {tuple(logits.shape)}")
    B, V = logits.shape
    if temp.dtype != torch.float32 or tuple(temp.shape) != (B,):
        raise ValueError(f"temp must be ({B},) float32")
    if rng.dtype != torch.int32 or tuple(rng.shape) != (B, 2) or \
            not rng.is_contiguous():
        raise ValueError(f"rng must be a contiguous ({B}, 2) int32 tensor")
    if resolve_backend(backend, logits, temp, rng) == "cuda":
        logits, temp = logits.contiguous(), temp.contiguous()
        chunks = -(-V // CAT_CHUNK)
        partials = torch.empty((B, chunks, 4), dtype=torch.int32,
                               device=logits.device)
        tokens = torch.empty((2, B), dtype=torch.int32, device=logits.device)
        err = build.library().rt_threefry_categorical(
            build.ptr(logits), build.ptr(temp), build.ptr(rng), B, V,
            build.ptr(partials), build.ptr(tokens[0]), build.ptr(tokens[1]),
            build.stream_ptr(logits.device))
        build.check(err, "threefry_categorical")
        categorical_launches += 1
        return tokens[0], tokens[1]
    plain_on_cuda += logits.is_cuda
    return _categorical_torch(logits, temp, rng)
