"""The reference's threefry draws on the card (``csrc/threefry.cu``):

  * ``step_keys(seed, t, n_leaves, worker)``: the distributed chain's
    (L, 2) key table of a step, row l
    ``fold_in(fold_in(fold_in(PRNGKey(seed), t), l), worker)``, with
    ``t`` read from device memory (``repro/dist/step.py``);
  * ``advance_keys(key, n_leaves)``: Algorithm 1's chain, ``key, sub =
    split(key)`` with the state key written over in place, and the (L, 2)
    table ``split(sub, L)`` (``repro/core/qadam.py``);
  * ``uniform(keys, leaf, n)``: ``jax.random.uniform(keys[leaf], (n,))``.

Replace no Pallas kernel: the reference draws with XLA's threefry behind
``jax.random.uniform``. Beside each kernel its plain version
(``repro_torch.core.threefry``), which a wrapper runs only for CPU (or
meta) tensors or when asked with ``backend="torch"``, and plain-int
launch counters. A key is a (2,) int32 tensor of the two words' bit
patterns, a key table (L, 2) int32.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import build
from repro_torch.comm.codec import resolve_backend
from repro_torch.core import threefry as TF
from repro_torch.kernels.meta import charged

keys_launches = 0       # rt_threefry_keys launches (both chains)
uniform_launches = 0    # rt_threefry_uniform launches
plain_on_cuda = 0       # plain versions run on CUDA tensors


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
