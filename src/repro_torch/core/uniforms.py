"""The uniforms of the stochastic quantizers (TernGrad), the reference's
own: ``jax.random.uniform`` under the reference's key chains, drawn by
threefry2x32 (``core.threefry``; on the card ``csrc/threefry.cu`` through
``kernels.prng``) outside the quantizer kernels, as the reference draws
them outside its kernels.

  * The distributed chain (``dist.step``, ``repro/dist/step.py``): leaf
    l's key at step t and inter-tier worker w is
    ``fold_in(fold_in(fold_in(PRNGKey(seed), t), l), w)``.
    :func:`step_keys` makes a step's (L, 2) table in one launch from t
    in device memory (a CUDA graph of K steps reads each step's t from
    the session's step table); :func:`draw` draws a leaf's uniforms from
    it.
  * Algorithm 1's chain (``core.qadam``, ``repro/core/qadam.py``): the
    optimizer state holds a key; each step ``key, sub = split(key)`` (in
    place, on the device) and leaf l draws under ``split(sub, L)[l]``
    (:func:`advance_keys`).

Leaves are indexed in the reference's leaf order (dict keys sorted).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import prng

step_keys = prng.step_keys
advance_keys = prng.advance_keys


def draw(keys: torch.Tensor, leaf: int, n: int,
         backend: Optional[str] = None) -> torch.Tensor:
    """n float32 uniforms in [0, 1) of leaf ``leaf`` of the key table
    ``keys``: ``jax.random.uniform(keys[leaf], (n,))``."""
    return prng.uniform(keys, leaf, n, backend=backend)


def step_tensor(t: int, device) -> torch.Tensor:
    """The step count ``t`` as the (1,) int64 tensor on ``device`` that
    :func:`step_keys` reads (a pinned, non-blocking copy to a GPU)."""
    h = torch.tensor([t], dtype=torch.int64)
    device = torch.device(device)
    if device.type == "cuda":
        return h.pin_memory().to(device, non_blocking=True)
    return h.to(device)


def draw_uniform(seed: int, t: int, leaf: int, worker: int, n: int,
                 device) -> torch.Tensor:
    """n float32 uniforms in [0, 1) for step ``t``, leaf ``leaf`` (its
    index in the reference's leaf order) and ``worker``: the reference's
    distributed draw, ``jax.random.uniform(fold_in(fold_in(fold_in(
    PRNGKey(seed), t), leaf), worker), (n,))``, through the kernels on a
    GPU and the plain versions on the CPU."""
    keys = step_keys(seed, step_tensor(t, device), leaf + 1, worker)
    return draw(keys, leaf, n)
