"""The uniforms of the stochastic quantizers (TernGrad), drawn outside
the kernels as the reference draws them outside its kernels: one pure
function of (seed, step, leaf, worker), shared by Algorithm 1's
optimizers (``core.qadam``) and the distributed modes (``dist.step``
re-exports it)."""
from __future__ import annotations

import torch


def _mix64(h: int, v: int) -> int:
    """One splitmix64 round of h folded with v (64-bit)."""
    z = (h ^ (v & 0xFFFFFFFFFFFFFFFF)) + 0x9E3779B97F4A7C15
    z &= 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


def draw_uniform(seed: int, t: int, leaf: int, worker: int, n: int,
                 device) -> torch.Tensor:
    """n float32 uniforms in [0, 1) for step ``t``, leaf ``leaf`` (its
    index in the reference's leaf order, keys sorted) and ``worker``:
    ``torch.rand`` from a generator on ``device`` seeded by a pure
    function of the four, so a run and a resumed run draw the same and
    workers draw independently (the reference folds a key per (step,
    leaf, worker); torch has no threefry, so the draws differ from the
    reference's)."""
    h = 0
    for v in (seed, t, leaf, worker):
        h = _mix64(h, v)
    gen = torch.Generator(device=device)
    gen.manual_seed(h & 0x7FFFFFFFFFFFFFFF)
    return torch.rand(n, generator=gen, device=device)
