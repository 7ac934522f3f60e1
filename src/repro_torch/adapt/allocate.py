"""Bit-allocation policy: per-leaf lane widths under a wire-byte budget
(port of ``repro/adapt/allocate.py``, a copy on the port's
``comm/bits.py``; plain Python, no kernel).

Given per-leaf gradient statistics (amax + mean-square EMAs harvested
from the device stats ring, :mod:`repro_torch.adapt.stats`) this module
solves for a per-leaf quantization width from the supported lane set
(2/3/4/6/8/16-bit, :data:`repro_torch.comm.bits.SUPPORTED_BITS`) minimizing
total expected quantization distortion subject to a total all-to-all
byte budget.

Width -> codec mapping (``WIDTH_SPECS``): every lane is an existing
registry codec, so byte accounting stays registry-sourced:

  ====  =======================  ========================================
  bits  spec                     grid
  ====  =======================  ========================================
  2     ``blockwise:256``        per-block sign codes (Zheng et al.)
  3     ``log:2``                log grid, 2 magnitude levels
  4     ``log:6``                the paper's fixed default (k_g = 6)
  6     ``log:30``               log grid, 30 magnitude levels
  8     ``log:126``              log grid, 126 magnitude levels
  16    ``uniform_amax:14:w16``  14-bit uniform + sign on a 16-bit lane
  ====  =======================  ========================================

The solver is the classic rate-distortion ladder: per group, take the
lower convex hull of (wire bytes, expected distortion) over the lane
set; hull-to-hull steps have decreasing distortion-per-byte by
convexity. Merge all groups' steps into one ratio-sorted sequence -
generated *budget-independently* - and a given budget applies the
longest affordable prefix. A larger budget therefore always yields a
plan pointwise at least as wide (monotone in budget, a property the
fuzz tests pin down).

``payload_nbytes`` packs whole lane groups, so for tiny leaves a wider
lane can genuinely cost fewer bytes (1 element at 3-bit = 3 bytes, at
4-bit = 1 byte); the hull handles this naturally - dominated points
(costlier and no more accurate) never enter a chain.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

from repro_torch.comm import bits as B

# Ascending lane widths and the registry codec spec realizing each one.
WIDTHS: Tuple[int, ...] = tuple(sorted(B.SUPPORTED_BITS))
WIDTH_SPECS: Dict[int, str] = {
    2: "blockwise:256",
    3: "log:2",
    4: "log:6",
    6: "log:30",
    8: "log:126",
    16: "uniform_amax:14:w16",
}
# log-grid k_g realizing each log lane (lane_bits_for(k_g + 1)).
_LOG_K = {3: 2, 4: 6, 6: 30, 8: 126}

# Mean-square relative error of round-to-nearest on the power-of-two
# log grid for in-range magnitudes: representable points amax * 2^-j,
# worst-case relative error 1/3, E[rel^2] ~ 0.037 for log-uniform
# magnitudes.
LOG_REL2 = 0.037


def _halfnormal_below(t: float, meansq: float) -> float:
    """E[x^2 ; |x| < t] for x half-normal with E[x^2] = meansq."""
    if meansq <= 0.0 or t <= 0.0:
        return 0.0
    u = t / math.sqrt(meansq)
    return meansq * (math.erf(u / math.sqrt(2.0))
                     - math.sqrt(2.0 / math.pi) * u * math.exp(-0.5 * u * u))


def expected_distortion(width: int, amax: float, meansq: float) -> float:
    """Expected per-element squared quantization error at ``width`` bits.

    Distortion models (closed-form, driven only by the harvested
    ``amax`` / ``meansq`` stats):

    * 2-bit blockwise sign codes: x -> sign(x) * E|x| keeps the
      mean-|.| direction; under a half-normal magnitude model the
      residual energy is ``(1 - 2/pi) * meansq``.
    * log:k: magnitudes below ``amax * 2^-k / 2`` snap to zero (that
      energy is lost outright); in-range magnitudes pay LOG_REL2
      relative error.
    * 16-bit uniform: step ``amax / 2^14``, variance step^2 / 12.
    """
    amax = max(float(amax), 0.0)
    meansq = max(float(meansq), 0.0)
    if width == 2:
        return (1.0 - 2.0 / math.pi) * meansq
    if width in _LOG_K:
        k = _LOG_K[width]
        t = amax * (2.0 ** -k) * 0.5
        tail2 = _halfnormal_below(t, meansq)
        return LOG_REL2 * (meansq - tail2) + tail2
    if width == 16:
        step = amax / float(2 ** 14)
        return step * step / 12.0
    raise ValueError(f"unsupported width {width}: pick from {WIDTHS}")


@dataclasses.dataclass(frozen=True)
class Group:
    """One allocation unit: a leaf (or bucket of leaves) on the wire.

    ``c`` is the padded per-worker chunk length (the wire row width
    the all-to-all actually moves); ``numel`` the true element count
    used to weight distortion.
    """
    name: str
    numel: int
    c: int
    amax: float
    meansq: float


def group_cost(g: Group, width: int, n_workers: int) -> int:
    """Exact a2a bytes for this group at ``width`` (registry math)."""
    return n_workers * B.payload_nbytes(g.c, width)


def plan_cost(groups: Sequence[Group], widths: Sequence[int],
              n_workers: int) -> int:
    return sum(group_cost(g, w, n_workers) for g, w in zip(groups, widths))


def group_distortion(g: Group, width: int) -> float:
    return g.numel * expected_distortion(width, g.amax, g.meansq)


def _hull_chain(g: Group, n_workers: int) -> List[Tuple[int, float, int]]:
    """Lower convex hull of (cost, distortion, width), cost ascending.

    The first vertex is the cheapest achievable point (ties broken by
    lower distortion, then narrower width); subsequent vertices strictly
    improve distortion at strictly higher cost, with step ratios
    (distortion drop per byte) decreasing along the chain.
    """
    pts = sorted((group_cost(g, w, n_workers), group_distortion(g, w), w)
                 for w in WIDTHS)
    stair: List[Tuple[int, float, int]] = []
    for c, d, w in pts:
        if not stair or d < stair[-1][1]:
            stair.append((c, d, w))
    hull: List[Tuple[int, float, int]] = []
    for p in stair:
        while len(hull) >= 2:
            (c1, d1, _), (c2, d2, _) = hull[-2], hull[-1]
            c3, d3, _ = p
            # middle vertex is on/above the chord from hull[-2] to p
            if (d2 - d1) * (c3 - c1) >= (d3 - d1) * (c2 - c1):
                hull.pop()
            else:
                break
        hull.append(p)
    return hull


def upgrade_sequence(groups: Sequence[Group], n_workers: int
                     ) -> List[Tuple[int, int, int]]:
    """Budget-independent ordered upgrades ``(group_idx, width, dcost)``.

    Steps descend by distortion reduction per extra wire byte; ties
    break on (group index, width) so the sequence - and therefore
    every budget's plan - is deterministic.
    """
    steps = []
    for gi, g in enumerate(groups):
        chain = _hull_chain(g, n_workers)
        for (c1, d1, _), (c2, d2, w2) in zip(chain[:-1], chain[1:]):
            steps.append(((d1 - d2) / (c2 - c1), gi, w2, c2 - c1))
    steps.sort(key=lambda s: (-s[0], s[1], s[2]))
    return [(gi, w, dcost) for _, gi, w, dcost in steps]


def allocate(groups: Sequence[Group], budget_bytes: int,
             n_workers: int) -> Tuple[int, ...]:
    """Per-group lane widths: longest affordable prefix of the ladder.

    Every group starts at its hull's cheapest vertex. The fixed upgrade
    sequence is walked in order; each upgrade applies while the running
    plan cost stays within ``budget_bytes``. Walking a *prefix* - never
    skipping an unaffordable step to take a cheaper later one - is what
    buys monotonicity in the budget.
    """
    if not groups:
        return ()
    widths = []
    cost = 0
    for g in groups:
        c0, _, w0 = _hull_chain(g, n_workers)[0]
        widths.append(w0)
        cost += c0
    for gi, w, dcost in upgrade_sequence(groups, n_workers):
        if cost + dcost > budget_bytes:
            break   # prefix semantics: stop at the first miss
        widths[gi] = w
        cost += dcost
    return tuple(widths)


def allocate_specs(groups: Sequence[Group], budget_bytes: int,
                   n_workers: int) -> Tuple[str, ...]:
    """Codec specs (``get_codec``-parsable) for the allocated widths."""
    return tuple(WIDTH_SPECS[w]
                 for w in allocate(groups, budget_bytes, n_workers))


def baseline_cost(groups: Sequence[Group], n_workers: int,
                  width: int = 4) -> int:
    """A2A bytes if every group used one fixed width (default log:6)."""
    return plan_cost(groups, [width] * len(groups), n_workers)
