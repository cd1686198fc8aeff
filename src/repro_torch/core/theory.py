"""Executable form of FedAT's convergence analysis (paper §5, Appendix A).

The port of ``repro/core/theory.py``: numpy and the standard library only,
kept as a copy (not imported from the reference), so its values equal the
reference's bitwise.

Theorem 5.1 (strongly convex):  after T global updates,

    E[f(w_T) - f*] <= (1 - 2 mu B eta sigma)^T (f(w_0) - f*)
                      + (L / 2) eta^2 gamma^2 B^2 G^2 c^2

Theorem 5.2 (non-convex):

    sum_t B E[|grad f(w_t)|^2] <= (f(w_0) - f*) / (B eta sigma)
                                  + (L / (2 sigma)) T^2 eta gamma^2 B G^2 c^2

with B = T_{tier(M+1-m)} / T <= 1 the Eq. 3 weight, gamma the local
inexactness (Def. 5.3), G the gradient-norm bound (Asm. 5.2), c the tier
size, sigma the tier-gradient alignment (Asm. 5.3).

These functions make the bounds computable so tests (and users picking
eta/lambda) can check the *qualitative contracts* the paper proves:
contraction requires 2 mu B eta sigma < 1; the asymptotic error floor
scales with eta^2 gamma^2 c^2; slower tiers (larger Eq. 3 weight B) tighten
the contraction factor but widen the floor.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Regime:
    mu: float = 0.1        # strong convexity
    L: float = 1.0         # smoothness
    eta: float = 0.05      # server learning rate
    sigma: float = 1.0     # tier-gradient alignment (Asm. 5.3)
    gamma: float = 0.5     # local inexactness (Def. 5.3)
    G: float = 1.0         # gradient-norm bound (Asm. 5.2)
    c: int = 10            # clients per tier


def eq3_weight(update_counts: Sequence[float], tier: int) -> float:
    """B for ``tier`` (0-indexed): the mirror tier's share of updates."""
    counts = np.asarray(update_counts, float)
    total = counts.sum()
    if total == 0:
        return 1.0 / len(counts)
    return float(counts[::-1][tier] / total)


def contraction_factor(r: Regime, B: float) -> float:
    """(1 - 2 mu B eta sigma); < 1 required for linear convergence."""
    return 1.0 - 2.0 * r.mu * B * r.eta * r.sigma


def error_floor(r: Regime, B: float) -> float:
    """The additive term of Theorem 5.1 (per-step noise floor)."""
    return 0.5 * r.L * (r.eta ** 2) * (r.gamma ** 2) * (B ** 2) * \
        (r.G ** 2) * (r.c ** 2)


def convex_bound(r: Regime, B: float, T: int, f0_gap: float) -> float:
    """Theorem 5.1 RHS after T updates (geometric sum of the floor)."""
    rho = contraction_factor(r, B)
    if not 0.0 <= rho < 1.0:
        return math.inf
    # geometric accumulation of the per-step floor
    floor = error_floor(r, B)
    return (rho ** T) * f0_gap + floor * (1 - rho ** T) / (1 - rho)


def nonconvex_bound(r: Regime, B: float, T: int, f0_gap: float) -> float:
    """Theorem 5.2 RHS: bound on sum_t B E[|grad|^2]."""
    return f0_gap / (B * r.eta * r.sigma) + \
        0.5 * (r.L / r.sigma) * (T ** 2) * r.eta * (r.gamma ** 2) * B * \
        (r.G ** 2) * (r.c ** 2)


def max_stable_eta(r: Regime, B: float) -> float:
    """Largest eta keeping the contraction factor in (0, 1)."""
    return 1.0 / (2.0 * r.mu * B * r.sigma)


def bound_curve(r: Regime, counts: Sequence[float], T: int,
                f0_gap: float = 1.0) -> List[float]:
    """Theorem 5.1 trajectory using the *worst* per-step Eq. 3 weight
    (B varies per iteration in the paper; the worst case is the bound)."""
    Bs = [eq3_weight(counts, m) for m in range(len(counts))]
    B = max(Bs)
    return [convex_bound(r, B, t, f0_gap) for t in range(T + 1)]
