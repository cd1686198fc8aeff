"""The numbers that decide ``correct``, worked out the same way for the
program's observations and the control's.

A change of a model is compared leaf by leaf: for each leaf the gap
between the program's norm and the reference's (not the norm of their
difference), over the reference's norm of that leaf or of the median
leaf, whichever is larger, since some leaves barely move.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

Norms = Dict[str, float]


def leaf_norms(tree: Dict[str, "object"]) -> Norms:
    """Each leaf's L2 norm, summed in float64."""
    return {k: float(v.double().norm()) for k, v in tree.items()}


def _gaps(prog: Norms, ref: Norms) -> List[Tuple[float, str]]:
    """(gap, leaf) for every leaf; a reference norm of exactly zero reads
    any nonzero program norm as infinite, NaN reads infinite."""
    med = statistics.median(ref.values())
    out = []
    for n in sorted(ref):
        den = max(ref[n], med)
        diff = abs(prog[n] - ref[n])
        g = (0.0 if diff == 0 else math.inf) if den == 0 else diff / den
        out.append((math.inf if math.isnan(g) else g, n))
    return out


def worst_leaf_gap(prog: Norms, ref: Norms) -> Tuple[float, str]:
    """The largest leaf gap and its leaf."""
    if sorted(prog) != sorted(ref):
        return math.inf, "leaf sets differ"
    return max(_gaps(prog, ref))


def median_leaf_gap(prog: Norms, ref: Norms) -> float:
    """The median leaf gap: steady from seed to seed where one small
    leaf's gap is noise."""
    if sorted(prog) != sorted(ref):
        return math.inf
    return statistics.median(g for g, _ in _gaps(prog, ref))
