"""Cross-tier weighted aggregation (FedAT Eq. 3 / Algorithm 1).

With per-tier update counts T_1..T_M (total T), tier m gets weight

    w_m = T_{M+1-m} / T

i.e. the *slowest* tier inherits the *fastest* tier's update count.  Until
the first update (T == 0) the weights are uniform.

The weight vectors are tiny and computed on the host in numpy, once per
event, by the twins below (verbatim copies of the reference's, bitwise
equal): the inputs are exact small integers, so the f32 sums are exact and
IEEE division is correctly rounded.  Only :func:`weighted_average` touches
model-sized tensors.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


def cross_tier_weights_host(update_counts) -> np.ndarray:
    """Eq. 3 weights: reversed update counts over their total."""
    counts = np.asarray(update_counts, np.float32)
    rev = counts[::-1]
    total = counts.sum(dtype=np.float32)
    if total > 0:
        return rev / np.maximum(total, np.float32(1.0))
    return np.full_like(rev, 1.0 / rev.shape[0])


def uniform_weights_host(n_tiers: int) -> np.ndarray:
    return np.full((n_tiers,), 1.0 / n_tiers, np.float32)


def client_weights_host(n_samples) -> np.ndarray:
    """Eq. 4 weights n_k / N_c (zero-count padding slots get exactly 0)."""
    w = np.asarray(n_samples, np.float32)
    return w / np.maximum(w.sum(dtype=np.float32), np.float32(1.0))


def weighted_average(stacked: Params, weights: torch.Tensor) -> Params:
    """stacked: dict of (M, ...) tensors -> dict of weighted means over M.

    The fp32 product is materialised first and then summed over axis 0,
    the order the reference pins with an optimization barrier; it is not
    contracted into one einsum.  Exactly-zero weights (padding slots) add
    exactly-zero terms.
    """
    w = weights.to(torch.float32)
    out = {}
    for k, leaf in stacked.items():
        prod = leaf.to(torch.float32) * w.reshape((-1,) + (1,) * (leaf.dim() - 1))
        out[k] = prod.sum(dim=0).to(leaf.dtype)
    return out
