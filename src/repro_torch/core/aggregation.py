"""Cross-tier weighted aggregation (FedAT Eq. 3 / Algorithm 1).

With per-tier update counts T_1..T_M (total T), tier m gets weight

    w_m = T_{M+1-m} / T

i.e. the *slowest* tier inherits the *fastest* tier's update count.  Until
the first update (T == 0) the weights are uniform.

The engine computes the weight vectors on the host in numpy, once per
event, by the ``*_host`` twins (verbatim copies of the reference's, bitwise
equal): the inputs are exact small integers, so the f32 sums are exact and
IEEE division is correctly rounded.  The torch forms
(:func:`cross_tier_weights`, :func:`uniform_weights`,
:func:`client_weights`) give the same bits on a tensor, on the device of
their input; :func:`intra_tier_average` and :func:`global_model` (the
reference's Eq. 4 and Algorithm 1 averages) run them on the models'
device.  Only :func:`weighted_average` touches model-sized tensors.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


def cross_tier_weights(update_counts) -> torch.Tensor:
    """update_counts: (M,) int -> (M,) fp32 weights, reversed-count
    normalized (uniform until the first update)."""
    counts = torch.as_tensor(update_counts).to(torch.float32)
    total = counts.sum()
    rev = counts.flip(0)
    uniform = torch.full_like(rev, 1.0 / rev.shape[0])
    return torch.where(total > 0, rev / torch.clamp_min(total, 1.0), uniform)


def uniform_weights(n_tiers: int) -> torch.Tensor:
    return torch.full((n_tiers,), 1.0 / n_tiers, dtype=torch.float32)


def client_weights(n_samples) -> torch.Tensor:
    """Eq. 4 normalized client weights n_k / N_c (zero-count slots get
    exactly 0)."""
    w = torch.as_tensor(n_samples).to(torch.float32)
    return w / torch.clamp_min(w.sum(), 1.0)


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


def weighted_average(stacked: Params, weights: torch.Tensor,
                     dtype: Optional[torch.dtype] = None) -> Params:
    """stacked: dict of (M, ...) tensors -> dict of weighted means over M.

    The fp32 product is materialised first and then summed over axis 0,
    the order the reference pins with an optimization barrier; it is not
    contracted into one einsum.  Exactly-zero weights (padding slots) add
    exactly-zero terms.  Each mean is cast to its leaf's dtype, or to
    ``dtype`` if given (fp32 partial sums that a collective completes).
    """
    w = weights.to(torch.float32)
    out = {}
    for k, leaf in stacked.items():
        prod = leaf.to(torch.float32) * w.reshape((-1,) + (1,) * (leaf.dim() - 1))
        out[k] = prod.sum(dim=0).to(dtype or leaf.dtype)
    return out


def _on_device_of(stacked: Params, weights: torch.Tensor) -> torch.Tensor:
    return weights.to(next(iter(stacked.values())).device)


def intra_tier_average(client_models: Params, n_samples) -> Params:
    """FedAvg within a tier (Eq. 4): client k weighted by n_k / N_c.
    ``client_models``: dict of (K, ...) tensors; zero-count padding slots
    add exactly-zero terms."""
    w = client_weights(n_samples)
    return weighted_average(client_models, _on_device_of(client_models, w))


def global_model(tier_models: Params, update_counts) -> Params:
    """WeightedAverage() from Algorithm 1: the (M, ...) tier models under
    the Eq. 3 cross-tier weights."""
    w = cross_tier_weights(update_counts)
    return weighted_average(tier_models, _on_device_of(tier_models, w))
