"""Elastic scaling: reshape training state when the tier pool changes.

The port of ``repro/runtime/elastic.py``.  When a pod (tier) is lost or
regained, FedAT keeps training: the tier map shrinks/grows and the
cross-tier weights renormalize (Eq. 3 is defined for any M).  This module
handles the mechanical part:

  * ``reshard(tree, target)``: place a state tree for this rank on a new
    mesh (each rank keeps its pod slots of a multi-pod FedAT state; the
    FSDP shards over ``data`` are cut by ``sharding.shard_tree`` with a
    step's ``state_shardings``) or on a device;
  * ``shrink_pods / grow_pods``: adjust the pod-stacked leading dim of a
    multi-pod FedAT state (dropping a tier keeps the survivors' models;
    adding a tier bootstraps the newcomer from the Eq. 3 global model);
  * ``masked_cross_weights`` / ``bootstrap_tier``: the blackout moves the
    engine strategies make on their fixed-M tier stack.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from repro_torch.core import aggregation
from repro_torch.device import DeviceLike, resolve_device


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def reshard(tree: Any, target: Any = None,
            device: DeviceLike = None) -> Any:
    """``tree`` placed for this rank: every tensor leaf on ``device``
    (None = the card), or on ``target`` when it is a device.  When
    ``target`` is a mesh with a pod axis of P > 1 and ``tree`` a
    multi-pod FedAT state (``params``/``opt``/``step``/``counts``), each
    pod-stacked leaf with a leading dim of P keeps this rank's pod slot
    (a leading dim of 1); ``counts`` stays whole, as Eq. 3 reads every
    tier's."""
    if target is not None and not hasattr(target, "shape"):
        device = target
    dev = resolve_device(device)
    tree = _map(lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x,
                tree)
    pods = getattr(target, "shape", {}).get("pod", 1)
    if pods == 1 or not (isinstance(tree, dict) and "counts" in tree):
        return tree
    p = target.coord("pod")

    def keep(x):
        return x[p:p + 1] if x.shape[0] == pods else x
    return {k: (v if k == "counts" else _map(keep, v))
            for k, v in tree.items()}


def shrink_pods(state: Dict[str, Any], keep: Sequence[int]) -> dict:
    """Drop lost tiers. ``keep``: surviving pod indices (e.g. [0, 2, 3])."""
    def take(x):
        return x.index_select(0, torch.as_tensor(list(keep),
                                                 device=x.device))

    return {"params": _map(take, state["params"]),
            "opt": _map(take, state["opt"]),
            "step": take(state["step"]),
            "counts": take(state["counts"])}


def _global_model(params: Dict[str, Any], counts: torch.Tensor):
    """Eq. 3 over the pod-stacked ``params`` with ``counts`` update counts
    (the reference's ``aggregation.global_model``)."""
    w = torch.from_numpy(aggregation.cross_tier_weights_host(
        counts.detach().cpu().numpy()))
    return _map(lambda x: aggregation.weighted_average(
        {"x": x}, w.to(x.device))["x"], params)


def grow_pods(state: Dict[str, Any], n_new: int) -> dict:
    """Add tiers: newcomers start from the current Eq. 3 global model with
    zero update count (they are 'slowest' until they catch up)."""
    w_global = _global_model(state["params"], state["counts"])

    def extend(stacked, single):
        rep = single[None].expand((n_new,) + tuple(single.shape))
        return torch.cat([stacked, rep.to(stacked.dtype)], dim=0)

    def zeros(stacked):
        return torch.cat([stacked, torch.zeros(
            (n_new,) + tuple(stacked.shape[1:]), dtype=stacked.dtype,
            device=stacked.device)], dim=0)

    def merge(stacked, single):
        if isinstance(stacked, dict):
            return {k: merge(stacked[k], single[k]) for k in stacked}
        return extend(stacked, single)

    step = state["step"]
    return {"params": merge(state["params"], w_global),
            "opt": _map(zeros, state["opt"]),
            "step": torch.cat([step, step.max().expand(n_new)]),
            "counts": torch.cat([state["counts"], torch.zeros(
                n_new, dtype=state["counts"].dtype,
                device=state["counts"].device)])}


def masked_cross_weights(counts: np.ndarray,
                         alive: np.ndarray) -> np.ndarray:
    """Eq. 3 cross-tier weights renormalized over the surviving M' tiers.

    A blacked-out tier gets weight exactly 0; the survivors' weights are
    the paper's reversed-update-count weights computed *as if only they
    existed* (compress -> Eq. 3 -> scatter back), so they sum to 1 over
    M'.  Host-side f32, like ``aggregation.cross_tier_weights_host``.
    """
    alive = np.asarray(alive, bool)
    w = np.zeros(len(alive), np.float32)
    if alive.any():
        w[alive] = aggregation.cross_tier_weights_host(
            np.asarray(counts)[alive])
    return w


def bootstrap_tier(tier_models: Dict[str, torch.Tensor],
                   w_global: Dict[str, torch.Tensor],
                   m: int) -> Dict[str, torch.Tensor]:
    """A returning (post-blackout) tier restarts from the current global
    model: slot ``m`` of the (M, ...)-stacked tier models is overwritten
    in place with ``w_global``, in the stack's dtype."""
    for k, s in tier_models.items():
        s[m] = w_global[k].to(s.dtype)
    return tier_models
