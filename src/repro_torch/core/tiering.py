"""Client tiering module (FedAT §4, same scheme as TiFL).

Profiles per-client response latency (the time to finish one local round)
and partitions clients into M logical tiers: tier_1 fastest ... tier_M
slowest.  The paper splits 100 clients into 5 equal parts by latency; we
implement quantile partitioning with optional periodic re-profiling (clients
whose speed drifts migrate tiers).

Also used at datacenter scale: pods (or DP replica groups) are "clients",
their measured step times are the latency profile, and the tier map feeds
the cross-pod FedAT aggregation (runtime/straggler.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np


@dataclasses.dataclass
class TierMap:
    tier_of: np.ndarray          # (n_clients,) int tier index, 0 = fastest
    members: List[np.ndarray]    # per-tier client id arrays
    latencies: np.ndarray        # profile used to build the map

    @property
    def n_tiers(self) -> int:
        return len(self.members)


def assign_tiers(latencies: Sequence[float], n_tiers: int = 5) -> TierMap:
    """Equal-size partition by sorted response latency (paper §6.1)."""
    lat = np.asarray(latencies, np.float64)
    n = len(lat)
    if n_tiers > n:
        raise ValueError(f"n_tiers={n_tiers} > n_clients={n}")
    order = np.argsort(lat, kind="stable")
    splits = np.array_split(order, n_tiers)
    tier_of = np.zeros(n, np.int32)
    for t, ids in enumerate(splits):
        tier_of[ids] = t
    return TierMap(tier_of=tier_of,
                   members=[np.sort(ids) for ids in splits],
                   latencies=lat)


def profile_latencies(base_compute: Sequence[float],
                      tier_delays: Sequence[tuple],
                      rng: np.random.Generator) -> np.ndarray:
    """The paper's simulation: 5 delay bands (0, 0-5, 6-10, 11-15, 20-30 s)
    randomly assigned on top of base compute time."""
    n = len(base_compute)
    parts = np.array_split(rng.permutation(n), len(tier_delays))
    lat = np.asarray(base_compute, np.float64).copy()
    for band, ids in zip(tier_delays, parts):
        lo, hi = band
        lat[ids] += rng.uniform(lo, hi, size=len(ids))
    return lat


def retier(tm: TierMap, new_latencies: Sequence[float]) -> TierMap:
    """Re-profile: rebuild the map, preserving tier count."""
    return assign_tiers(new_latencies, tm.n_tiers)


def drift_latencies(latencies: Sequence[float], rng: np.random.Generator,
                    drift: float = 0.2) -> np.ndarray:
    """A re-profiling measurement: each client's speed drifts by a uniform
    multiplicative factor in [1-drift, 1+drift] (clients near a tier
    boundary migrate when fed back through :func:`retier`)."""
    lat = np.asarray(latencies, np.float64)
    return lat * (1.0 + rng.uniform(-drift, drift, size=len(lat)))


def sample_round_latency(tm: TierMap, tier: int, client_ids: np.ndarray,
                         rng: np.random.Generator, jitter: float = 0.1
                         ) -> float:
    """A tier's round latency = slowest sampled member (intra-tier sync)."""
    base = tm.latencies[client_ids]
    return float(np.max(base * (1.0 + rng.uniform(0, jitter, len(base)))))
