"""Datacenter-scale straggler mitigation = the paper's tiering, applied to
pods/workers instead of phones.

The profiler collects per-worker step latencies; ``build_tier_map`` feeds
them to core.tiering; ``sync_plan`` decides, per FedAT, which workers train
synchronously (same tier <=> comparable speed) and which pairs only
exchange compressed model deltas asynchronously (cross-tier).  This is the
component that turns "one slow pod stalls the world" (sync DP) into "one
slow pod becomes a slow *tier*" (FedAT).

The port of ``repro/runtime/straggler.py``: numpy only, on the port's
``core/tiering.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core import tiering


@dataclasses.dataclass
class WorkerProfile:
    worker_id: int
    step_times: List[float] = dataclasses.field(default_factory=list)

    def observe(self, dt: float, window: int = 128) -> None:
        self.step_times.append(dt)
        if len(self.step_times) > window:
            self.step_times.pop(0)

    @property
    def latency(self) -> float:
        return float(np.median(self.step_times)) if self.step_times else 0.0


class FleetProfiler:
    def __init__(self, n_workers: int):
        self.workers = [WorkerProfile(i) for i in range(n_workers)]

    def observe(self, worker_id: int, dt: float) -> None:
        self.workers[worker_id].observe(dt)

    def latencies(self) -> np.ndarray:
        return np.array([w.latency for w in self.workers])

    def build_tier_map(self, n_tiers: int) -> tiering.TierMap:
        return tiering.assign_tiers(self.latencies(), n_tiers)


def sync_plan(tm: tiering.TierMap) -> Dict[str, object]:
    """For each tier: members train sync-DP; tiers exchange async.

    Returns the expected *relative* update rates (1/latency, normalized to
    the fastest tier) — the deployment-side estimate of the T_tier counters
    that drive Eq. 3 weights before real counts accumulate.
    """
    rates = []
    for ids in tm.members:
        lat = float(np.mean(tm.latencies[ids]))
        rates.append(1.0 / max(lat, 1e-9))
    rates = np.asarray(rates)
    rates = rates / rates.max()
    return {"tiers": [list(map(int, ids)) for ids in tm.members],
            "relative_rates": rates.tolist()}
