"""Baseline FL methods from the paper's evaluation (§6.1):

  * FedAvg   — synchronous; sample K clients globally, wait for the slowest.
  * TiFL     — synchronous tiered; pick one tier per round (uniform random),
               FedAvg-style aggregation of that tier into the single
               global model.
  * FedAsync — fully asynchronous; every client updates the server model
               independently with polynomial staleness weighting
               (Xie et al. 2019).

The port of ``repro/core/baselines.py``: each is a strategy over the
shared event loop (core/engine.py + core/strategies/); these wrappers
keep the legacy ``run_*(env, BaselineConfig)`` surface as thin shims over
:class:`~repro_torch.api.ExperimentSpec`, on the environment's device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

from repro_torch.core.engine import EngineConfig, Metrics, run_engine  # noqa: F401
from repro_torch.core.simulation import SimEnv


@dataclasses.dataclass
class BaselineConfig:
    total_updates: int = 200
    eval_every: int = 10
    seed: int = 0
    # fedasync
    alpha: float = 0.6
    staleness_exp: float = 0.5


def _run(env: SimEnv, bc: BaselineConfig, name: str,
         kwargs: Dict[str, Any]) -> Metrics:
    from repro_torch import api
    spec = api.ExperimentSpec.from_sim_config(env.sc)
    spec.strategy = api.StrategySpec(name, kwargs)
    spec.engine.total_updates = bc.total_updates
    spec.engine.eval_every = bc.eval_every
    spec.engine.seed = bc.seed
    return api.build(spec, env=env).run().metrics


def run_fedavg(env: SimEnv, bc: BaselineConfig) -> Metrics:
    return _run(env, bc, "fedavg", {})


def run_tifl(env: SimEnv, bc: BaselineConfig) -> Metrics:
    return _run(env, bc, "tifl", {})


def run_fedasync(env: SimEnv, bc: BaselineConfig) -> Metrics:
    return _run(env, bc, "fedasync",
                {"alpha": bc.alpha, "staleness_exp": bc.staleness_exp})
