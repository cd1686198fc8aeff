"""FedAT entry point (Algorithm 1): intra-tier synchronous + cross-tier
asynchronous training with weighted aggregation (Eq. 3), proximal local
objective (Eq. 5) and lossy uplink/downlink compression (§4.3).

The port of ``repro/core/fedat.py``.  The event loop lives in
:mod:`repro_torch.core.engine`, the FedAT policy in
:mod:`repro_torch.core.strategies.fedat`, the declarative user surface in
:mod:`repro_torch.api`.  This module keeps the legacy ``run_fedat(env,
FedATConfig)`` surface — a thin :class:`~repro_torch.api.ExperimentSpec`
wrapper over the environment's own device — plus the codec helpers,
routed through the transport registry.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.compress import transport
from repro_torch.core.engine import EngineConfig, Metrics, run_engine  # noqa: F401
from repro_torch.core.simulation import SimEnv


@dataclasses.dataclass
class FedATConfig:
    total_updates: int = 200       # T: global update budget
    precision: Optional[int] = 4   # polyline precision; None = no compression
    weighted: bool = True          # Eq. 3 on/off (ablation: uniform)
    use_prox: bool = True          # Eq. 5 constraint on/off
    eval_every: int = 10
    seed: int = 0
    #: transport codec override ("polyline:<p>", "quantize8", "quantize16",
    #: "none"); None derives it from ``precision``
    codec: Optional[str] = None


def _polyline_codec(precision: Optional[int]) -> transport.Codec:
    """Resolve the paper's precision knob through the transport registry."""
    return transport.get_codec(
        "none" if precision is None else f"polyline:{precision}")


def fake_polyline(params, precision: Optional[int]):
    """The codec's exact lossy step: round to `precision` decimals."""
    return _polyline_codec(precision).lossy(params)


def measure_ratio(params, precision: Optional[int]) -> float:
    """Wire bytes / raw f32 bytes for the polyline codec, on the same
    size-capped sample the engine's byte accounting uses."""
    return _polyline_codec(precision).measure_ratio(params)


def run_fedat(env: SimEnv, fc: FedATConfig) -> Metrics:
    """Spec wrapper: the legacy surface over :func:`repro_torch.api.build`
    on ``env`` (and so on its device)."""
    from repro_torch import api
    codec = fc.codec.name if isinstance(fc.codec, transport.Codec) \
        else fc.codec
    spec = api.ExperimentSpec.from_sim_config(env.sc)
    spec.strategy = api.StrategySpec(
        "fedat", {"precision": fc.precision, "weighted": fc.weighted,
                  "use_prox": fc.use_prox})
    spec.transport = api.TransportSpec(codec=codec)
    spec.engine.total_updates = fc.total_updates
    spec.engine.eval_every = fc.eval_every
    spec.engine.seed = fc.seed
    return api.build(spec, env=env).run().metrics
