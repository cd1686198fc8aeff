"""FedAT core of the port: tiering, weighted aggregation, the event
scheduler, the simulation environment, the round executor and the
event-driven engine with its server strategies (FedAT, FedAvg, TiFL,
FedAsync), the fault plane (faults.py; the gate in steps.py), the
convergence bounds (theory.py) and the legacy ``run_*`` wrappers
(fedat.py, baselines.py)."""
from repro_torch.core.aggregation import (  # noqa: F401
    client_weights, cross_tier_weights, global_model, intra_tier_average,
    uniform_weights, weighted_average)
from repro_torch.core.engine import (  # noqa: F401
    EngineConfig, Outcome, ServerStrategy, run_engine, run_strategy)
from repro_torch.core.tiering import TierMap, assign_tiers  # noqa: F401
from repro_torch.core import theory  # noqa: F401  (Theorems 5.1/5.2)
