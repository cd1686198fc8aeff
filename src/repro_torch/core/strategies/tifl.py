"""TiFL as an engine strategy: synchronous tiered rounds — pick one tier
per round (uniform random), FedAvg-style aggregation of that tier into the
single global model.  Differs from FedAvg only in the sampling pool and in
burning the round budget when the drawn tier has no live members."""
from __future__ import annotations

from repro_torch.core.engine import EngineContext
from repro_torch.core.simulation import SimEnv
from repro_torch.core.strategies.fedavg import FedAvgStrategy


class TiFLStrategy(FedAvgStrategy):
    name = "tifl"
    seed_offset = 31
    reschedule_on_empty = True

    def _sample(self, env: SimEnv, ctx: EngineContext):
        m = int(ctx.rng.integers(env.tm.n_tiers))
        alive = env.alive(ctx.q.now)
        pool = env.tm.members[m][alive[env.tm.members[m]]]
        return m, env.sample_clients(pool, env.sc.clients_per_round, ctx.rng)
