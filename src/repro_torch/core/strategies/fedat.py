"""FedAT as an engine strategy: intra-tier synchronous rounds + cross-tier
asynchronous aggregation (Algorithm 1) over a codec-compressed link.

Event = (tier m, sampled client ids).  Every tier-completion event triggers

  1. decompress client payloads — modeled by the codec's lossy step,
  2. intra-tier weighted average (Eq. 4)  -> w_{tier_m},
  3. T_{tier_m} += 1 ; t += 1,
  4. global w = sum_m  T_{tier_(M+1-m)} / T * w_{tier_m}   (Eq. 3),
  5. compress + send w to the next ready tier.

Wire bytes are accounted with the codec's measured payload ratio,
re-measured at every eval point.  The port of
``repro/core/strategies/fedat.py`` in flat mode (no topology, no fault
plane): the rng draws happen in the reference's order.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.compress import transport
from repro_torch.core import aggregation
from repro_torch.core.engine import (EngineConfig, EngineContext, Outcome,
                                     ServerStrategy)
from repro_torch.core.simulation import SimEnv
from repro_torch.core.tiering import sample_round_latency


class FedATStrategy(ServerStrategy):
    name = "fedat"
    seed_offset = 17

    def __init__(self, precision: Optional[int] = 4,
                 codec: Union[str, transport.Codec, None] = None,
                 weighted: bool = True, use_prox: bool = True,
                 ratio_sample_elems: Optional[int]
                 = transport.RATIO_SAMPLE_ELEMS):
        """``codec`` overrides the paper's default link; when None, it is
        derived from ``precision`` (polyline:<p>, or identity links for
        precision=None)."""
        if codec is None:
            codec = "none" if precision is None else f"polyline:{precision}"
        self.codec = transport.get_codec(codec)
        self.weighted = weighted
        self.use_prox = use_prox
        self.ratio_sample_elems = ratio_sample_elems

    def bind(self, env: SimEnv, cfg: EngineConfig) -> None:
        M = env.tm.n_tiers
        self.tier_models = {k: torch.stack([v] * M)
                            for k, v in env.params0.items()}   # (M, ...)
        # update counts stay on the host: the Eq. 3 weights are computed
        # there (aggregation.cross_tier_weights_host)
        self.counts = np.zeros(M, np.int64)
        self.w_global = {k: v.clone() for k, v in env.params0.items()}
        self._ratio = self.codec.measure_ratio(env.params0,
                                               self.ratio_sample_elems)

    def bootstrap(self, env: SimEnv, ctx: EngineContext) -> None:
        # every tier starts round 0 at its own pace
        for m in range(env.tm.n_tiers):
            ids = env.sample_clients(env.tm.members[m],
                                     env.sc.clients_per_round, ctx.rng)
            ctx.q.push(sample_round_latency(env.tm, m, ids, ctx.rng),
                       (m, ids))

    def _cross_weights(self) -> np.ndarray:
        if self.weighted:
            return aggregation.cross_tier_weights_host(self.counts)
        return aggregation.uniform_weights_host(len(self.counts))

    def on_event(self, env: SimEnv, ctx: EngineContext, now: float,
                 actor) -> Outcome:
        m, ids = actor
        alive = env.alive(now)
        ids = ids[alive[ids]]
        if len(ids) == 0:  # whole sample dropped: reschedule the tier
            pool = env.tm.members[m][alive[env.tm.members[m]]]
            ids = env.sample_clients(pool, env.sc.clients_per_round, ctx.rng)
            if len(ids):
                ctx.q.push(sample_round_latency(env.tm, m, ids, ctx.rng),
                           (m, ids))
            return Outcome.DISCARD

        # one round: codec downlink -> local train -> codec uplink -> Eq. 4
        # -> tier slot update -> Eq. 3 (core/executor.py); bytes use the
        # live count, Eq. 3 weights the post-increment counts
        ctx.bytes_down += len(ids) * env.model_bytes * self._ratio
        self.counts[m] += 1
        cw = self._cross_weights()
        self.w_global, self.tier_models = ctx.executor.fedat_round(
            self.w_global, self.tier_models, m, ids, ctx.draw_seed(),
            codec=self.codec, use_prox=self.use_prox, cross_weights=cw)
        ctx.bytes_up += len(ids) * env.model_bytes * self._ratio

        # next round for this tier
        nxt = env.sample_clients(
            env.tm.members[m][alive[env.tm.members[m]]],
            env.sc.clients_per_round, ctx.rng)
        if len(nxt):
            ctx.q.push(sample_round_latency(env.tm, m, nxt, ctx.rng),
                       (m, nxt))
        return Outcome.STEP

    def global_params(self):
        return self.w_global

    def on_eval(self, env: SimEnv, ctx: EngineContext) -> None:
        # track the wire ratio as the weight distribution drifts (sampled)
        self._ratio = self.codec.measure_ratio(self.w_global,
                                               self.ratio_sample_elems)
