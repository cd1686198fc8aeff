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
``repro/core/strategies/fedat.py`` in flat mode, fault plane included
(tier blackouts with the elastic Eq. 3 renormalization, the gated round,
crash-resume snapshots): the rng draws happen in the reference's order.
The topology mode waits for ROADMAP A14.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.compress import transport
from repro_torch.core import aggregation
from repro_torch.core import faults as faults_mod
from repro_torch.core.engine import (EngineConfig, EngineContext, Outcome,
                                     ServerStrategy)
from repro_torch.core.simulation import SimEnv
from repro_torch.core.tiering import sample_round_latency
from repro_torch.runtime import elastic


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
        #: per-tier availability under the fault plane's blackouts; all-
        #: True keeps the zero-fault Eq. 3 path unchanged (the masked
        #: renormalization only runs while some tier is dark)
        self.tier_alive = np.ones(M, bool)

    def bootstrap(self, env: SimEnv, ctx: EngineContext) -> None:
        # every tier starts round 0 at its own pace
        for m in range(env.tm.n_tiers):
            ids = env.sample_clients(env.tm.members[m],
                                     env.sc.clients_per_round, ctx.rng)
            ctx.q.push(sample_round_latency(env.tm, m, ids, ctx.rng),
                       (m, ids))

    def _cross_weights(self) -> np.ndarray:
        if not self.tier_alive.all():
            # blackout in progress elsewhere: Eq. 3 renormalizes over the
            # surviving tiers (runtime/elastic.py) — dark tiers get weight
            # exactly 0 whether weighted or uniform
            if self.weighted:
                return elastic.masked_cross_weights(self.counts,
                                                    self.tier_alive)
            return (self.tier_alive.astype(np.float32)
                    / self.tier_alive.sum())
        if self.weighted:
            return aggregation.cross_tier_weights_host(self.counts)
        return aggregation.uniform_weights_host(len(self.counts))

    def on_event(self, env: SimEnv, ctx: EngineContext, now: float,
                 actor) -> Outcome:
        m, ids = actor
        if not self.tier_alive[m]:
            # the round completed into a blackout: the in-flight work is
            # lost with the tier (on_fault reseeds it when it returns)
            return Outcome.DISCARD
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
        gate = None if ctx.faults is None else ctx.faults.gate
        if gate is None:
            self.w_global, self.tier_models = ctx.executor.fedat_round(
                self.w_global, self.tier_models, m, ids, ctx.draw_seed(),
                codec=self.codec, use_prox=self.use_prox, cross_weights=cw)
        else:
            poison = ctx.faults.draw_poison(len(ids), ctx.executor.K)
            self.w_global, self.tier_models = ctx.executor.fedat_round(
                self.w_global, self.tier_models, m, ids, ctx.draw_seed(),
                codec=self.codec, use_prox=self.use_prox, cross_weights=cw,
                gate=gate, poison=poison)
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

    # -- fault plane ----------------------------------------------------
    def on_fault(self, env: SimEnv, ctx: EngineContext, now: float,
                 actor) -> Outcome:
        """Tier blackout lifecycle.  Start marker: mark the tier dark and
        schedule its return; rounds completing into the blackout are
        discarded (on_event) and Eq. 3 renormalizes over the survivors.
        Return marker: the tier bootstraps from the current global model
        (runtime/elastic.py), restarts its update count, and rejoins the
        event loop."""
        if actor[0] == faults_mod.BLACKOUT:
            _, m, t_end = actor
            self.tier_alive[m] = False
            ctx.q.push(t_end - now, (faults_mod.RETURN, m))
            return Outcome.DISCARD
        m = actor[1]
        self.tier_alive[m] = True
        self.tier_models = elastic.bootstrap_tier(
            self.tier_models, self.w_global, m)
        self.counts[m] = 0
        alive = env.alive(now)
        ids = env.sample_clients(
            env.tm.members[m][alive[env.tm.members[m]]],
            env.sc.clients_per_round, ctx.rng)
        if len(ids):
            ctx.q.push(sample_round_latency(env.tm, m, ids, ctx.rng),
                       (m, ids))
        return Outcome.DISCARD

    # -- crash-resume ---------------------------------------------------
    def snapshot(self):
        dev = {"w_global": {k: v.clone() for k, v in self.w_global.items()},
               "tier_models": {k: v.clone()
                               for k, v in self.tier_models.items()}}
        host = {"counts": self.counts.copy(), "ratio": self._ratio,
                "tier_alive": self.tier_alive.copy()}
        return dev, host

    def restore(self, dev, host) -> None:
        self.w_global = dev["w_global"]
        self.tier_models = dev["tier_models"]
        self.counts = np.asarray(host["counts"], np.int64)
        self._ratio = host["ratio"]
        self.tier_alive = np.asarray(host["tier_alive"], bool)
