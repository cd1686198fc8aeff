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
``repro/core/strategies/fedat.py``, fault plane included (tier blackouts
with the elastic Eq. 3 renormalization, the gated round, crash-resume
snapshots): the rng draws happen in the reference's order.

**Topology mode** (``env.topology``, core/topology.py): the hierarchy
replaces the flat tiers; event = (silo s, per-edge sampled client ids).
Each silo round runs over its E edges (per-edge Eq. 4, Eq. 4 over the
edges), then the silo enters the global Eq. 3 asynchronously with the
same cross weights (silo blackouts renormalize like tier blackouts).
Each link class has its own codec and delay band; per-link wire bytes go
to ``link_bytes`` while the engine Metrics keep the flat client-link
semantics.  A silo trains from the global model it fetched when its round
was dispatched, and ``topology.compensation`` corrects that staleness
before Eq. 3.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.compress import transport
from repro_torch.core import aggregation
from repro_torch.core import faults as faults_mod
from repro_torch.core import topology as topology_mod
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
        self.topo = env.topology
        if self.topo is not None:
            self._bind_topology(env)
            return
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

    def _bind_topology(self, env: SimEnv) -> None:
        """Topology-mode server state: the silo stack plays the tier
        stack's role (``tier_models``/``counts``/``tier_alive`` are
        silo-indexed, so the blackout machinery carries over), plus the
        per-silo dispatch stack, the per-link codec triple with its
        wire-ratio and byte ledgers, and the link-delay rng stream."""
        S = self.topo.n_silos
        self.tier_models = {k: torch.stack([v] * S)
                            for k, v in env.params0.items()}   # silo stack
        # dispatch[s] = the global model silo s last fetched; staleness
        # for the compensation term is measured against it
        self.dispatch = {k: torch.stack([v] * S)
                         for k, v in env.params0.items()}
        self.counts = np.zeros(S, np.int64)
        self.w_global = {k: v.clone() for k, v in env.params0.items()}
        self.tier_alive = np.ones(S, bool)
        # client_edge inherits the strategy's codec (the flat link); the
        # WAN hops default to identity, so the degenerate tree is the flat
        # run bitwise
        self.link_codecs = tuple(
            transport.get_codec(self.topo.cfg.codec_name(link, default))
            for link, default in (("client_edge", self.codec.name),
                                  ("edge_silo", "none"),
                                  ("silo_global", "none")))
        self._link_ratios = {
            link: c.measure_ratio(env.params0, self.ratio_sample_elems)
            for link, c in zip(topology_mod.LINK_CLASSES,
                               self.link_codecs)}
        self._ratio = self._link_ratios["client_edge"]
        #: per-link-class wire bytes (both directions of every hop)
        self.link_bytes = {k: 0.0 for k in topology_mod.LINK_CLASSES}
        self._link_rng = self.topo.new_link_rng()

    def bootstrap(self, env: SimEnv, ctx: EngineContext) -> None:
        if self.topo is not None:
            # every silo starts round 0 at its own pace
            for s in range(self.topo.n_silos):
                self._schedule_silo(env, ctx, s)
            return
        # every tier starts round 0 at its own pace
        for m in range(env.tm.n_tiers):
            ids = env.sample_clients(env.tm.members[m],
                                     env.sc.clients_per_round, ctx.rng)
            ctx.q.push(sample_round_latency(env.tm, m, ids, ctx.rng),
                       (m, ids))

    # -- topology mode ---------------------------------------------------
    def _schedule_silo(self, env: SimEnv, ctx: EngineContext, s: int,
                       alive: Optional[np.ndarray] = None) -> bool:
        """Sample the next round for silo ``s``: per edge, the client
        sample and its compute latency from the engine rng (the flat tier
        round's call pattern, so the degenerate tree consumes the stream
        identically), then the link delays from the topology stream.  The
        silo's wall clock is the slowest edge chain (compute +
        client_edge + edge_silo) plus its skew-scaled silo_global hop.
        Returns False when every edge pool is empty."""
        topo = self.topo
        ids_edges, wall = [], []
        for e in range(topo.edges_per_silo):
            pool = topo.edge_members[s][e]
            if alive is not None:
                pool = pool[alive[pool]]
            ids = env.sample_clients(pool, topo.k_edge, ctx.rng)
            ids_edges.append(ids)
            wall.append(sample_round_latency(env.tm, 0, ids, ctx.rng)
                        if len(ids) else None)
        # fixed per-scheduled-round stream consumption, live or not
        ce_d, es_d, sg_d = topo.draw_delays(self._link_rng, s)
        live = [e for e in range(topo.edges_per_silo)
                if wall[e] is not None]
        if not live:
            return False
        lat = max(wall[e] + ce_d[e] + es_d[e] for e in live) + sg_d
        ctx.q.push(lat, ("silo", s, tuple(ids_edges)))
        return True

    def _refresh_dispatch(self, s: int) -> None:
        """Silo ``s`` re-fetches the current global (the resample and
        blackout-return paths; a committed round refreshes it in the
        executor)."""
        for k, v in self.w_global.items():
            self.dispatch[k][s] = v

    def _on_event_topology(self, env: SimEnv, ctx: EngineContext,
                           now: float, actor) -> Outcome:
        _, s, ids_edges = actor
        if not self.tier_alive[s]:
            # completed into a silo blackout: in-flight work is lost
            return Outcome.DISCARD
        alive = env.alive(now)
        done = env.completion(now)
        live = []
        for ids in ids_edges:
            ids = ids[alive[ids]]      # churned clients never reach
            if done is not None:       # their edge aggregator
                ids = ids[done[ids]]
            live.append(ids)
        n_live = int(sum(len(i) for i in live))
        if n_live == 0:                # whole silo sample dropped
            if self._schedule_silo(env, ctx, s, alive):
                self._refresh_dispatch(s)
            return Outcome.DISCARD
        mb = env.model_bytes
        ce_r = self._link_ratios["client_edge"]
        n_edges_live = sum(1 for i in live if len(i))
        # Metrics keep the flat client-link semantics; the per-class ledger
        # counts both directions of every hop: the live client payloads,
        # one payload per live edge, one per silo round
        ctx.bytes_down += n_live * mb * ce_r
        self.link_bytes["client_edge"] += 2 * n_live * mb * ce_r
        self.link_bytes["edge_silo"] += \
            2 * n_edges_live * mb * self._link_ratios["edge_silo"]
        self.link_bytes["silo_global"] += \
            2 * mb * self._link_ratios["silo_global"]
        self.counts[s] += 1
        cw = self._cross_weights()
        self.w_global, self.tier_models, self.dispatch = \
            ctx.executor.fedat_topology_round(
                self.w_global, self.tier_models, self.dispatch, s, live,
                ctx.draw_seed(), codecs=self.link_codecs,
                use_prox=self.use_prox, cross_weights=cw)
        ctx.bytes_up += n_live * mb * ce_r
        self._schedule_silo(env, ctx, s, alive)
        return Outcome.STEP

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
        if self.topo is not None:
            return self._on_event_topology(env, ctx, now, actor)
        m, ids = actor
        if not self.tier_alive[m]:
            # the round completed into a blackout: the in-flight work is
            # lost with the tier (on_fault reseeds it when it returns)
            return Outcome.DISCARD
        alive = env.alive(now)
        ids = ids[alive[ids]]
        done = env.completion(now)
        if done is not None:
            # population completion process: a sampled, still-alive client
            # can fail to return its update; Eq. 4 renormalizes over the
            # survivors
            ids = ids[done[ids]]
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
        if self.topo is not None:
            self._link_ratios = {
                link: c.measure_ratio(self.w_global,
                                      self.ratio_sample_elems)
                for link, c in zip(topology_mod.LINK_CLASSES,
                                   self.link_codecs)}
            self._ratio = self._link_ratios["client_edge"]
            return
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
        event loop.  Under the topology plane the units are silos."""
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
        if self.topo is not None:
            # the returning silo re-fetches the global it bootstrapped
            # from, then rejoins the event loop
            self._refresh_dispatch(m)
            self._schedule_silo(env, ctx, m, alive)
            return Outcome.DISCARD
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
        if self.topo is not None:
            dev["dispatch"] = {k: v.clone() for k, v in self.dispatch.items()}
            host["link_rng"] = self._link_rng.bit_generator.state
            host["link_bytes"] = dict(self.link_bytes)
            host["link_ratios"] = dict(self._link_ratios)
        return dev, host

    def restore(self, dev, host) -> None:
        self.w_global = dev["w_global"]
        self.tier_models = dev["tier_models"]
        self.counts = np.asarray(host["counts"], np.int64)
        self._ratio = host["ratio"]
        self.tier_alive = np.asarray(host["tier_alive"], bool)
        if self.topo is not None:
            self.dispatch = dev["dispatch"]
            self._link_rng = self.topo.new_link_rng()
            self._link_rng.bit_generator.state = host["link_rng"]
            self.link_bytes = dict(host["link_bytes"])
            self._link_ratios = dict(host["link_ratios"])
