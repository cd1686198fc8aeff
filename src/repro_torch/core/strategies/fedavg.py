"""FedAvg as an engine strategy: synchronous global rounds — sample K
clients globally, wait for the slowest (paper §6.1).

The paper's baseline runs raw f32 links (``codec=None``, the default); a
transport codec compresses both links exactly like the FedAT round.  A
round is scheduled while handling the previous round's completion event,
so the engine's queue always holds exactly one round event.  Under the
fault plane's gate the round runs gated (poisoned uplinks zero-weighted,
deltas clipped); blackout markers are ignored, as in the reference.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np

from repro_torch.compress import transport
from repro_torch.core.engine import (EngineConfig, EngineContext, Outcome,
                                     ServerStrategy)
from repro_torch.core.simulation import SimEnv
from repro_torch.core.tiering import sample_round_latency


class FedAvgStrategy(ServerStrategy):
    name = "fedavg"
    seed_offset = 29
    #: an empty draw ends the run — TiFL overrides this to burn the round
    reschedule_on_empty = False

    def __init__(self, codec: Union[str, transport.Codec, None] = None,
                 ratio_sample_elems: Optional[int]
                 = transport.RATIO_SAMPLE_ELEMS):
        self.codec = None if codec is None else transport.get_codec(codec)
        self.ratio_sample_elems = ratio_sample_elems

    def bind(self, env: SimEnv, cfg: EngineConfig) -> None:
        self.w = {k: v.clone() for k, v in env.params0.items()}
        self._ratio = (1.0 if self.codec is None else
                       self.codec.measure_ratio(env.params0,
                                                self.ratio_sample_elems))

    def bootstrap(self, env: SimEnv, ctx: EngineContext) -> None:
        self._schedule(env, ctx)

    def _sample(self, env, ctx):
        """(tier index, client ids) for the next round; -1 = global pool."""
        alive = env.alive(ctx.q.now)
        pool = np.arange(env.sc.n_clients)[alive]
        return -1, env.sample_clients(pool, env.sc.clients_per_round, ctx.rng)

    def _schedule(self, env: SimEnv, ctx: EngineContext) -> None:
        m, ids = self._sample(env, ctx)
        if len(ids) == 0:
            if self.reschedule_on_empty:  # zero-latency budget-burn marker
                ctx.q.push(0.0, (m, ids))
            return  # else: queue drains and the run ends
        ctx.q.push(sample_round_latency(env.tm, m, ids, ctx.rng), (m, ids))

    def on_event(self, env: SimEnv, ctx: EngineContext, now: float,
                 actor) -> Outcome:
        m, ids = actor
        if len(ids) == 0:
            self._schedule(env, ctx)
            return Outcome.SKIP_ROUND
        done = env.completion(now)
        if done is not None:
            # population completion process: drop the sampled clients that
            # fail to report back; Eq. 4 renormalizes over the survivors
            ids = ids[done[ids]]
            if len(ids) == 0:
                self._schedule(env, ctx)
                return Outcome.SKIP_ROUND
        ctx.bytes_down += len(ids) * env.model_bytes * self._ratio
        gate = None if ctx.faults is None else ctx.faults.gate
        if gate is None:
            self.w = ctx.executor.fedavg_round(self.w, ids, ctx.draw_seed(),
                                               codec=self.codec)
        else:
            poison = ctx.faults.draw_poison(len(ids), ctx.executor.K)
            self.w = ctx.executor.fedavg_round(self.w, ids, ctx.draw_seed(),
                                               codec=self.codec, gate=gate,
                                               poison=poison)
        ctx.bytes_up += len(ids) * env.model_bytes * self._ratio
        self._schedule(env, ctx)
        return Outcome.STEP

    def global_params(self):
        return self.w

    def on_eval(self, env: SimEnv, ctx: EngineContext) -> None:
        if self.codec is not None:  # track the drifting wire ratio, sampled
            self._ratio = self.codec.measure_ratio(self.w,
                                                   self.ratio_sample_elems)

    # -- crash-resume ---------------------------------------------------
    def snapshot(self):
        return ({"w": {k: v.clone() for k, v in self.w.items()}},
                {"ratio": self._ratio})

    def restore(self, dev, host) -> None:
        self.w = dev["w"]
        self._ratio = host["ratio"]
