"""FedAsync as an engine strategy: fully asynchronous — every client
updates the server model independently with polynomial staleness weighting
(Xie et al. 2019).

Event = (client id, server version at dispatch).  A dead client's event is
discarded without rescheduling (its dropout is permanent).
"""
from __future__ import annotations

from typing import Optional, Union

from repro_torch.compress import transport
from repro_torch.core.engine import (EngineConfig, EngineContext, Outcome,
                                     ServerStrategy)
from repro_torch.core.simulation import SimEnv


class FedAsyncStrategy(ServerStrategy):
    name = "fedasync"
    seed_offset = 37

    def __init__(self, alpha: float = 0.6, staleness_exp: float = 0.5,
                 codec: Union[str, transport.Codec, None] = None,
                 ratio_sample_elems: Optional[int]
                 = transport.RATIO_SAMPLE_ELEMS):
        self.alpha = alpha
        self.staleness_exp = staleness_exp
        self.codec = None if codec is None else transport.get_codec(codec)
        self.ratio_sample_elems = ratio_sample_elems

    def bind(self, env: SimEnv, cfg: EngineConfig) -> None:
        self.w = {k: v.clone() for k, v in env.params0.items()}
        self.server_version = 0
        self._ratio = (1.0 if self.codec is None else
                       self.codec.measure_ratio(env.params0,
                                                self.ratio_sample_elems))

    def bootstrap(self, env: SimEnv, ctx: EngineContext) -> None:
        # every client trains continuously at its own pace
        for c in range(env.sc.n_clients):
            ctx.q.push(float(env.tm.latencies[c]), (int(c), 0))

    def on_event(self, env: SimEnv, ctx: EngineContext, now: float,
                 actor) -> Outcome:
        c, start_version = actor
        if not env.alive(now)[c]:
            return Outcome.DISCARD
        done = env.completion(now)
        if done is not None and not done[c]:
            # population completion process: the client is up but failed to
            # finish this update — retry at its own pace, same version
            ctx.q.push(
                float(env.tm.latencies[c]) * (1 + ctx.rng.uniform(0, 0.1)),
                (c, start_version))
            return Outcome.DISCARD
        ctx.bytes_down += env.model_bytes * self._ratio
        staleness = self.server_version - start_version
        a_eff = self.alpha * (1.0 + staleness) ** (-self.staleness_exp)
        self.w = ctx.executor.fedasync_round(self.w, c, a_eff,
                                             ctx.draw_seed(),
                                             codec=self.codec)
        ctx.bytes_up += env.model_bytes * self._ratio
        self.server_version += 1
        ctx.q.push(float(env.tm.latencies[c]) * (1 + ctx.rng.uniform(0, 0.1)),
                   (c, self.server_version))
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
                {"version": self.server_version, "ratio": self._ratio})

    def restore(self, dev, host) -> None:
        self.w = dev["w"]
        self.server_version = int(host["version"])
        self._ratio = host["ratio"]
