"""Unified event-driven FL engine (the single loop behind every method).

The port of ``repro/core/engine.py`` in flat mode: the same loop

    pop event -> (dropout filter / sampling) -> downlink -> local train
    -> uplink -> aggregate -> reschedule -> periodic eval,

with byte accounting along the two links, and the same rng discipline: a
strategy declares ``seed_offset`` and draws exclusively from ``ctx.rng``
in event order, so a (strategy, SimEnv, EngineConfig) tuple determines the
event trace exactly as in the reference.  The fault plane and
checkpoint/resume are not ported yet (ROADMAP A12).
"""
from __future__ import annotations

import abc
import dataclasses
import enum
from typing import Any, Optional

import numpy as np

from repro_torch.core.scheduler import EventQueue, Metrics
from repro_torch.core.simulation import SimEnv


@dataclasses.dataclass
class EngineConfig:
    """Knobs shared by every method; strategy-specific knobs live on the
    strategy object (see core/strategies/)."""
    total_updates: int = 200   # T: global update budget
    eval_every: int = 10
    seed: int = 0
    #: re-profile latencies + rebuild the tier map every N global updates
    retier_every: int = 0
    retier_drift: float = 0.2


class Outcome(enum.Enum):
    """What a handled event did to the global round counter ``t``.

    STEP        committed one global update: t += 1, eval cadence applies.
    SKIP_ROUND  consumed a round of budget without an update: t += 1, no
                eval.
    DISCARD     the event produced nothing: t unchanged.
    """
    STEP = "step"
    SKIP_ROUND = "skip_round"
    DISCARD = "discard"


@dataclasses.dataclass
class EngineContext:
    """Mutable per-run state handed to every strategy hook.

    ``draw_seed`` is the one host rng draw per training event; its position
    in event order is the parity contract with the reference.
    """
    q: EventQueue
    rng: np.random.Generator
    metrics: Metrics
    cfg: EngineConfig
    executor: Any = None
    bytes_up: float = 0.0
    bytes_down: float = 0.0
    t_global: int = 0

    def draw_seed(self) -> int:
        """The per-event PRNG seed draw (exactly one ``rng.integers``)."""
        return int(self.rng.integers(2 ** 31))


class ServerStrategy(abc.ABC):
    """Server policy plugged into :func:`run_engine`.

    Lifecycle: ``bind`` -> ``bootstrap`` -> ``on_event`` per popped event
    -> ``on_eval`` after each periodic evaluation.
    """

    name: str = "strategy"
    seed_offset: int = 0

    def bind(self, env: SimEnv, cfg: EngineConfig) -> None:
        """Allocate server-side state (models, counters) for a fresh run."""

    @abc.abstractmethod
    def bootstrap(self, env: SimEnv, ctx: EngineContext) -> None:
        """Push the initial event(s) onto ``ctx.q``."""

    @abc.abstractmethod
    def on_event(self, env: SimEnv, ctx: EngineContext, now: float,
                 actor: Any) -> Outcome:
        """Handle one completion event; return what it did to ``t``."""

    @abc.abstractmethod
    def global_params(self) -> Any:
        """The model the server would deploy right now (eval target)."""

    def on_eval(self, env: SimEnv, ctx: EngineContext) -> None:
        """Hook after each periodic eval (e.g. re-measure the wire ratio)."""


def run_engine(env: SimEnv, strategy: ServerStrategy, cfg: EngineConfig,
               on_record=None) -> Metrics:
    """The one event loop: timestamp-ordered server reactions, a global
    update budget, and the shared eval cadence.  ``on_record(point)``
    streams each recorded eval point to the caller."""
    ctx = EngineContext(
        q=EventQueue(),
        rng=np.random.default_rng(cfg.seed + strategy.seed_offset),
        metrics=Metrics(), cfg=cfg, executor=env.executor())
    strategy.bind(env, cfg)
    tm0 = env.tm if cfg.retier_every else None
    strategy.bootstrap(env, ctx)
    try:
        while ctx.t_global < cfg.total_updates and len(ctx.q):
            now, actor = ctx.q.pop()
            out = strategy.on_event(env, ctx, now, actor)
            if out is Outcome.DISCARD:
                continue
            ctx.t_global += 1
            if (out is not Outcome.SKIP_ROUND
                    and (ctx.t_global % cfg.eval_every == 0
                         or ctx.t_global == cfg.total_updates)):
                acc, var = env.evaluate(strategy.global_params())
                strategy.on_eval(env, ctx)
                ctx.metrics.record(now, ctx.t_global, acc, var,
                                   ctx.bytes_up, ctx.bytes_down)
                if on_record is not None:
                    on_record({"time": now, "round": ctx.t_global,
                               "acc": acc, "acc_var": var,
                               "bytes_up": ctx.bytes_up,
                               "bytes_down": ctx.bytes_down})
            if cfg.retier_every and ctx.t_global % cfg.retier_every == 0:
                env.retier(ctx.rng, cfg.retier_drift)
    finally:
        if tm0 is not None:
            env.tm = tm0
    return ctx.metrics


def run_strategy(env: SimEnv, name: str, cfg: Optional[EngineConfig] = None,
                 **strategy_kwargs) -> Metrics:
    """Convenience: look up a registered strategy by name and run it."""
    from repro_torch.core import strategies
    return run_engine(env, strategies.make_strategy(name, **strategy_kwargs),
                      cfg or EngineConfig())
