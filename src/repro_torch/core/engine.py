"""Unified event-driven FL engine (the single loop behind every method).

The port of ``repro/core/engine.py`` in flat mode: the same loop

    pop event -> (dropout filter / sampling) -> downlink -> local train
    -> uplink -> aggregate -> reschedule -> periodic eval,

with byte accounting along the two links, and the same rng discipline: a
strategy declares ``seed_offset`` and draws exclusively from ``ctx.rng``
in event order, so a (strategy, SimEnv, EngineConfig) tuple determines the
event trace exactly as in the reference.

Fault plane (``EngineConfig.faults``, core/faults.py): blackout markers
are scheduled at bootstrap and routed to ``ServerStrategy.on_fault``; the
strategies read the gate config and poison draws off ``ctx.faults``.
Crash-resume: with a checkpoint directory and ``faults.checkpoint_every >
0`` the full engine state (strategy tensors, event queue, rng streams,
metrics, byte counters, tier map) is checkpointed every N committed
updates through checkpoint/ckpt.py, and ``resume=True`` replays the rest
of a killed run bitwise.

Spans (spans.py): ``engine.event`` around each pop and the strategy's
reaction to it (the root of a request), ``engine.eval`` around each
periodic evaluation (``eval.accuracy`` inside, core/simulation.py) and its
record.

On a mesh of several ranks every rank runs this loop with the same draws,
so the metrics are equal on every rank; every rank takes the snapshots
(a tier stack laid over ``pod`` is gathered whole), only rank 0 writes
them (``launch/mesh.py`` ``is_writer``), and a resume reads the same
snapshot on every rank.
"""
from __future__ import annotations

import abc
import dataclasses
import enum
import pickle
from typing import Any, Optional

import numpy as np

from repro_torch import spans
from repro_torch.core import faults as faults_mod
from repro_torch.core import tiering
from repro_torch.core.scheduler import EventQueue, Metrics
from repro_torch.core.simulation import SimEnv
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.common import flatten_tree, unflatten_tree


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
    #: engine-plane fault knobs (core/faults.py FaultConfig): tier
    #: blackouts, uplink poisoning / the validation gate, and the
    #: crash-resume checkpoint cadence.  None keeps the loop exactly the
    #: zero-fault engine.
    faults: Optional[faults_mod.FaultConfig] = None


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
    #: the run's FaultPlane (core/faults.py), or None for zero-fault runs
    faults: Any = None

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

    def on_fault(self, env: SimEnv, ctx: EngineContext, now: float,
                 actor: Any) -> Outcome:
        """Handle a fault-plane marker event (the loop routes them here
        instead of ``on_event``).  Default: ignore — strategies without a
        tier model treat a blackout as a no-op."""
        return Outcome.DISCARD

    # -- crash-resume ---------------------------------------------------
    def snapshot(self):
        """(tensor dict, host state) capturing all server state, tensors
        copied (the executor writes server state in place).  Bitwise
        resume requires *everything* the strategy mutates to be here."""
        raise NotImplementedError(
            f"strategy {self.name!r} does not implement engine crash-resume")

    def restore(self, dev, host) -> None:
        """Apply a :meth:`snapshot` onto a freshly bound strategy."""
        raise NotImplementedError(
            f"strategy {self.name!r} does not implement engine crash-resume")


def _engine_snapshot(ctx: EngineContext, strategy: ServerStrategy,
                     env: SimEnv) -> dict:
    """Everything a resumed run needs to replay bitwise: the strategy's
    tensors and host state, the event queue, the engine rng stream
    position, metrics so far, byte counters, the fault-plane stream, and
    the (possibly re-tiered) tier map.  The tensors go through the
    CheckpointManager nested like the reference's trees (so both
    packages' manifests name the same paths); the host side rides along
    as one pickled uint8 leaf."""
    dev, host = strategy.snapshot()
    blob = pickle.dumps({
        "t_global": ctx.t_global,
        "bytes_up": ctx.bytes_up,
        "bytes_down": ctx.bytes_down,
        "metrics": dataclasses.asdict(ctx.metrics),
        "queue": ctx.q.state(),
        "rng": ctx.rng.bit_generator.state,
        "faults": None if ctx.faults is None else ctx.faults.state(),
        "strategy": host,
        "tm": (env.tm.tier_of, list(env.tm.members), env.tm.latencies),
    })
    return {"dev": {k: unflatten_tree(v) for k, v in dev.items()},
            "host": np.frombuffer(blob, np.uint8)}


def _apply_engine_snapshot(snap: dict, ctx: EngineContext,
                           strategy: ServerStrategy, env: SimEnv) -> None:
    host = pickle.loads(np.asarray(snap["host"]).tobytes())
    ctx.t_global = int(host["t_global"])
    ctx.bytes_up = float(host["bytes_up"])
    ctx.bytes_down = float(host["bytes_down"])
    ctx.metrics = Metrics(**host["metrics"])
    ctx.q.set_state(host["queue"])
    ctx.rng.bit_generator.state = host["rng"]
    if ctx.faults is not None and host["faults"] is not None:
        ctx.faults.set_state(host["faults"])
    if ctx.cfg.retier_every:  # the map can only have drifted when retiering
        tier_of, members, lat = host["tm"]
        env.tm = tiering.TierMap(tier_of=tier_of, members=list(members),
                                 latencies=lat)
    # the restore placed each tensor on the run's device in its saved dtype
    strategy.restore({k: flatten_tree(v) for k, v in snap["dev"].items()},
                     host["strategy"])


def run_engine(env: SimEnv, strategy: ServerStrategy, cfg: EngineConfig,
               on_record=None, checkpoint_dir: Optional[str] = None,
               resume: bool = False) -> Metrics:
    """The one event loop: timestamp-ordered server reactions, a global
    update budget, and the shared eval cadence.  ``on_record(point)``
    streams each recorded eval point to the caller.

    Fault plane (``cfg.faults``): blackout markers are scheduled at
    bootstrap and routed to ``strategy.on_fault``; with
    ``checkpoint_dir`` and ``faults.checkpoint_every > 0`` the full engine
    state is checkpointed every N committed updates (keeping 2), and
    ``resume=True`` restores the newest complete snapshot (a fresh start
    when none exists) — the resumed run replays to a bitwise-identical
    metrics trajectory."""
    ctx = EngineContext(
        q=EventQueue(),
        rng=np.random.default_rng(cfg.seed + strategy.seed_offset),
        metrics=Metrics(), cfg=cfg, executor=env.executor())
    if cfg.faults is not None and cfg.faults.injects_faults:
        # blackouts strike the strategy's cross-aggregation units: flat
        # tiers, or silos under the topology plane
        topo = env.topology
        n_units = topo.n_silos if topo is not None else env.tm.n_tiers
        ctx.faults = faults_mod.FaultPlane(cfg.faults, n_units)
    strategy.bind(env, cfg)

    every = cfg.faults.checkpoint_every if cfg.faults is not None else 0
    mgr = None
    if checkpoint_dir is not None and every > 0:
        from repro_torch.checkpoint import CheckpointManager
        mgr = CheckpointManager(checkpoint_dir, keep=2)

    tm0 = env.tm if cfg.retier_every else None
    resumed = False
    if mgr is not None and resume:
        try:
            snap, _ = mgr.restore(like=_engine_snapshot(ctx, strategy, env))
            _apply_engine_snapshot(snap, ctx, strategy, env)
            resumed = True
        except FileNotFoundError:
            pass  # no snapshot yet (killed before the first save)
    if not resumed:
        strategy.bootstrap(env, ctx)
        if ctx.faults is not None:
            ctx.faults.schedule(ctx.q)
    try:
        while ctx.t_global < cfg.total_updates and len(ctx.q):
            with spans.span("engine.event"):
                now, actor = ctx.q.pop()
                if (ctx.faults is not None
                        and faults_mod.is_fault_event(actor)):
                    out = strategy.on_fault(env, ctx, now, actor)
                else:
                    out = strategy.on_event(env, ctx, now, actor)
            if out is Outcome.DISCARD:
                continue
            ctx.t_global += 1
            if (out is not Outcome.SKIP_ROUND
                    and (ctx.t_global % cfg.eval_every == 0
                         or ctx.t_global == cfg.total_updates)):
                with spans.span("engine.eval"):
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
            if mgr is not None and ctx.t_global % every == 0:
                # every rank snapshots (a tier stack laid over pod is
                # gathered, a collective); the writer saves
                snap = _engine_snapshot(ctx, strategy, env)
                if mesh_mod.is_writer():
                    mgr.save(ctx.t_global, snap)
    finally:
        if mgr is not None:
            mgr.wait()
        if tm0 is not None:
            env.tm = tm0
    return ctx.metrics


def run_strategy(env: SimEnv, name: str, cfg: Optional[EngineConfig] = None,
                 **strategy_kwargs) -> Metrics:
    """Convenience: look up a registered strategy by name and run it."""
    from repro_torch.core import strategies
    return run_engine(env, strategies.make_strategy(name, **strategy_kwargs),
                      cfg or EngineConfig())
