"""Deterministic fault plane: spec-driven fault injection for the engine.

The port of ``repro/core/faults.py`` (numpy only, kept as a copy: the
draws are bitwise the reference's).  FedAT's premise is that at scale
*something is always slow or gone*; the fault plane makes that a
first-class, reproducible part of a scenario.  The spec's ``faults``
section (:class:`repro_torch.api.spec.FaultSpec`) drives four fault
families:

  * **transient client churn** — per-client availability *windows* (down
    intervals) layered on top of the permanent dropout schedule; a client
    sampled while up can be down by the time its round completes, which
    shrinks the participant set so Eq. 4 renormalizes over the survivors
    inside the same fixed-shape round (the executor's padding contract);
  * **tier blackouts** — a whole tier disappears for an interval; the
    FedAT strategy renormalizes Eq. 3 over the surviving M' tiers
    (runtime/elastic.py) and the returning tier bootstraps from the
    global model;
  * **poisoned uplinks** — a client's decoded update is replaced with
    NaN; the server-side validation gate (core/steps.py) zero-weights it
    and renormalizes, so one bad client degrades a round instead of
    sinking the global model;
  * **crash-resume** — ``run_engine`` checkpoints full engine state every
    N committed updates (core/engine.py) so a killed run resumes to a
    bitwise-identical metrics trajectory.

RNG stream contract: every fault draw comes from a *dedicated*
spec-seeded stream (seeded ``[faults.seed, <stream tag>]``), never from
the engine's event-order rng or the environment's materialization rng.
A zero-fault spec therefore stays bitwise identical to the fault-plane-
free engine: ``alive()`` reduces to the permanent-dropout compare, no
marker events enter the queue, and the ungated round bodies run
unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np

#: rng stream tags (seed-sequence entropy appended to ``faults.seed``) —
#: churn windows and event-time draws are independent streams so adding
#: blackout/poison knobs never reshuffles the churn schedule
CHURN_STREAM = 0xC4312
EVENT_STREAM = 0xFA417

#: queue-actor tags for fault marker events (engine routes these to
#: ``ServerStrategy.on_fault`` instead of ``on_event``)
BLACKOUT = "fault_blackout"
RETURN = "fault_return"
_FAULT_KINDS = (BLACKOUT, RETURN)


def is_fault_event(actor: Any) -> bool:
    """True for fault-plane marker actors (pushed by :meth:`FaultPlane.
    schedule` / the strategy's blackout handling)."""
    return (isinstance(actor, tuple) and len(actor) > 0
            and actor[0] in _FAULT_KINDS)


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Engine-plane fault knobs (the churn knobs live on
    :class:`~repro_torch.core.simulation.SimConfig` — availability windows are
    part of the materialized environment).  Mirrors the strategy/engine
    subset of :class:`repro_torch.api.spec.FaultSpec`."""
    blackouts: int = 0
    blackout_duration: float = 60.0
    blackout_window: Tuple[float, float] = (50.0, 400.0)
    nan_rate: float = 0.0
    update_clip: float = 0.0
    checkpoint_every: int = 0
    seed: int = 0

    @property
    def injects_faults(self) -> bool:
        """Any knob that perturbs the trajectory (needs a FaultPlane)."""
        return (self.blackouts > 0 or self.nan_rate > 0
                or self.update_clip > 0)

    @property
    def active(self) -> bool:
        """Anything at all for the engine to do (faults or checkpoints)."""
        return self.injects_faults or self.checkpoint_every > 0


class FaultPlane:
    """Per-run fault state: the dedicated event-draw rng stream, the
    blackout schedule (drawn up front, so it is a pure function of the
    spec), and the uplink-poison draws.  Held on
    :class:`~repro_torch.core.engine.EngineContext` as ``ctx.faults`` (None for
    zero-fault runs) and snapshotted/restored for crash-resume."""

    def __init__(self, cfg: FaultConfig, n_tiers: int):
        self.cfg = cfg
        self.rng = np.random.default_rng([int(cfg.seed), EVENT_STREAM])
        #: (start, end, tier) blackout intervals, start-sorted
        self.blackout_events = []
        for _ in range(cfg.blackouts):
            m = int(self.rng.integers(n_tiers))
            t0 = float(self.rng.uniform(*cfg.blackout_window))
            self.blackout_events.append(
                (t0, t0 + float(cfg.blackout_duration), m))
        self.blackout_events.sort()
        self._gate = None

    # ------------------------------------------------------------------
    def schedule(self, q) -> None:
        """Push the blackout-start markers at bootstrap (queue ``now`` is
        0, so the drawn start times are absolute).  Strategies that model
        tiers (FedAT) handle the markers in ``on_fault``; others inherit
        the ignore default."""
        for t0, t1, m in self.blackout_events:
            q.push(t0, (BLACKOUT, m, t1))

    @property
    def gate(self):
        """The server-side update validation gate config
        (:class:`~repro_torch.core.steps.UpdateGate`), or None when neither
        poison injection nor norm clipping is spec'd — the ungated
        round bodies then run unchanged."""
        if self.cfg.nan_rate <= 0 and self.cfg.update_clip <= 0:
            return None
        if self._gate is None:
            from repro_torch.core.steps import UpdateGate
            self._gate = UpdateGate(clip_norm=float(self.cfg.update_clip))
        return self._gate

    def draw_poison(self, n_live: int, k: int) -> np.ndarray:
        """(k,) bool mask: with probability ``nan_rate`` one of the
        ``n_live`` leading (live) slots is poisoned this round.  Exactly
        one ``rng.random()`` per gated training event (plus one
        ``integers`` when triggered) keeps the stream replayable."""
        mask = np.zeros(k, bool)
        if self.cfg.nan_rate <= 0:
            return mask
        if n_live > 0 and self.rng.random() < self.cfg.nan_rate:
            mask[int(self.rng.integers(n_live))] = True
        return mask

    # -- crash-resume ---------------------------------------------------
    def state(self) -> dict:
        """Serializable stream position (the blackout schedule is a pure
        function of the config, so only the event-draw rng needs saving)."""
        return {"rng": self.rng.bit_generator.state}

    def set_state(self, state: dict) -> None:
        self.rng.bit_generator.state = state["rng"]


def churn_schedule(n_clients: int, rate: float, events: int,
                   downtime: float, window: Tuple[float, float],
                   seed: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Transient-availability windows: each client is a churner with
    probability ``rate``; a churner gets ``events`` down intervals whose
    onsets are uniform in ``window`` and whose durations are exponential
    with mean ``downtime``.

    Returns ``(starts, ends)`` of shape (n_clients, events) with +inf
    rows for non-churners, or None when churn is off — the off case lets
    :meth:`SimEnv.alive` keep the exact pre-fault-plane expression
    (bitwise zero-fault parity).  Draws come from the dedicated
    ``[seed, CHURN_STREAM]`` stream, never the environment rng.
    """
    if rate <= 0 or events <= 0:
        return None
    rng = np.random.default_rng([int(seed), CHURN_STREAM])
    churner = rng.random(n_clients) < rate
    starts = np.full((n_clients, events), np.inf)
    ends = np.full((n_clients, events), np.inf)
    lo, hi = window
    for i in np.flatnonzero(churner):
        s = np.sort(rng.uniform(lo, hi, events))
        starts[i] = s
        ends[i] = s + rng.exponential(downtime, events)
    return starts, ends
