"""Fault tolerance: guarded step execution, straggler detection, retries.

The port of ``repro/runtime/fault.py`` (the same logic; ``sleep`` and
``clock`` injectable).  A failed step is counted in ``stats["failures"]``
and logged before it is retried from the last checkpoint, so a kernel
fault on the card is never silent: a run that injects no failure must
end with ``failures == 0`` (chip_smoke.py checks it).

At thousands of nodes, *something* is always failing.  The runtime wraps the
train step with:

  * checkpoint/restart — on step failure the state is restored from the
    last good checkpoint and training resumes (bounded retries, exponential
    backoff between attempts);
  * straggler detection — an EWMA of step latency; steps slower than
    ``threshold x`` the running median are flagged, and the per-worker
    slow-counts feed the FedAT tiering module (pods that persistently lag
    get re-tiered instead of stalling the sync group: the paper's insight
    applied at datacenter scale);
  * simulated failure injection for tests (``inject_failure_rate``).

This wrapper guards the *datacenter trainer* loop (launch/train.py).  The
simulation engine's fault story (core/faults.py) is another thing:
there,
faults are spec-driven and deterministic (churn windows, tier blackouts,
poisoned uplinks, bitwise crash-resume), because the engine's contract is
a reproducible trajectory — retry/backoff wall-clock machinery like this
has no place inside it.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.checkpoint.ckpt import CheckpointManager

log = logging.getLogger("repro_torch.fault")


@dataclasses.dataclass
class StragglerStats:
    window: int = 64
    threshold: float = 2.0
    times: List[float] = dataclasses.field(default_factory=list)
    flags: int = 0

    def observe(self, dt: float) -> bool:
        """Record a step latency; returns True if it's a straggler step."""
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        med = float(np.median(self.times))
        slow = len(self.times) >= 8 and dt > self.threshold * med
        if slow:
            self.flags += 1
        return slow

    @property
    def median(self) -> float:
        return float(np.median(self.times)) if self.times else 0.0


class GuardedRunner:
    """Run (state, batch) -> (state, metrics) steps with restart-on-failure."""

    def __init__(self, step_fn: Callable, ckpt: CheckpointManager,
                 ckpt_every: int = 50, max_retries: int = 3,
                 inject_failure_rate: float = 0.0, seed: int = 0,
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.perf_counter):
        """``sleep``/``clock`` are injectable so tests can drive the
        backoff and straggler timing deterministically without real
        wall-clock waits."""
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.max_retries = max_retries
        self.inject = inject_failure_rate
        self.rng = np.random.default_rng(seed)
        self._sleep = sleep
        self._clock = clock
        self.straggler = StragglerStats()
        self.stats: Dict[str, int] = {"failures": 0, "restores": 0,
                                      "steps": 0, "straggler_steps": 0}

    def run(self, state: Any, batches, n_steps: int, start_step: int = 0,
            on_metrics: Optional[Callable] = None) -> Any:
        step = start_step
        it = iter(batches)
        while step < n_steps:
            batch = next(it)
            retries = 0
            while True:
                try:
                    if self.inject and self.rng.random() < self.inject:
                        raise RuntimeError("injected node failure")
                    t0 = self._clock()
                    state, metrics = self.step_fn(state, batch)
                    dt = self._clock() - t0
                    if self.straggler.observe(dt):
                        self.stats["straggler_steps"] += 1
                        log.warning("straggler step %d: %.3fs (median %.3fs)",
                                    step, dt, self.straggler.median)
                    break
                except Exception as e:  # noqa: BLE001 — node-failure path
                    self.stats["failures"] += 1
                    retries += 1
                    if retries > self.max_retries:
                        raise
                    log.warning("step %d failed (%s); restoring (retry %d)",
                                step, e, retries)
                    self._sleep(min(0.05 * 2 ** retries, 1.0))
                    try:
                        state, restored = self.ckpt.restore(state)
                        step = restored
                        self.stats["restores"] += 1
                    except FileNotFoundError:
                        pass  # no checkpoint yet: retry from current state
            step += 1
            self.stats["steps"] += 1
            if on_metrics:
                on_metrics(step, metrics)
            if step % self.ckpt_every == 0:
                self.ckpt.save(step, state)
        self.ckpt.save(step, state, blocking=True)
        return state, step
