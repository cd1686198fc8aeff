"""Discrete-event scheduler driving the asynchronous FL simulation.

True cross-tier asynchrony cannot be expressed inside one SPMD program, so
the simulation uses an event queue over simulated wall-clock time: each
logical actor (a tier for FedAT/TiFL, the global round for FedAvg, a client
for FedAsync) finishes its round at ``now + latency`` and is rescheduled.
The server reacts to completion events in timestamp order — exactly the
paper's Figure 1 timeline.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, List, Optional, Tuple


@dataclasses.dataclass(order=True)
class Event:
    time: float
    seq: int
    actor: Any = dataclasses.field(compare=False)


class EventQueue:
    def __init__(self):
        self._heap: List[Event] = []
        self._counter = 0
        self.now = 0.0

    def push(self, delay: float, actor: Any) -> None:
        heapq.heappush(self._heap,
                       Event(self.now + delay, self._counter, actor))
        self._counter += 1

    def pop(self) -> Tuple[float, Any]:
        ev = heapq.heappop(self._heap)
        self.now = ev.time
        return ev.time, ev.actor

    def __len__(self) -> int:
        return len(self._heap)

    # -- crash-resume (core/faults.py): the queue must round-trip through
    # a pickle so a resumed engine replays the exact same event order
    def state(self) -> dict:
        """Serializable snapshot: heap entries (already heap-ordered),
        the monotonic tiebreak counter, and the simulated clock."""
        return {
            "heap": [(e.time, e.seq, e.actor) for e in self._heap],
            "counter": self._counter,
            "now": self.now,
        }

    def set_state(self, state: dict) -> None:
        self._heap = [Event(t, s, a) for t, s, a in state["heap"]]
        self._counter = int(state["counter"])
        self.now = float(state["now"])


@dataclasses.dataclass
class Metrics:
    """Timeline of the three robustness criteria (Definition 3.1) + cost."""
    times: List[float] = dataclasses.field(default_factory=list)
    rounds: List[int] = dataclasses.field(default_factory=list)
    acc: List[float] = dataclasses.field(default_factory=list)
    acc_var: List[float] = dataclasses.field(default_factory=list)
    bytes_up: List[float] = dataclasses.field(default_factory=list)
    bytes_down: List[float] = dataclasses.field(default_factory=list)

    def record(self, t, r, acc, var, up, down):
        self.times.append(float(t))
        self.rounds.append(int(r))
        self.acc.append(float(acc))
        self.acc_var.append(float(var))
        self.bytes_up.append(float(up))
        self.bytes_down.append(float(down))

    @property
    def best_acc(self) -> float:
        return max(self.acc) if self.acc else 0.0

    def time_to_accuracy(self, target: float) -> Optional[float]:
        for t, a in zip(self.times, self.acc):
            if a >= target:
                return t
        return None

    def bytes_to_accuracy(self, target: float) -> Optional[float]:
        for up, down, a in zip(self.bytes_up, self.bytes_down, self.acc):
            if a >= target:
                return up + down
        return None

    def summary(self) -> dict:
        return {
            "best_acc": self.best_acc,
            "final_var": self.acc_var[-1] if self.acc_var else 0.0,
            "total_mb": (self.bytes_up[-1] + self.bytes_down[-1]) / 1e6
            if self.bytes_up else 0.0,
            "sim_time": self.times[-1] if self.times else 0.0,
        }
