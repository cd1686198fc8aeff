"""The device trace of a measured window: ``torch.profiler`` with CUDA
activity only, kept in memory, reduced to busy time, the heaviest device
operations and the longest idle stretches by what the host was doing.

Device timestamps are put on the host's ``perf_counter`` clock by two
marker kernels (``torch.cuda._sleep``), each launched right after a
synchronise whose host time is read, so the spans the drivers record on
the host line up with the kernels to within a launch's latency.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

#: the marker kernel's name (ATen's ``_sleep``)
MARKER = "spin_kernel"
#: device activities counted as busy
ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")

Event = Tuple[str, float, float]


def _attr(e, *names):
    for n in names:
        f = getattr(e, n, None)
        if f is not None:
            return f() if callable(f) else f
    return None


class DeviceTrace:
    """Start before the window, stop after it; ``events`` holds the
    device's ``(name, start, end)`` on the host clock."""

    def __init__(self):
        import torch
        self.torch = torch
        self.prof = None
        self.marks: List[int] = []
        self.events: List[Event] = []
        self.aligned = False

    def _mark(self) -> None:
        self.torch.cuda.synchronize()
        self.marks.append(time.perf_counter_ns())
        self.torch.cuda._sleep(1)
        self.torch.cuda.synchronize()

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self._mark()

    def stop(self) -> None:
        self._mark()
        self.prof.stop()
        raw = []
        for e in self.prof.profiler.kineto_results.events():
            act = str(_attr(e, "activity_type") or "").lower()
            dev = str(_attr(e, "device_type") or "")
            if act and not any(a in act for a in ACTIVITIES):
                continue
            if not act and "CUDA" not in dev:
                continue
            s = _attr(e, "start_ns")
            d = _attr(e, "duration_ns")
            if s is None:
                s = _attr(e, "start_us") * 1000
                d = _attr(e, "duration_us") * 1000
            raw.append((str(_attr(e, "name")), int(s), int(s) + int(d)))
        marks = sorted(r for r in raw if MARKER in r[0])
        rest = [r for r in raw if MARKER not in r[0]]
        if marks:
            offset = marks[0][1] - self.marks[0]
            self.aligned = True
        else:   # no marker seen: the first activity stands in for it
            offset = min((r[1] for r in rest), default=0) - self.marks[0]
        self.events = sorted((n, (s - offset) / 1e9, (t - offset) / 1e9)
                             for n, s, t in rest)
        self.prof = None


def union(events: Sequence[Event], lo: float, hi: float
          ) -> Tuple[float, List[Tuple[float, float]]]:
    """Seconds of [lo, hi] in which some device activity ran, and the
    merged busy intervals."""
    ivs = sorted((max(s, lo), min(t, hi)) for _, s, t in events
                 if t > lo and s < hi)
    merged: List[List[float]] = []
    for s, t in ivs:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return sum(t - s for s, t in merged), [(s, t) for s, t in merged]


def short_name(name: str) -> str:
    n = name[5:] if name.startswith("void ") else name
    for cut in ("(", "<"):
        i = n.find(cut)
        if i > 0:
            n = n[:i]
    return n[:96]


def breakdown(events: Sequence[Event], lo: float, hi: float,
              spans: Sequence[Tuple[str, float, float]],
              aligned: bool, top: int = 10) -> Dict[str, list]:
    """The device operations that took the most time, and the idle time
    of [lo, hi] by the host span around each gap's middle (the innermost;
    ``host: outside spans`` where none is)."""
    by_op: Dict[str, float] = {}
    for n, s, t in events:
        if t > lo and s < hi:
            k = short_name(n)
            by_op[k] = by_op.get(k, 0.0) + (min(t, hi) - max(s, lo))
    _, merged = union(events, lo, hi)
    gaps, prev = [], lo
    for s, t in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = t
    if hi > prev:
        gaps.append((prev, hi))
    by_host: Dict[str, float] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inside = [(e - s, n) for n, s, e in spans if s <= mid <= e]
        what = min(inside)[1] if inside and aligned else (
            "outside spans" if aligned else "unaligned trace")
        by_host[what] = by_host.get(what, 0.0) + (b - a)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[f"host: {k}", v] for k, v in idle]}


def kernel_time(events: Sequence[Event], match, lo: float, hi: float
                ) -> Tuple[int, float]:
    """(launches, seconds) of the device events in [lo, hi] whose name
    ``match`` accepts."""
    n, sec = 0, 0.0
    for name, s, t in events:
        if s >= lo and t <= hi and match(name):
            n += 1
            sec += t - s
    return n, sec


def finish(trace: Optional[DeviceTrace], rec: Dict, lo: float,
           hi: float) -> None:
    """Fill a traced record: device events, busy seconds, breakdown."""
    if trace is None:
        return
    rec["device_events"] = trace.events
    rec["busy_s"], _ = union(trace.events, lo, hi)
    rec["breakdown"] = breakdown(trace.events, lo, hi, rec["spans"],
                                 trace.aligned)
