"""Spans and counters inside the program, kept in memory.

    spans.enable(device)          # start recording (device: "cuda" / "cpu")
    with spans.span("fedat.round"):
        ...
    spans.count("client.slots", n)
    out = spans.collect()         # {"spans": [...], "counters": {...}}
    spans.disable()

Off (the default), :func:`span` returns one shared no-op context: no
allocation, no clock read, no device work.  On, a span records its name,
its parent (the innermost open span), its request (the ordinal of the root
span it sits under, so every span of one engine event shares it), and the
host ``time.perf_counter()`` at entry and exit.  On CUDA it also records a
timing event on the current stream at entry and exit, without a
synchronise; on the CPU ops run synchronously, so the device interval is
the host interval.  Whether a span records is decided at entry, and a span
is closed when an exception leaves it.

:func:`collect` synchronises once and puts each span's events on the host
clock through an anchor event that :func:`enable` records right after a
synchronise whose host time it reads, so program spans, a driver's host
spans and a profiler's device events aligned the same way share one clock.

Spans also record, without a call, while a ``torch.profiler`` records
(unless :func:`enable` was called): the first span entered under it starts
a recorder of its own on the device the process has initialised, and
:func:`collect` returns that recorder's spans and drops it once the
profiler has stopped.  So a profiled window of any caller holds the
program's spans, on the profile's clock.

One recorder per process, driven from the thread that runs the engine.
"""
from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional

import torch


class Span(NamedTuple):
    """A closed span; times are host ``perf_counter`` seconds."""
    name: str
    id: int
    parent: Optional[int]
    host_start: float
    host_end: float
    dev_start: float
    dev_end: float
    request: int


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Recorder:
    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        #: [name, parent record, request, h0, h1, e0, e1], in entry order
        self.records: List[list] = []
        self.stack: List[list] = []
        self.roots = 0
        self.counters: Dict[str, int] = {}
        if self.cuda:
            torch.cuda.synchronize()
            self.anchor_host = time.perf_counter()
            self.anchor = self.event()

    @staticmethod
    def event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev


class _On:
    __slots__ = ("rec", "name", "r")

    def __init__(self, rec: _Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        parent = rec.stack[-1] if rec.stack else None
        if parent is None:
            request = rec.roots
            rec.roots += 1
        else:
            request = parent[2]
        self.r = r = [self.name, parent, request, None, None, None, None]
        rec.records.append(r)
        rec.stack.append(r)
        if rec.cuda:
            r[5] = rec.event()
        r[3] = time.perf_counter()

    def __exit__(self, *exc):
        rec, r = self.rec, self.r
        if rec.cuda:
            r[6] = rec.event()
        r[4] = time.perf_counter()
        # a collect while the span was open cleared the stack
        if rec.stack and rec.stack[-1] is r:
            rec.stack.pop()
        return False


_rec: Optional[_Recorder] = None
#: the recorder that follows a running torch profiler
_prof: Optional[_Recorder] = None
_profiling = getattr(torch._C._autograd, "_profiler_enabled", lambda: False)


def _active() -> Optional[_Recorder]:
    """The recorder a span entered now records into, or None (off)."""
    global _prof
    if _rec is not None:
        return _rec
    if not _profiling():
        return None
    if _prof is None:
        _prof = _Recorder("cuda" if torch.cuda.is_initialized() else "cpu")
    return _prof


def enable(device) -> None:
    """Start recording, anew, with spans timed on ``device``."""
    global _rec
    _rec = _Recorder(device)


def disable() -> None:
    """Stop recording and drop what was not collected (a profiler that
    still records starts a recorder anew at the next span)."""
    global _rec, _prof
    _rec = _prof = None


def on() -> bool:
    return _active() is not None


def span(name: str):
    """A context manager timing the block under ``name`` (a shared no-op
    while tracing is off)."""
    rec = _active()
    if rec is None:
        return _OFF
    return _On(rec, name)


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` (nothing while tracing is off)."""
    rec = _active()
    if rec is not None:
        rec.counters[name] = rec.counters.get(name, 0) + int(n)


def collect() -> Dict[str, object]:
    """The closed spans (in entry order) and the counters since
    :func:`enable` or the last collect; clears both.  Spans still open
    are left out.  Without :func:`enable`, the spans recorded under a
    profiler (the recorder is dropped once the profiler has stopped)."""
    global _prof
    rec = _rec if _rec is not None else _prof
    if rec is None:
        return {"spans": [], "counters": {}}
    if rec is _prof and not _profiling():
        _prof = None
    if rec.cuda:
        torch.cuda.synchronize()
    out: List[Span] = []
    ids: Dict[int, int] = {}
    for r in rec.records:
        name, parent, request, h0, h1, e0, e1 = r
        if h1 is None:
            continue
        if rec.cuda:
            d0 = rec.anchor_host + rec.anchor.elapsed_time(e0) / 1e3
            d1 = rec.anchor_host + rec.anchor.elapsed_time(e1) / 1e3
        else:
            d0, d1 = h0, h1
        ids[id(r)] = len(out)
        out.append(Span(name, len(out),
                        None if parent is None else ids.get(id(parent)),
                        h0, h1, d0, d1, request))
    counters = rec.counters
    rec.records, rec.stack, rec.counters = [], [], {}
    return {"spans": out, "counters": counters}
