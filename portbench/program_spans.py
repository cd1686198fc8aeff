"""What the metrics read of the program's own spans and counters
(``rec["program_spans"]``, ``rec["program_counters"]``).  The port's
tracer (``repro_torch.spans``) records while a ``torch.profiler`` runs,
which in a traced run on a card is the driver's device trace over the
window; the first reader takes what the tracer holds into the record
(:func:`load`).  A span is ``(name, id, parent, host_start, host_end,
dev_start, dev_end, request)``, times on the host's ``perf_counter``
clock.  Each reader returns None on a record with no program spans (a
program without the tracer, or a run without a profiler)."""
from __future__ import annotations

import sys
from typing import Dict, Optional

NAME, ID, PARENT, DEV_START, DEV_END = 0, 1, 2, 5, 6
ROUND = "fedat.round"
UPDATE = "client.update"


def load(rec: Dict):
    """The record's program spans; a record without the key takes them,
    and the counters, from the program's tracer where it has one."""
    if "program_spans" not in rec:
        tracer = sys.modules.get("repro_torch.spans")
        out = tracer.collect() if hasattr(tracer, "collect") else {}
        rec["program_spans"] = list(out.get("spans", ()))
        rec["program_counters"] = dict(out.get("counters", {}))
    return rec["program_spans"]


def _dev(s) -> float:
    return s[DEV_END] - s[DEV_START]


def per_round_ms(rec: Dict, name: str) -> Optional[float]:
    """Device milliseconds of the spans ``name`` in the window, per
    ``fedat.round``."""
    sp = load(rec)
    n = sum(1 for s in sp if s[NAME] == ROUND) if sp else 0
    if not n:
        return None
    return 1e3 * sum(_dev(s) for s in sp if s[NAME] == name) / n


def round_self_ms(rec: Dict) -> Optional[float]:
    """Mean device milliseconds of a ``fedat.round`` outside its
    ``client.update`` child."""
    sp = load(rec)
    rounds = [s for s in sp if s[NAME] == ROUND] if sp else []
    if not rounds:
        return None
    upd: Dict[int, float] = {}
    for s in sp:
        if s[NAME] == UPDATE and s[PARENT] is not None:
            upd[s[PARENT]] = upd.get(s[PARENT], 0.0) + _dev(s)
    return 1e3 * sum(_dev(r) - upd.get(r[ID], 0.0)
                     for r in rounds) / len(rounds)


def useful_pct(rec: Dict) -> Optional[float]:
    """100 x the live clients' real samples over the sample slots the
    window's rounds trained."""
    c = rec.get("program_counters") if load(rec) else None
    if not c or not c.get("client.slots"):
        return None
    return 100.0 * c.get("client.real_samples", 0) / c["client.slots"]
