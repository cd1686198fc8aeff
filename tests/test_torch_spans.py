"""The port's span tracer (``repro_torch/spans.py``) alone, and the spans
and counters a FedAT run records at the benchmark cell's smoke size
(``portbench/workloads/fedat_cnn_k100.json``) on the CPU: one round under
each engine event, the round's children in order, one span of each
``client.*`` kind a local step, counters equal to the benchmark
reference's count of real samples, and trajectories bitwise the same with
tracing on and off."""
import copy
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import api, spans

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.reference import fedat as ref  # noqa: E402

ROUND_CHILDREN = ["round.perms", "round.data", "codec.down",
                  "client.update", "codec.up", "round.eq4", "round.eq3"]
STEP_KINDS = ["client.gather", "client.fwd", "client.bwd", "client.opt"]
UPDATES = 6
COUNT = spans.count

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _tracing_off():
    spans.disable()
    yield
    spans.disable()


def test_off_records_nothing():
    assert not spans.on()
    with spans.span("a") as s:
        with spans.span("b"):
            spans.count("n", 3)
    assert s is None
    assert spans.span("a") is spans.span("b")   # one shared no-op
    assert spans.collect() == {"spans": [], "counters": {}}


def test_nesting_parents_and_requests():
    spans.enable("cpu")
    for _ in range(2):
        with spans.span("root"):
            with spans.span("a"):
                with spans.span("a1"):
                    pass
            with spans.span("b"):
                spans.count("n", 2)
    spans.count("n", 5)
    out = spans.collect()
    got = [(s.name, s.id, s.parent, s.request) for s in out["spans"]]
    assert got == [("root", 0, None, 0), ("a", 1, 0, 0), ("a1", 2, 1, 0),
                   ("b", 3, 0, 0),
                   ("root", 4, None, 1), ("a", 5, 4, 1), ("a1", 6, 5, 1),
                   ("b", 7, 4, 1)]
    assert out["counters"] == {"n": 9}
    for s in out["spans"]:
        assert s.host_start <= s.host_end
        # the CPU runs ops synchronously: device interval = host interval
        assert (s.dev_start, s.dev_end) == (s.host_start, s.host_end)
        if s.parent is not None:
            p = out["spans"][s.parent]
            assert p.host_start <= s.host_start <= s.host_end <= p.host_end
    assert spans.collect() == {"spans": [], "counters": {}}


def test_a_span_closes_when_an_exception_leaves_it():
    spans.enable("cpu")
    with pytest.raises(KeyError):
        with spans.span("outer"):
            with spans.span("inner"):
                raise KeyError("x")
    with spans.span("next"):
        pass
    out = spans.collect()["spans"]
    assert [(s.name, s.parent, s.request) for s in out] == [
        ("outer", None, 0), ("inner", 0, 0), ("next", None, 1)]
    assert all(s.host_end >= s.host_start for s in out)


def test_on_or_off_is_decided_at_entry():
    with spans.span("before"):          # off at entry: never recorded
        spans.enable("cpu")
        with spans.span("inside"):
            pass
    assert [(s.name, s.parent) for s in spans.collect()["spans"]] == [
        ("inside", None)]
    with spans.span("open"):
        out = spans.collect()
        with spans.span("child"):
            pass
    # the open span is left out; a span entered after the collect is a
    # root, and the open span still closes
    assert out == {"spans": [], "counters": {}}
    assert [(s.name, s.parent) for s in spans.collect()["spans"]] == [
        ("child", None)]
    with spans.span("last"):
        spans.disable()                 # on at entry: closes all the same
    assert spans.collect() == {"spans": [], "counters": {}}


def test_spans_follow_a_running_profiler():
    from torch.profiler import ProfilerActivity, profile
    with spans.span("before"):
        pass
    assert not spans.on()
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        assert spans.on()
        with spans.span("root"):
            with spans.span("child"):
                spans.count("n", 4)
        mid = spans.collect()           # the profiler still records
        with spans.span("later"):
            pass
    finally:
        prof.stop()
    with spans.span("after"):           # the profiler has stopped: off
        pass
    assert not spans.on()
    assert [(s.name, s.parent) for s in mid["spans"]] == [
        ("root", None), ("child", 0)]
    assert mid["counters"] == {"n": 4}
    assert [s.name for s in spans.collect()["spans"]] == ["later"]
    # that collect dropped the profiler's recorder
    assert spans.collect() == {"spans": [], "counters": {}}


def _smoke_spec(gated: bool):
    body = json.loads((ROOT / "portbench" / "workloads"
                       / "fedat_cnn_k100.json").read_text())
    d = copy.deepcopy(body["smoke"]["spec"])
    d["engine"].update(seed=5, total_updates=UPDATES)
    if gated:
        d["faults"] = {"nan_rate": 0.3, "update_clip": 0.5, "seed": 2}
    return api.ExperimentSpec.from_dict(d)


def _run(gated: bool, traced: bool, monkeypatch):
    """A FedAT run at the cell's smoke size: the final global model, the
    metrics, each round's (seed, ids) and, traced, the spans and each
    round's counts."""
    run_ = api.build(_smoke_spec(gated), device="cpu")
    ex = run_.env.executor()
    rounds, counts = [], []
    orig = ex.fedat_round

    def fedat_round(w_global, tier_models, m, ids, seed, **kw):
        rounds.append((int(seed), np.array(ids)))
        return orig(w_global, tier_models, m, ids, seed, **kw)

    def count(name, n):
        counts.append((name, int(n)))
        COUNT(name, n)

    ex.fedat_round = fedat_round
    monkeypatch.setattr(spans, "count", count)
    if traced:
        spans.enable("cpu")
    try:
        res = run_.run()
        out = spans.collect()
    finally:
        spans.disable()
        del ex.fedat_round
    final = {k: v.clone() for k, v in run_.strategy.global_params().items()}
    return final, res.metrics, rounds, out, counts, run_.env


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
def test_a_fedat_run_records_its_rounds(gated, monkeypatch):
    final, metrics, rounds, out, counts, env = _run(gated, True, monkeypatch)
    assert any("gate" in k for k in env.executor().trace_counts) == gated
    sp = out["spans"]
    sc = env.sc
    steps = sc.local_epochs * (env.client_cap // sc.batch_size)
    children = {}
    for s in sp:
        children.setdefault(s.parent, []).append(s)
    events = [s for s in sp if s.name == "engine.event"]
    rounds_sp = [s for s in sp if s.name == "fedat.round"]
    assert len(rounds_sp) == len(rounds) >= UPDATES
    assert {s.parent for s in events} == {None}
    for r in rounds_sp:
        ev = sp[r.parent]
        assert ev.name == "engine.event" and r.request == ev.request
        assert [c.name for c in children[ev.id]] == ["fedat.round"]
        kids = children[r.id]
        assert [c.name for c in kids] == ROUND_CHILDREN
        upd = kids[ROUND_CHILDREN.index("client.update")]
        inner = children[upd.id]
        assert [c.name for c in inner] == STEP_KINDS * steps
        assert all(c.request == r.request for c in kids + inner)
    # one root a request; evals are roots of their own
    assert len({s.request for s in sp if s.parent is None}) == len(
        [s for s in sp if s.parent is None])
    assert sum(s.name == "engine.eval" for s in sp) == len(metrics.rounds)
    for e in (s for s in sp if s.name == "engine.eval"):
        assert e.parent is None
        assert [c.name for c in children[e.id]] == ["eval.accuracy"]

    # each round's counters against the reference's count
    K, E, cap, bs = (sc.clients_per_round, sc.local_epochs, env.client_cap,
                     sc.batch_size)
    slots = [n for k, n in counts if k == "client.slots"]
    real = [n for k, n in counts if k == "client.real_samples"]
    assert slots == [K * E * (cap // bs) * bs] * len(rounds)
    assert real == [ref.visited_real_samples(
        seed, [int(env.n_train_all[c]) for c in ids], K, E, cap, bs)
        for seed, ids in rounds]
    assert out["counters"] == {"client.slots": sum(slots),
                               "client.real_samples": sum(real)}


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
def test_tracing_leaves_the_trajectory_bitwise(gated, monkeypatch):
    off = _run(gated, False, monkeypatch)
    on = _run(gated, True, monkeypatch)
    assert off[3] == {"spans": [], "counters": {}} and off[4] == []
    for k in off[0]:
        assert torch.equal(off[0][k], on[0][k]), k
    assert off[1] == on[1]
    assert [s for s, _ in off[2]] == [s for s, _ in on[2]]
