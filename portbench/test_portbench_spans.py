"""The program's spans and counters in a traced run of the FedAT cell at
its smoke size on the CPU: the six metrics that read them, the step spans
inside their update, the useful share against the reference's count, and
a program without the tracer (the readers then find nothing).

On a card the driver's device trace runs ``torch.profiler`` over the
window, and the program's tracer records while a profiler runs.  The CPU
run has no device trace, so :func:`profiled_windows` starts a CPU
profiler at the same two points of the driver: where the window opens
(``harness.reset_peak``) and after the engine's run
(``harness.free_device``)."""
import contextlib
import sys

import pytest

from portbench import harness, program_spans
from portbench.testing import one_thread, smoke_run, use_port

CELL = "fedat_cnn_k100"
NEW = ["fedat.update.gather_ms", "fedat.update.fwd_ms",
       "fedat.update.bwd_ms", "fedat.update.opt_ms", "fedat.round_self_ms",
       "fedat.useful_pct"]
STEPS = ["client.gather", "client.fwd", "client.bwd", "client.opt"]


@contextlib.contextmanager
def profiled_windows():
    """A CPU ``torch.profiler`` over each traced window the driver opens
    in the block, as its device trace is on a card."""
    from torch.profiler import ProfilerActivity, profile
    use_port()
    from repro_torch import spans
    live = []
    reset, free = harness.reset_peak, harness.free_device

    def start(dev):
        reset(dev)
        live.append(profile(activities=[ProfilerActivity.CPU]))
        live[-1].start()

    def stop(dev):
        while live:
            live.pop().stop()
        free(dev)

    spans.disable()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harness, "reset_peak", start)
        mp.setattr(harness, "free_device", stop)
        try:
            yield
        finally:
            while live:
                live.pop().stop()
            spans.disable()


def _traced_record(seed):
    use_port()
    cell = harness.load_cell(CELL, seed=seed, seconds=0.5, trace=True,
                             device="cpu", smoke=True)
    with one_thread(), profiled_windows():
        rec = harness.load_module("drivers", "fedat_sim").run(cell)
        program_spans.load(rec)
    rec["config"], rec["workload"], rec["peaks"] = (cell.config,
                                                    cell.workload, None)
    return cell, rec


@pytest.fixture(scope="module")
def traced():
    return _traced_record(7)


def test_a_traced_rehearsal_reads_the_new_metrics():
    with profiled_windows():
        res = smoke_run(CELL, seed=5, trace=True)
    assert res["correct"], res["checks"]
    assert set(NEW) <= set(res["metrics"])
    for name in NEW:
        assert res["metrics"][name]["value"] > 0, name


def test_step_spans_lie_inside_their_update(traced):
    _, rec = traced
    sp = rec["program_spans"]
    updates = [s for s in sp if s[0] == "client.update"]
    assert updates
    for u in updates:
        kids = [s for s in sp if s[2] == u[1]]
        assert kids and {s[0] for s in kids} == set(STEPS)
        for s in kids:
            assert u[3] <= s[3] <= s[4] <= u[4]
            assert u[5] <= s[5] <= s[6] <= u[6]
        assert sum(s[6] - s[5] for s in kids) <= u[6] - u[5]


def test_useful_share_is_the_reference_count_over_the_slots(traced):
    cell, rec = traced
    sp = cell.traffic["spec"]
    K = sp["tiers"]["clients_per_round"]
    E, bs = sp["engine"]["local_epochs"], sp["engine"]["batch_size"]
    prog = rec["program_counters"]
    rounds = sum(1 for s in rec["program_spans"] if s[0] == "fedat.round")
    assert rounds == rec["counters"]["committed_updates"] > 0
    assert prog["client.real_samples"] == rec["counters"]["real_samples"]
    assert prog["client.slots"] % (rounds * K * E * bs) == 0
    value = harness.load_module("metrics", "fedat.useful_pct").read(rec)
    assert value == 100.0 * rec["counters"]["real_samples"] \
        / prog["client.slots"]


@pytest.mark.parametrize("name", NEW)
def test_a_reader_finds_nothing_without_program_spans(traced, name):
    _, rec = traced
    bare = {k: v for k, v in rec.items()
            if k not in ("program_spans", "program_counters")}
    read = harness.load_module("metrics", name).read
    assert read(rec) is not None
    assert read(bare) is None
    assert read(dict(rec, program_spans=[])) is None


def test_a_traced_run_without_a_profiler_reads_no_program_spans():
    """No profiler ran (a traced run on the CPU): nothing recorded, the
    metrics that read the program's spans are left out."""
    res = smoke_run(CELL, seed=5, trace=True)
    assert res["correct"], res["checks"]
    assert not set(NEW) & set(res["metrics"])


def test_a_program_without_the_tracer_runs_traced(monkeypatch):
    """A program without the tracer (no ``repro_torch.spans`` loaded):
    the run goes on, the metrics that read its spans are left out."""
    use_port()
    from repro_torch import api  # noqa: F401  (the program, loaded whole)
    monkeypatch.delitem(sys.modules, "repro_torch.spans")
    with profiled_windows():
        res = smoke_run(CELL, seed=5, trace=True)
    assert res["correct"], res["checks"]
    assert {"fedat.round_ms", "fedat.outside_round_pct"} <= set(
        res["metrics"])
    assert not set(NEW) & set(res["metrics"])


def test_round_self_time_leaves_out_the_update():
    def span(name, i, parent, a, b):
        return (name, i, parent, a, b, a, b, 0)
    rec = {"program_spans": [
        span("fedat.round", 0, None, 0.0, 1.0),
        span("client.update", 1, 0, 0.2, 0.9),
        span("fedat.round", 2, None, 2.0, 2.5),
        span("client.update", 3, 2, 2.1, 2.2)]}
    assert program_spans.round_self_ms(rec) == pytest.approx(
        1e3 * (0.3 + 0.4) / 2)
    assert program_spans.per_round_ms(rec, "client.update") == \
        pytest.approx(1e3 * 0.8 / 2)
