"""The FedAT cell rehearsed on the CPU at its smoke size: the plain
reference agrees with the port, each fault planted under the harness
turns ``correct`` false, the control fails a limit; and on the card
(marked ``cuda``) one short run of the cell itself."""
import subprocess
import sys

import numpy as np
import pytest

from portbench import harness
from portbench.testing import (control_readings, one_thread, smoke_run,
                               use_port)

CELL = "fedat_cnn_k100"


def test_rehearsal_agrees_with_the_reference():
    res = smoke_run(CELL)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"events_per_s", "setup_s"}
    assert list(res)[-1] == "checks"


def test_traced_rehearsal_reads_the_host_metrics():
    res = smoke_run(CELL, seed=5, trace=True)
    assert res["correct"], res["checks"]
    # no card: only the host-clock readers find something to read
    assert {"fedat.round_ms", "fedat.outside_round_pct"} <= set(
        res["metrics"])
    assert "mfu.fedat" not in res["metrics"]


def _unchanged(self, w_global, tier_models, m, ids, seed, **kw):
    return w_global, tier_models


def _half(orig):
    def fedat_round(self, w_global, tier_models, m, ids, seed, **kw):
        return orig(self, w_global, tier_models, m,
                    np.asarray(ids)[:max(1, len(ids) // 2)], seed, **kw)
    return fedat_round


def _fold_skipped(orig):
    def fedat_round(self, w_global, tier_models, m, ids, seed, **kw):
        _, stack = orig(self, w_global, tier_models, m, ids, seed, **kw)
        return {k: v.clone() for k, v in w_global.items()}, stack
    return fedat_round


FAULTS = {"unchanged": lambda orig: _unchanged, "half_batch": _half,
          "fold_skipped": _fold_skipped}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    use_port()
    from repro_torch.core.executor import RoundExecutor
    monkeypatch.setattr(RoundExecutor, "fedat_round",
                        FAULTS[fault](RoundExecutor.fedat_round))
    res = smoke_run(CELL, seed=11)
    assert not res["correct"], res["checks"]


def test_a_leaf_left_unmoved_fails_the_worst_leaf(monkeypatch):
    """One leaf of the global model kept at the round's input: the median
    leaf does not see it, the worst leaf does."""
    use_port()
    from repro_torch.core.executor import RoundExecutor
    orig = RoundExecutor.fedat_round

    def fedat_round(self, w_global, tier_models, m, ids, seed, **kw):
        w, stack = orig(self, w_global, tier_models, m, ids, seed, **kw)
        return dict(w, d2_w=w_global["d2_w"].clone()), stack
    monkeypatch.setattr(RoundExecutor, "fedat_round", fedat_round)
    res = smoke_run(CELL, seed=11)
    checks = res["checks"]
    assert not res["correct"], checks
    assert checks["global_worst_gap"]["value"] > 0.5, checks
    assert checks["global_gap"]["value"] <= checks["global_gap"]["limit"]


def _spec(key, seed):
    body = harness.load_json(harness.PB / "workloads" / f"{CELL}.json")
    spec = dict(body[key]["spec"])
    spec["engine"] = dict(spec["engine"], seed=seed)
    return body[key], spec


@pytest.mark.parametrize("key", ["traffic", "smoke"])
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 17, 4_100_000_001])
def test_checked_rounds_fold_a_trained_slot_within_warm_up(key, seed):
    from portbench.reference import fedat as ref
    tr, spec = _spec(key, seed)
    rounds = ref.schedule(spec, seed, tr["warm_updates"])
    checked = ref.checked_rounds(rounds, tr["fold_rounds"])
    assert checked is not None and max(checked) < tr["warm_updates"]
    fold = checked[1]
    trained = {r["tier"] for r in rounds[:fold + 1]}
    assert any(w > 0 and m in trained
               for m, w in enumerate(rounds[fold]["cross_weights"]))
    assert not any(w > 0 and m in {r["tier"] for r in rounds[:i + 1]}
                   for i in range(fold)
                   for m, w in enumerate(rounds[i]["cross_weights"]))


@pytest.mark.parametrize("seed", [5, 8, 13])
def test_rounds_left_untrained_do_not_change_the_checked_ones(seed):
    """The reference trains only the rounds the checked ones depend on:
    the checked rounds read bitwise as when every round is trained."""
    import torch
    from portbench.reference import fedat as ref
    use_port()
    tr, spec = _spec("smoke", seed)
    cell = harness.load_cell(CELL, device="cpu", smoke=True)
    cfg = dict(cell.config, **tr["config"])
    rounds = ref.schedule(spec, seed, tr["warm_updates"])
    checked = ref.checked_rounds(rounds, tr["fold_rounds"])
    every = list(range(max(checked) + 1))
    assert ref.needed_rounds(rounds, checked, 5) < set(every)
    with one_thread():
        w0 = ref.draw_params(cfg, seed, "cpu")
        few = ref.observe(spec, cfg, seed, w0, checked)
        full = {o["round"]: o for o in ref.observe(spec, cfg, seed, w0,
                                                   every)}
    for o in few:
        for key in ("w_in", "slot", "w_out"):
            for k, v in o[key].items():
                assert torch.equal(v, full[o["round"]][key][k]), (o, key, k)


@pytest.mark.parametrize("variant", ["control", "half_batch"])
def test_control_is_not_correct(variant):
    cell, r = control_readings(CELL, 5, variant)
    assert any(r[k] > cell.limits[k] for k in cell.limits if k in r), r


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")


@pytest.mark.cuda
def test_card_run(card):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELL, "--seed",
         "2147483999", "--seconds", "5", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    import json
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
