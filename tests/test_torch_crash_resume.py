"""The port's engine crash-resume: an interrupted run, resumed from its
newest engine snapshot, replays the *exact* metrics trajectory and final
params of an uninterrupted run, in process (a raising eval callback) and
out of process (SIGKILL of a CLI run, then ``--resume``).  The resume
guards raise the reference's errors, and an engine snapshot of the port
carries the same manifest (paths, shapes, dtypes) as the reference's at
the same step of the same spec."""
import hashlib
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from repro import api as japi
from repro_torch import api as tapi

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOTAL = 12


def _spec(api=tapi, **faults_kwargs):
    """tests/test_crash_resume.py's scenario."""
    kw = dict(churn_rate=0.5, churn_window=(1.0, 60.0),
              churn_downtime=20.0, checkpoint_every=2, seed=4)
    kw.update(faults_kwargs)
    return api.ExperimentSpec(
        data=api.DataSpec(n_clients=8, samples_per_client=24, image_hw=8),
        tiers=api.TierSpec(n_tiers=2, clients_per_round=2, n_unstable=0),
        engine=api.EngineSpec(total_updates=TOTAL, eval_every=2,
                              local_epochs=1),
        faults=api.FaultSpec(**kw))


def _build(spec):
    return tapi.build(spec, device="cpu")


def _fields(m):
    return [m.times, m.rounds, m.acc, m.acc_var, m.bytes_up, m.bytes_down]


def _traj_hash(m):
    doc = {"times": m.times, "rounds": m.rounds, "acc": m.acc,
           "acc_var": m.acc_var, "bytes_up": m.bytes_up,
           "bytes_down": m.bytes_down}
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True).encode()).hexdigest()


def _same_params(a, b):
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)


class Abort(Exception):
    pass


def _interrupt(spec, ck, after=2):
    """Run ``spec`` with engine checkpoints into ``ck`` and raise out of
    the ``after``-th eval."""
    seen = []

    def bomb(point):
        seen.append(point)
        if len(seen) == after:
            raise Abort

    with pytest.raises(Abort):
        _build(spec).run(on_eval=bomb, checkpoint_dir=ck)


def test_interrupted_run_resumes_bitwise(tmp_path):
    spec = _spec()
    ref_run = _build(spec)
    ref = ref_run.run().metrics
    ck = str(tmp_path / "ck")
    _interrupt(spec, ck)
    steps = [p for p in os.listdir(os.path.join(ck, "engine"))
             if p.startswith("step_")]
    assert steps, "the interrupted run left no engine snapshot"
    run = _build(spec)
    res = run.run(checkpoint_dir=ck, resume_engine=True)
    assert _fields(res.metrics) == _fields(ref)
    # the resumed trajectory is the *whole* run, not just the tail
    assert len(res.metrics.acc) == len(ref.acc) > 2
    assert _same_params(run.strategy.global_params(),
                        ref_run.strategy.global_params())
    assert _same_params(run.strategy.tier_models,
                        ref_run.strategy.tier_models)


def test_resume_from_final_snapshot_is_a_noop_replay(tmp_path):
    spec = _spec(checkpoint_every=TOTAL)   # the snapshot lands at the end
    ck = str(tmp_path / "ck")
    first = _build(spec)
    ref = first.run(checkpoint_dir=ck).metrics
    run = _build(spec)
    res = run.run(checkpoint_dir=ck, resume_engine=True)
    assert _fields(res.metrics) == _fields(ref)
    assert _same_params(run.strategy.global_params(),
                        first.strategy.global_params())


def _message(api, fn):
    with pytest.raises(api.SpecError) as e:
        fn()
    return str(e.value)


def test_resume_guards_match_the_reference(tmp_path):
    """Each guard raises the reference's SpecError, word for word (the
    directories differ, so they are replaced by a token)."""
    def norm(msg, d):
        return msg.replace(str(d), "<dir>")

    cases = []
    for api, build in ((japi, japi.build),
                       (tapi, lambda s: tapi.build(s, device="cpu"))):
        d = tmp_path / api.__name__
        spec = _spec(api)
        msgs = [
            # no checkpoint_dir
            _message(api, lambda: build(spec).run(resume_engine=True)),
            # nothing was ever checkpointed there
            _message(api, lambda: build(spec).run(
                checkpoint_dir=str(d / "empty"), resume_engine=True))]
        ck = str(d / "ck")
        build(_spec(api, checkpoint_every=TOTAL)).run(checkpoint_dir=ck)
        # another spec may not checkpoint into the directory
        msgs.append(_message(api, lambda: build(_spec(
            api, checkpoint_every=TOTAL, seed=9)).run(checkpoint_dir=ck)))
        # a spec without engine checkpointing cannot resume
        plain = spec.with_overrides({"faults.checkpoint_every": 0})
        msgs.append(_message(api, lambda: build(plain).run(
            checkpoint_dir=str(d / "ck2"), resume_engine=True)))
        # resume_from with another spec's checkpoint
        msgs.append(_message(api, lambda: api.build(_spec(
            api, checkpoint_every=TOTAL, seed=9), resume_from=ck,
            **({} if api is japi else {"device": "cpu"}))))
        cases.append([norm(m, d) for m in msgs])
    assert cases[1] == cases[0]
    assert "resume_engine" in cases[1][0] and "no spec.json" in cases[1][1]
    assert "holds snapshots written by" in cases[1][2]
    assert "was written by spec" in cases[1][4]


@pytest.mark.parametrize("strategy", ["fedat", "fedavg", "fedasync"])
def test_resume_covers_every_strategy(tmp_path, strategy):
    """Resume under the full fault surface (blackouts, poison, clipping,
    churn, re-tiering) for each strategy."""
    spec = _spec(blackouts=1, blackout_window=(1.0, 30.0),
                 blackout_duration=15.0, nan_rate=0.3,
                 update_clip=0.3).with_overrides(
        {"strategy.name": strategy, "strategy.kwargs": {},
         "tiers.retier_every": 3})
    first = _build(spec)
    ref = first.run().metrics
    ck = str(tmp_path / "ck")
    _interrupt(spec, ck)
    run = _build(spec)
    res = run.run(checkpoint_dir=ck, resume_engine=True)
    assert _fields(res.metrics) == _fields(ref)
    assert _same_params(run.strategy.global_params(),
                        first.strategy.global_params())


def test_engine_snapshot_manifest_matches_the_reference(tmp_path):
    """The same spec, checkpointed by both packages: the engine snapshot
    at the last step and the final params name the same paths, shapes
    and dtypes (the host state's pickle included)."""
    jck, tck = str(tmp_path / "j"), str(tmp_path / "t")
    japi.build(_spec(japi)).run(checkpoint_dir=jck)
    _build(_spec()).run(checkpoint_dir=tck)
    for sub in (f"engine/step_{TOTAL:010d}", f"engine/step_{TOTAL - 2:010d}",
                f"step_{TOTAL:010d}"):
        a = json.loads(Path(jck, sub, "manifest.json").read_text())
        b = json.loads(Path(tck, sub, "manifest.json").read_text())
        for k in ("paths", "shapes", "dtypes", "step"):
            assert a[k] == b[k], (sub, k)
    # keep=2: the older snapshots were collected, as in the reference
    assert sorted(os.listdir(Path(tck, "engine"))) == sorted(
        os.listdir(Path(jck, "engine")))


def test_a_stale_tmp_step_is_ignored_on_resume(tmp_path):
    """A snapshot write cut by a kill leaves ``step_N.tmp``; the resume
    takes the newest complete step."""
    spec = _spec()
    ref = _build(spec).run().metrics
    ck = str(tmp_path / "ck")
    _interrupt(spec, ck)
    eng = Path(ck, "engine")
    newest = max(p for p in os.listdir(eng) if p.startswith("step_"))
    junk = eng / f"step_{int(newest[5:]) + 2:010d}.tmp"
    junk.mkdir()
    (junk / "shard_0.npz").write_bytes(b"cut short")
    res = _build(spec).run(checkpoint_dir=ck, resume_engine=True)
    assert _fields(res.metrics) == _fields(ref)


def _cli_args(spec_path, ck, out):
    return [sys.executable, "-m", "repro_torch.api.cli", "--device", "cpu",
            "--spec", spec_path, "--checkpoint-dir", ck, "--out", out]


def test_sigkill_mid_run_resumes_to_identical_trajectory(tmp_path):
    spec = _spec()
    ref_hash = _traj_hash(_build(spec).run().metrics)
    spec_path = str(tmp_path / "exp.json")
    Path(spec_path).write_text(spec.to_json())
    ck, out = str(tmp_path / "ck"), str(tmp_path / "out.json")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(_cli_args(spec_path, ck, out), env=env,
                            cwd=ROOT, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    # wait for the first engine snapshot to land, then kill -9
    eng = os.path.join(ck, "engine")
    deadline = time.time() + 180
    while time.time() < deadline and proc.poll() is None:
        if os.path.isdir(eng) and any(p.startswith("step_")
                                      and not p.endswith(".tmp")
                                      for p in os.listdir(eng)):
            break
        time.sleep(0.01)
    # 10 of the 12 updates are still to run at the first snapshot: the
    # kill lands mid-run
    killed = proc.poll() is None
    proc.send_signal(signal.SIGKILL)
    proc.wait()
    assert killed, "the run ended before the kill"
    assert any(p.startswith("step_") for p in os.listdir(eng)), \
        "no engine snapshot appeared before the deadline"
    r = subprocess.run(_cli_args(spec_path, ck, out) + ["--resume"],
                       env=env, cwd=ROOT, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    traj = json.loads(Path(out).read_text())["runs"][0]["trajectory"]
    got = hashlib.sha256(
        json.dumps(traj, sort_keys=True).encode()).hexdigest()
    assert got == ref_hash, \
        "resumed trajectory diverged from the uninterrupted run"
