"""The port's checkpoint manager, guarded runner and trainer entry point
against the JAX reference's (repro/checkpoint, repro/runtime/fault.py,
repro/launch/train.py).

The same train state (params, AdamW ``{m, v, count}``, ``step``) written
by both managers must give equal manifest ``paths``, ``shapes``,
``dtypes`` and ``hash`` (``treedef`` is each package's own token), and
each manager must restore the other's checkpoint.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCkpt
from repro.configs.registry import get_smoke_config as jsmoke
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import CheckpointManager as TCkpt
from repro_torch.checkpoint import read_sidecar, write_sidecar
from repro_torch.launch import train as ttrain
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.runtime.fault import GuardedRunner, StragglerStats

torch.set_num_threads(1)


def _ref_state():
    cfg = jsmoke("qwen2-7b")
    params = jlm.init_params(cfg, jax.random.PRNGKey(0), 1, jnp.float32)
    opt = jadamw(1e-3).init(params)
    opt["count"] = jnp.int32(3)
    return {"params": params, "opt": opt, "step": jnp.int32(3)}


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:010d}", "manifest.json")) as f:
        return json.load(f)


def _equal(a, b):
    if isinstance(a, dict):
        return sorted(a) == sorted(b) and all(_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def test_manifests_match_reference(tmp_path):
    js = _ref_state()
    ts = params_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    JCkpt(jd).save(3, js, blocking=True)
    TCkpt(td).save(3, ts, blocking=True)
    jm, tm = _manifest(jd, 3), _manifest(td, 3)
    for key in ("step", "paths", "shapes", "dtypes", "hash", "n_processes"):
        assert jm[key] == tm[key], key
    assert "['opt']['m']['embed']" in tm["paths"]
    assert sorted(os.listdir(os.path.join(td, "step_0000000003"))) == [
        "manifest.json", "shard_0.npz"]


def test_restore_round_trips_and_reads_the_reference(tmp_path):
    js = _ref_state()
    ts = params_from_numpy(jax.tree.map(np.asarray, js), device="cpu")
    like = jax.tree.map(lambda a: torch.zeros_like(a), ts)
    mgr = TCkpt(str(tmp_path / "t"))
    mgr.save(3, ts)                      # async
    mgr.wait()
    got, step = mgr.restore(like)
    assert step == 3 and _equal(got, ts)
    assert got["step"].dtype == torch.int32
    jd = str(tmp_path / "j")
    JCkpt(jd).save(5, js, blocking=True)
    got, step = TCkpt(jd).restore(like)
    assert step == 5 and _equal(got, ts)
    back, _ = JCkpt(str(tmp_path / "t")).restore(js)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_keep_collects_old_steps_and_corruption_falls_back(tmp_path):
    mgr = TCkpt(str(tmp_path), keep=2)
    state = {"w": torch.arange(4.0), "step": torch.tensor(0)}
    for s in (1, 2, 3, 4):
        state = {"w": state["w"] + 1, "step": torch.tensor(s)}
        mgr.save(s, state)
    mgr.wait()
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    # corrupt step 4's payload: restore falls back to step 3
    npz = os.path.join(str(tmp_path), "step_0000000004", "shard_0.npz")
    with np.load(npz) as d:
        arrays = {k: d[k] for k in d.files}
    arrays["a1"] = arrays["a1"] + 1
    np.savez(npz, **arrays)
    got, step = mgr.restore(state)
    assert step == 3 and int(got["step"]) == 3
    with pytest.raises(FileNotFoundError):
        TCkpt(str(tmp_path / "empty")).restore(state)


def test_sidecar_round_trip(tmp_path):
    write_sidecar(str(tmp_path), {"spec_hash": "abc"})
    assert read_sidecar(str(tmp_path)) == {"spec_hash": "abc"}
    with pytest.raises(FileNotFoundError):
        read_sidecar(str(tmp_path / "none"))


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def test_guarded_runner_restores_after_injected_failure(tmp_path):
    """A step that fails once is retried from the last checkpoint with
    the injected sleep; the run ends where a clean run ends."""
    calls = {"n": 0}

    def step_fn(state, batch):
        calls["n"] += 1
        if calls["n"] == 4:
            raise RuntimeError("simulated kernel fault")
        return {"w": state["w"] + batch}, {"loss": float(state["w"].sum())}

    sleeps = []
    mgr = TCkpt(str(tmp_path), keep=3)
    runner = GuardedRunner(step_fn, mgr, ckpt_every=2, max_retries=2,
                           sleep=sleeps.append, clock=_Clock())
    state, end = runner.run({"w": torch.zeros(3)}, iter(lambda: 1.0, None), 5)
    assert end == 5 and torch.equal(state["w"], torch.full((3,), 5.0))
    assert runner.stats["failures"] == 1 and runner.stats["restores"] == 1
    assert sleeps == [0.1]
    assert mgr.latest_step() == 5


def test_guarded_runner_reraises_past_max_retries(tmp_path):
    def step_fn(state, batch):
        raise RuntimeError("always")
    runner = GuardedRunner(step_fn, TCkpt(str(tmp_path)), max_retries=1,
                           sleep=lambda s: None, clock=_Clock())
    with pytest.raises(RuntimeError, match="always"):
        runner.run({"w": torch.zeros(1)}, iter(lambda: 0, None), 3)
    assert runner.stats["failures"] == 2


def test_guarded_runner_with_ckpt_every_0_writes_no_checkpoint(tmp_path):
    """ckpt_every=0 saves neither a periodic nor the final checkpoint; a
    failed step is still retried (from the current state: none exists)."""
    calls = {"n": 0}

    def step_fn(state, batch):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated kernel fault")
        return {"w": state["w"] + batch}, {"loss": float(state["w"].sum())}

    mgr = TCkpt(str(tmp_path), keep=3)
    runner = GuardedRunner(step_fn, mgr, ckpt_every=0, max_retries=1,
                           sleep=lambda s: None, clock=_Clock())
    state, end = runner.run({"w": torch.zeros(2)}, iter(lambda: 1.0, None), 3)
    assert end == 3 and torch.equal(state["w"], torch.full((2,), 3.0))
    assert runner.stats["failures"] == 1 and runner.stats["restores"] == 0
    assert mgr.latest_step() is None and os.listdir(tmp_path) == []


def test_trainer_with_ckpt_every_0_times_each_step(tmp_path):
    ck = tmp_path / "ck"
    res = ttrain.run(ttrain.parser().parse_args(
        ["--smoke", "--device", "cpu", "--steps", "2", "--ckpt-dir",
         str(ck), "--ckpt-every", "0"]))
    assert res.end_step == 2 and list(ck.iterdir()) == []
    assert len(res.step_seconds) == len(res.batch_seconds) == 2
    assert all(t > 0 for t in res.step_seconds + res.batch_seconds)
    assert sum(res.step_seconds) + sum(res.batch_seconds) <= res.seconds


def test_straggler_stats_flag_slow_steps():
    st = StragglerStats(window=16, threshold=2.0)
    flags = [st.observe(1.0) for _ in range(10)] + [st.observe(5.0)]
    assert flags[-1] and not any(flags[:-1]) and st.flags == 1
    assert st.median == 1.0


def test_trainer_smoke_runs_on_cpu_and_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    a = ttrain.run(ttrain.parser().parse_args(
        ["--smoke", "--device", "cpu", "--steps", "3", "--ckpt-dir", ck,
         "--ckpt-every", "2"]))
    assert a.end_step == 3 and len(a.losses) == 3
    assert all(np.isfinite(a.losses)) and a.runner_stats["failures"] == 0
    assert TCkpt(ck).all_steps() == [2, 3]
    # lose step 3's checkpoint: --resume repeats step 3 from step 2
    import shutil
    shutil.rmtree(os.path.join(ck, "step_0000000003"))
    b = ttrain.run(ttrain.parser().parse_args(
        ["--smoke", "--device", "cpu", "--steps", "3", "--ckpt-dir", ck,
         "--resume"]))
    assert b.start_step == 2 and len(b.losses) == 1
    assert b.losses[0] == a.losses[2]
    pa = params_to_numpy(a.state["params"])
    pb = params_to_numpy(b.state["params"])
    for x, y in zip(jax.tree.leaves(pa), jax.tree.leaves(pb)):
        assert np.array_equal(x, y)


def test_trainer_cli_main_and_unported_flags(tmp_path):
    losses = ttrain.main(["--smoke", "--device", "cpu", "--steps", "2",
                          "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 2
    for flag in (["--multi-pod"], ["--codec", "quantize8"]):
        with pytest.raises(NotImplementedError, match="A16"):
            ttrain.main(["--smoke", "--device", "cpu", "--steps", "1",
                         "--ckpt-dir", str(tmp_path)] + flag)
