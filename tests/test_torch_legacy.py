"""The port's convergence bounds (core/theory.py) against the reference's
on hypothesis draws, bitwise; the legacy ``run_*`` wrappers
(core/fedat.py, core/baselines.py) against the port's own engine runs,
bitwise; and ``python -m repro_torch.launch.sim``."""
import importlib
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _hypothesis import given, settings, st

from repro.core import theory as jtheory
from repro_torch.core import baselines as tbaselines
from repro_torch.core import fedat as tfedat
from repro_torch.core import strategies as tstrategies
from repro_torch.core import theory as ttheory
from repro_torch.core.engine import EngineConfig, run_engine
from repro_torch.core.simulation import SimConfig, SimEnv

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _same(a, b):
    return a == b or (isinstance(a, float) and math.isnan(a)
                      and math.isnan(b))


_pos = st.floats(1e-3, 10.0, allow_nan=False, allow_infinity=False)


@given(mu=_pos, L=_pos, eta=_pos, sigma=_pos, gamma=_pos, G=_pos,
       c=st.integers(1, 50), B=st.floats(1e-3, 1.0),
       T=st.integers(0, 200), gap=_pos)
@settings(max_examples=60, deadline=None)
def test_theorem_bounds_are_bitwise_the_reference(mu, L, eta, sigma, gamma,
                                                  G, c, B, T, gap):
    kw = dict(mu=mu, L=L, eta=eta, sigma=sigma, gamma=gamma, G=G, c=c)
    jr, tr = jtheory.Regime(**kw), ttheory.Regime(**kw)
    for fn, args in (("contraction_factor", (B,)), ("error_floor", (B,)),
                     ("convex_bound", (B, T, gap)),
                     ("nonconvex_bound", (B, T, gap)),
                     ("max_stable_eta", (B,))):
        assert _same(getattr(ttheory, fn)(tr, *args),
                     getattr(jtheory, fn)(jr, *args)), fn


@given(counts=st.lists(st.integers(0, 100), min_size=2, max_size=6),
       T=st.integers(0, 30))
@settings(max_examples=40, deadline=None)
def test_eq3_weights_and_bound_curve_are_bitwise(counts, T):
    for m in range(len(counts)):
        assert ttheory.eq3_weight(counts, m) == jtheory.eq3_weight(counts, m)
    r = ttheory.Regime(gamma=0.1, c=2)
    jr = jtheory.Regime(gamma=0.1, c=2)
    assert ttheory.bound_curve(r, counts, T) == jtheory.bound_curve(
        jr, counts, T)


def test_regime_defaults_match():
    assert ttheory.Regime() == ttheory.Regime(**vars(jtheory.Regime()))


SCENARIO = dict(n_clients=12, n_tiers=3, samples_per_client=20,
                image_hw=8, clients_per_round=4, n_unstable=2,
                local_epochs=1)


@pytest.fixture(scope="module")
def env():
    return SimEnv(SimConfig(**SCENARIO), device="cpu")


def _same_run(m, strategy, m2, strategy2):
    for f in ("times", "rounds", "acc", "acc_var", "bytes_up", "bytes_down"):
        assert getattr(m, f) == getattr(m2, f), f
    a, b = strategy.global_params(), strategy2.global_params()
    assert all(torch.equal(a[k], b[k]) for k in a)


def _capture(monkeypatch):
    """Record the strategy each wrapper's engine run binds."""
    # the module (the package's ``build`` attribute is the function)
    tbuild = importlib.import_module("repro_torch.api.build")
    seen = []
    orig = tbuild.run_engine

    def spy(env_, strategy, cfg, **kw):
        seen.append(strategy)
        return orig(env_, strategy, cfg, **kw)
    monkeypatch.setattr(tbuild, "run_engine", spy)
    return seen


@pytest.mark.parametrize("fc", [
    dict(total_updates=4, eval_every=2),
    dict(total_updates=3, eval_every=1, precision=None, weighted=False,
         use_prox=False, seed=5),
    dict(total_updates=3, eval_every=3, codec="quantize8"),
])
def test_run_fedat_is_the_engine_run(env, fc, monkeypatch):
    seen = _capture(monkeypatch)
    m = tfedat.run_fedat(env, tfedat.FedATConfig(**fc))
    cfg = tfedat.FedATConfig(**fc)
    s = tstrategies.make_strategy(
        "fedat", precision=cfg.precision, codec=cfg.codec,
        weighted=cfg.weighted, use_prox=cfg.use_prox)
    m2 = run_engine(env, s, EngineConfig(total_updates=cfg.total_updates,
                                         eval_every=cfg.eval_every,
                                         seed=cfg.seed))
    _same_run(m, seen[0], m2, s)


@pytest.mark.parametrize("name", ["fedavg", "tifl", "fedasync"])
def test_baseline_wrappers_are_the_engine_runs(env, name, monkeypatch):
    seen = _capture(monkeypatch)
    bc = tbaselines.BaselineConfig(total_updates=3, eval_every=1, seed=2,
                                   alpha=0.5, staleness_exp=0.7)
    m = getattr(tbaselines, f"run_{name}")(env, bc)
    kw = ({"alpha": 0.5, "staleness_exp": 0.7} if name == "fedasync"
          else {})
    s = tstrategies.make_strategy(name, **kw)
    m2 = run_engine(env, s, EngineConfig(total_updates=3, eval_every=1,
                                         seed=2))
    _same_run(m, seen[0], m2, s)


def test_codec_helpers(env):
    p = {k: v * 1.23456789 for k, v in env.params0.items()}
    out = tfedat.fake_polyline(p, 2)
    assert all(torch.equal(out[k], torch.round(p[k] * 100.0) * float(
        np.float32(0.01))) for k in p)
    assert tfedat.fake_polyline(p, None) is p
    assert tfedat.measure_ratio(p, None) == 1.0
    assert 0 < tfedat.measure_ratio(p, 4) < 1.0


def test_launch_sim_runs_the_spec_cli(tmp_path):
    out = tmp_path / "runs.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    args = [sys.executable, "-m", "repro_torch.launch.sim", "--device",
            "cpu"]
    for k, v in (("data.n_clients", 8), ("data.samples_per_client", 20),
                 ("data.image_hw", 8), ("tiers.n_tiers", 2),
                 ("tiers.clients_per_round", 2), ("tiers.n_unstable", 0),
                 ("engine.local_epochs", 1), ("engine.total_updates", 2),
                 ("engine.eval_every", 1)):
        args += ["--set", f"{k}={v}"]
    r = subprocess.run(args + ["--out", str(out)], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "(single run)" in r.stdout and out.exists()
