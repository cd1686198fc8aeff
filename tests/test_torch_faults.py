"""The port's fault plane against the JAX reference: the churn, blackout
and poison streams (core/faults.py), the elastic Eq. 3 moves
(runtime/elastic.py), the update gate (core/steps.py), faulted FedAT and
FedAvg runs end to end, and the zero-fault contract.

Both packages get the same numpy inputs.  The fault streams, the
schedules and the Eq. 3 weights are numpy in both, so they must match
bitwise; so must every host-side record of a faulted run (event times,
rounds, byte ledgers, which rounds were poisoned, blackout and return
handling, update counts, ``tier_alive``).  The gate runs as torch ops on
the K-stacked client dict: its masks and weights are exact, its clipped
deltas match within 1e-6 relative (the clip norm sums in another order).

The faulted runs start from the reference's ``params0`` with its
permutations, like tests/test_torch_engine.py, and their final global
models are held within FAULTED_RTOL, each bound beside the port's
measured value and the reference's own spread (the reference against
itself from a ``params0`` changed by 1e-7 relative, over the same 6
updates, on the CPU).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import faults as jfaults
from repro.core import steps as jsteps
from repro.core import strategies as jstrategies
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.engine import run_engine as jrun_engine
from repro.core.simulation import SimConfig as JSimConfig
from repro.core.simulation import SimEnv as JSimEnv
from repro.runtime import elastic as jelastic
from repro_torch import api as tapi
from repro_torch.core import faults as tfaults
from repro_torch.core import steps as tsteps
from repro_torch.core import strategies as tstrategies
from repro_torch.core.engine import EngineConfig as TEngineConfig
from repro_torch.core.engine import run_engine as trun_engine
from repro_torch.core.simulation import SimConfig as TSimConfig
from repro_torch.core.simulation import SimEnv as TSimEnv
from repro_torch.runtime import elastic as telastic

from test_torch_engine import _rel, jax_perm_source

torch.set_num_threads(1)

#: tests/test_crash_resume.py's scenario, with churn
SCENARIO = dict(n_clients=8, samples_per_client=24, image_hw=8, n_tiers=2,
                clients_per_round=2, n_unstable=0, local_epochs=1,
                churn_rate=0.5, churn_window=(1.0, 60.0),
                churn_downtime=20.0, fault_seed=4)
#: one blackout that starts (t = 9.96) and ends (t = 15.96) inside the
#: 6 updates' simulated time, poison on half the rounds, a clip that cuts
#: some updates and not others
FAULTS = dict(blackouts=1, blackout_window=(1.0, 10.0),
              blackout_duration=6.0, nan_rate=0.5, update_clip=0.3, seed=4)
UPDATES = 6
#: relative L2 of the final global model to the reference's
FAULTED_RTOL = {
    ("fedat", "none"): 1e-4,        # measured 1.1e-5; reference 1.2e-5
    ("fedat", "quantize8"): 1e-2,   # measured 5.2e-8; reference 1.5e-3
    ("fedavg", "none"): 1e-5,       # measured 3.5e-7; reference 1.4e-7
    ("fedavg", "quantize8"): 2e-2,  # measured 6.7e-8; reference 6.5e-3
}


def _np(tree):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in tree.items()}


def _flat(tree):
    return np.concatenate([_np(tree)[k].ravel() for k in sorted(tree)])


# ---------------------------------------------------------------------------
# streams and schedules, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [
    (8, 0.0, 2, 30.0, (50.0, 400.0), 0),
    (8, 0.5, 0, 30.0, (50.0, 400.0), 0),
    (64, 0.5, 3, 30.0, (50.0, 400.0), 1),
    (100, 0.1, 2, 30.0, (1.0, 120.0), 7),
    (12, 1.0, 4, 5.0, (0.0, 10.0), 3),
])
def test_churn_schedule_is_bitwise_the_reference(args):
    j, t = jfaults.churn_schedule(*args), tfaults.churn_schedule(*args)
    if j is None:
        assert t is None
        return
    for a, b in zip(j, t):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_stream_tags_and_markers_match():
    for name in ("CHURN_STREAM", "EVENT_STREAM", "BLACKOUT", "RETURN"):
        assert getattr(tfaults, name) == getattr(jfaults, name)
    for actor in ((jfaults.BLACKOUT, 1, 20.0), (jfaults.RETURN, 0),
                  (0, np.arange(3)), (3, 0), 5):
        assert (tfaults.is_fault_event(actor)
                == jfaults.is_fault_event(actor))
    assert ({f.name for f in dataclasses.fields(tfaults.FaultConfig)}
            == {f.name for f in dataclasses.fields(jfaults.FaultConfig)})
    for kw in ({}, {"checkpoint_every": 5}, {"blackouts": 1},
               {"nan_rate": 0.1}, {"update_clip": 1.0}):
        j, t = jfaults.FaultConfig(**kw), tfaults.FaultConfig(**kw)
        assert (t.active, t.injects_faults) == (j.active, j.injects_faults)


@pytest.mark.parametrize("seed,n_tiers", [(0, 2), (7, 4), (11, 5)])
def test_blackout_schedule_and_poison_draws_are_bitwise(seed, n_tiers):
    kw = dict(blackouts=3, blackout_window=(10.0, 100.0),
              blackout_duration=20.0, nan_rate=0.4, seed=seed)
    jp = jfaults.FaultPlane(jfaults.FaultConfig(**kw), n_tiers)
    tp = tfaults.FaultPlane(tfaults.FaultConfig(**kw), n_tiers)
    assert tp.blackout_events == jp.blackout_events
    for n_live, k in [(3, 4), (1, 4), (0, 4), (10, 10)] * 10:
        assert np.array_equal(tp.draw_poison(n_live, k),
                              jp.draw_poison(n_live, k))
    # the stream position round-trips like the reference's
    assert tp.state() == jp.state()
    tp2 = tfaults.FaultPlane(tfaults.FaultConfig(**kw), n_tiers)
    tp2.set_state(tp.state())
    assert np.array_equal(tp2.draw_poison(5, 6), jp.draw_poison(5, 6))
    assert isinstance(tp.gate, tsteps.UpdateGate)
    assert tp.gate.clip_norm == jp.gate.clip_norm
    assert tfaults.FaultPlane(tfaults.FaultConfig(blackouts=1), 2).gate \
        is None


def test_masked_cross_weights_are_bitwise():
    rng = np.random.default_rng(0)
    for _ in range(50):
        m = int(rng.integers(1, 7))
        counts = rng.integers(0, 20, m).astype(np.int64)
        alive = rng.random(m) < 0.6
        a = jelastic.masked_cross_weights(counts, alive)
        b = telastic.masked_cross_weights(counts, alive)
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


def test_env_alive_applies_churn_like_the_reference():
    kw = dict(n_clients=12, n_tiers=3, samples_per_client=20, image_hw=8,
              clients_per_round=4, churn_rate=0.6, churn_events=2,
              churn_downtime=15.0, churn_window=(5.0, 60.0), fault_seed=2)
    jenv = JSimEnv(JSimConfig(**kw))
    tenv = TSimEnv(TSimConfig(**kw), device="cpu")
    for a, b in zip(jenv.churn_down, tenv.churn_down):
        assert np.array_equal(a, b)
    for now in np.linspace(0.0, 120.0, 241):
        assert np.array_equal(jenv.alive(now), tenv.alive(now))
    assert not tenv.alive(float(tenv.churn_down[0][np.isfinite(
        tenv.churn_down[0])].min()) + 1e-6).all()
    # churn off: no schedule, the exact permanent-dropout compare
    off = TSimEnv(TSimConfig(**dict(kw, churn_rate=0.0)), device="cpu")
    assert off.churn_down is None
    assert np.array_equal(off.alive(30.0), off.dropout_at > 30.0)


# ---------------------------------------------------------------------------
# the update gate and the elastic moves, same inputs
# ---------------------------------------------------------------------------

def _gate_inputs(seed, k=5, nan_rows=(1,), inf_rows=()):
    rng = np.random.default_rng(seed)
    ref = {"a": rng.normal(size=(3, 4)).astype(np.float32),
           "b": rng.normal(size=(7,)).astype(np.float32)}
    cp = {n: (v[None] + rng.normal(scale=0.5, size=(k,) + v.shape)
              ).astype(np.float32) for n, v in ref.items()}
    for r in nan_rows:
        cp["a"][r, 0, 1] = np.nan
    for r in inf_rows:
        cp["b"][r, 2] = np.inf
    w = rng.random(k).astype(np.float32)
    w[-1] = 0.0                               # a padding slot
    return cp, w, ref


@pytest.mark.parametrize("clip", [0.0, 0.5, 3.0, 100.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_gate_matches_reference(seed, clip):
    cp, w, ref = _gate_inputs(seed, nan_rows=(1,), inf_rows=(3,))
    jc, jw, jok = jsteps.gate_updates(
        jax.tree.map(jnp.asarray, cp), jnp.asarray(w),
        jax.tree.map(jnp.asarray, ref), clip)
    tc, tw, tok = tsteps.gate_updates(
        {k: torch.from_numpy(v) for k, v in cp.items()}, torch.from_numpy(w),
        {k: torch.from_numpy(v) for k, v in ref.items()}, clip)
    assert tok.dtype == torch.bool and tok.dim() == 0
    assert bool(tok) == bool(jok)
    # non-finite clients weigh exactly 0, survivors renormalize to 1
    assert tw[1] == 0 and tw[3] == 0
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=0)
    assert np.array_equal(tw.numpy() == 0, np.asarray(jw) == 0)
    for k in cp:
        got, want = tc[k].numpy(), np.asarray(jc[k])
        assert np.isfinite(got).all()
        assert np.array_equal(got[1], ref[k]) or clip > 0
        d_got = (got - ref[k][None]).reshape(len(w), -1)
        d_want = (want - ref[k][None]).reshape(len(w), -1)
        for r in range(len(w)):
            assert np.linalg.norm(d_got[r] - d_want[r]) <= 1e-6 * max(
                np.linalg.norm(d_want[r]), 1e-30)
    if clip:
        norms = np.sqrt(sum(((tc[k].numpy() - ref[k][None]) ** 2).reshape(
            len(w), -1).sum(1) for k in cp))
        assert (norms <= clip * (1 + 1e-6)).all()


def test_gate_all_nan_reports_no_survivors_like_the_reference():
    cp, w, ref = _gate_inputs(3, k=3, nan_rows=(0, 1, 2))
    _, jw, jok = jsteps.gate_updates(
        jax.tree.map(jnp.asarray, cp), jnp.asarray(w),
        jax.tree.map(jnp.asarray, ref), 0.0)
    _, tw, tok = tsteps.gate_updates(
        {k: torch.from_numpy(v) for k, v in cp.items()}, torch.from_numpy(w),
        {k: torch.from_numpy(v) for k, v in ref.items()}, 0.0)
    assert not bool(tok) and not bool(jok)
    assert tw.sum() == 0 and float(np.asarray(jw).sum()) == 0


def test_poison_matches_reference():
    x = np.arange(24, dtype=np.float32).reshape(4, 3, 2)
    n = np.arange(4, dtype=np.int32)
    mask = np.array([False, True, False, True])
    j = jsteps.poison_updates({"w": jnp.asarray(x), "n": jnp.asarray(n)},
                              jnp.asarray(mask))
    t = tsteps.poison_updates({"w": torch.from_numpy(x),
                               "n": torch.from_numpy(n)},
                              torch.from_numpy(mask))
    assert np.array_equal(t["w"].numpy(), np.asarray(j["w"]),
                          equal_nan=True)
    assert np.isnan(t["w"].numpy()[[1, 3]]).all()
    assert t["n"].dtype == torch.int32
    assert np.array_equal(t["n"].numpy(), n)


def test_bootstrap_tier_and_pod_round_trips_match_reference():
    tiers = np.arange(12.0, dtype=np.float32).reshape(3, 4)
    g = np.full(4, -1.0, np.float32)
    j = jelastic.bootstrap_tier({"w": jnp.asarray(tiers)},
                                {"w": jnp.asarray(g)}, 1)
    tt = {"w": torch.from_numpy(tiers.copy())}
    t = telastic.bootstrap_tier(tt, {"w": torch.from_numpy(g)}, 1)
    assert t["w"] is tt["w"]                       # in place, stack dtype
    assert np.array_equal(t["w"].numpy(), np.asarray(j["w"]))

    rng = np.random.default_rng(5)
    state = {"params": {"w": rng.normal(size=(4, 3)).astype(np.float32),
                        "sub": {"b": rng.normal(size=(4, 2)).astype(
                            np.float32)}},
             "opt": {"m": rng.normal(size=(4, 3)).astype(np.float32)},
             "step": np.array([7, 9, 7, 8], np.int32),
             "counts": np.array([1.0, 2.0, 3.0, 4.0], np.float32)}

    def to_t(x):
        return ({k: to_t(v) for k, v in x.items()} if isinstance(x, dict)
                else torch.from_numpy(x))

    def to_np(x):
        if isinstance(x, dict):
            return {k: to_np(v) for k, v in x.items()}
        return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    jg = to_np(jelastic.grow_pods(jelastic.shrink_pods(
        jax.tree.map(jnp.asarray, state), keep=[0, 2, 3]), 2))
    tg = to_np(telastic.grow_pods(telastic.shrink_pods(
        to_t(state), keep=[0, 2, 3]), 2))
    assert jax.tree.structure(jg) == jax.tree.structure(tg)
    for a, b in zip(jax.tree.leaves(jg), jax.tree.leaves(tg)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)
    # the survivors' params come through the round trip bitwise
    assert np.array_equal(tg["params"]["w"][:3],
                          state["params"]["w"][[0, 2, 3]])
    assert np.array_equal(tg["counts"], [1.0, 3.0, 4.0, 0.0, 0.0])
    assert telastic.reshard(to_t(state), "cpu")["params"]["w"].device \
        == torch.device("cpu")


# ---------------------------------------------------------------------------
# faulted runs against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def envs():
    jenv = JSimEnv(JSimConfig(**SCENARIO))
    p0 = jax.tree.map(np.asarray, jenv.params0)
    tenv = TSimEnv(TSimConfig(**SCENARIO), device="cpu", params0=p0)
    tenv.executor().perm_source = jax_perm_source(tenv)
    return jenv, tenv


def _record(env, strategy, method):
    """Log every round call (ids, seed, poison mask) and every fault
    marker the strategy handles, with the strategy's tier state after."""
    log = []
    ex = env.executor()
    orig = getattr(type(ex), method)

    def wrap(*a, **k):
        ids, seed = (a[3], a[4]) if method == "fedat_round" else (a[1], a[2])
        poison = k.get("poison")
        log.append(("round", np.asarray(ids).tolist(), seed,
                    None if poison is None else poison.tolist()))
        return orig(ex, *a, **k)
    setattr(ex, method, wrap)
    on_fault = strategy.on_fault

    def fault(env_, ctx, now, actor):
        out = on_fault(env_, ctx, now, actor)
        alive = getattr(strategy, "tier_alive", None)
        log.append(("fault", now, actor[0], int(actor[1]), out.value,
                    None if alive is None else alive.tolist()))
        return out
    strategy.on_fault = fault
    return log


@pytest.mark.parametrize("codec", ["none", "quantize8"])
@pytest.mark.parametrize("name", ["fedat", "fedavg"])
def test_faulted_run_matches_reference(envs, name, codec):
    jenv, tenv = envs
    method = "fedat_round" if name == "fedat" else "fedavg_round"
    js = jstrategies.make_strategy(name, codec=codec)
    ts = tstrategies.make_strategy(name, codec=codec)
    jlog, tlog = _record(jenv, js, method), _record(tenv, ts, method)
    try:
        jm = jrun_engine(jenv, js, JEngineConfig(
            total_updates=UPDATES, eval_every=2,
            faults=jfaults.FaultConfig(**FAULTS)))
        tm = trun_engine(tenv, ts, TEngineConfig(
            total_updates=UPDATES, eval_every=2,
            faults=tfaults.FaultConfig(**FAULTS)))
    finally:
        delattr(jenv.executor(), method)
        delattr(tenv.executor(), method)
    assert tlog == jlog
    rounds = [e for e in tlog if e[0] == "round"]
    assert len(rounds) == UPDATES
    # every family fired: a poisoned round, a blackout (and, for FedAT, its
    # return), clients churned down during the run (FedAT re-filters a
    # round's clients on completion, so a round shrinks)
    assert any(e[3] is not None and any(e[3]) for e in rounds)
    kinds = [e[2] for e in tlog if e[0] == "fault"]
    assert kinds[:1] == [tfaults.BLACKOUT]
    if name == "fedat":
        assert kinds == [tfaults.BLACKOUT, tfaults.RETURN]
        assert np.array_equal(ts.counts, js.counts)
        assert np.array_equal(ts.tier_alive, js.tier_alive)
        assert any(len(e[1]) < 2 for e in rounds)
    assert any(not tenv.alive(t).all() for t in tm.times)
    assert tm.times == jm.times and tm.rounds == jm.rounds
    assert tm.bytes_up == jm.bytes_up and tm.bytes_down == jm.bytes_down
    assert all(abs(a - b) <= 0.02 + 1e-9 for a, b in zip(tm.acc, jm.acc))
    jw, tw = _flat(js.global_params()), _flat(ts.global_params())
    assert np.isfinite(tw).all()
    assert _rel(tw, jw) < FAULTED_RTOL[name, codec]


def test_gated_round_keeps_the_slot_when_no_client_survives(envs):
    """Every live slot poisoned: any_ok is False, the tier slot and the
    FedAvg model keep their previous values exactly."""
    _, tenv = envs
    ex = tenv.executor()
    codec = tstrategies.make_strategy("fedat", codec="none").codec
    gate = tsteps.UpdateGate(clip_norm=0.0)
    tiers = {k: torch.stack([v] * 2) for k, v in tenv.params0.items()}
    before = {k: v.clone() for k, v in tiers.items()}
    w = {k: v.clone() for k, v in tenv.params0.items()}
    _, tiers = ex.fedat_round(w, tiers, 1, np.array([2, 3]), 5, codec=codec,
                              use_prox=True,
                              cross_weights=np.array([0.5, 0.5], np.float32),
                              gate=gate, poison=np.array([True, True]))
    for k in tiers:
        assert torch.equal(tiers[k], before[k])
    w2 = ex.fedavg_round(w, np.array([2]), 5, gate=gate,
                         poison=np.array([True, False]))
    for k in w:
        assert torch.equal(w2[k], w[k])


# ---------------------------------------------------------------------------
# the zero-fault contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["fedat", "fedavg", "fedasync"])
def test_zero_fault_spec_is_bitwise_the_plain_engine(envs, name):
    """A defaulted faults section builds no FaultPlane (``cfg.faults`` is
    None, ``churn_down`` None); a checkpoint cadence alone activates the
    config without injecting anything.  All three give the plain
    engine's run bitwise."""
    _, tenv = envs
    spec = tapi.ExperimentSpec.from_sim_config(
        TSimConfig(**dict(SCENARIO, churn_rate=0.0))).with_overrides(
        {"strategy.name": name, "engine.total_updates": 4,
         "engine.eval_every": 2})
    plain_env = TSimEnv(spec.to_sim_config(), device="cpu",
                        params0=tenv.params0)
    plain_env.executor().perm_source = jax_perm_source(plain_env)
    run = tapi.build(spec, env=plain_env)
    assert run.cfg.faults is None and plain_env.churn_down is None
    out = [run.run()]
    s = tstrategies.make_strategy(name)
    m = trun_engine(plain_env, s, TEngineConfig(total_updates=4,
                                                eval_every=2))
    ckpt_only = tapi.build(spec.with_overrides(
        {"faults.checkpoint_every": 2}), env=plain_env)
    assert not ckpt_only.cfg.faults.injects_faults
    out.append(ckpt_only.run())
    for res, strat in zip(out, (run.strategy, ckpt_only.strategy)):
        for f in ("times", "rounds", "acc", "acc_var", "bytes_up",
                  "bytes_down"):
            assert getattr(res.metrics, f) == getattr(m, f)
        a, b = strat.global_params(), s.global_params()
        assert all(torch.equal(a[k], b[k]) for k in a)
