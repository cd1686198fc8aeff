"""The port's slice end to end against the JAX reference: SimEnv, the
event engine and its strategies, and the FedAT round (Algorithm 1) with
the ``none``, ``quantize8`` and ``polyline:4`` links, and the baselines'
round bodies (FedAvg, TiFL, FedAsync) under ``none`` and ``quantize8``.

Both packages build the same scenario; the port starts from the
reference's ``params0`` and draws the reference's own permutations (its
``draw_seed`` -> key split -> ``jax.random.permutation`` path), so the only
differences left are fp32 rounding orders.  Host-side state (partitions,
tier maps, event times, commit order, byte ledgers) must match bitwise.

Tolerances, relative L2 of the difference to the parameters' norm:
``none`` 1e-5 (fp32 sums in another order, through 8 local Adam steps per
client); ``quantize8`` 1e-3 (a value within rounding noise of a code
boundary can land on the neighbouring code, a step of max|block|/127; a
flip rate of ~0.1% of codes stays under the bound).  Measured on the CPU:
1.7e-6 and 2.0e-5 for the tier models.  ``polyline:4`` and the baselines
have their own bounds, each with its reason (RTOL, BASELINE_RTOL); every
trajectory runs 4 updates, because the reference's own trajectories are
chaotic at ulp scale (a 1e-7 change in params0 moves its FedAvg result by
9.6e-4 after 8 updates).  Accuracy: within 0.02.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import strategies as jstrategies
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.engine import run_engine as jrun_engine
from repro.core.simulation import SimConfig as JSimConfig
from repro.core.simulation import SimEnv as JSimEnv
from repro_torch.core import strategies as tstrategies
from repro_torch.core.engine import EngineConfig as TEngineConfig
from repro_torch.core.engine import run_engine as trun_engine
from repro_torch.core.population import \
    PopulationConfig as TPopulationConfig
from repro_torch.core.simulation import SimConfig as TSimConfig
from repro_torch.core.simulation import SimEnv as TSimEnv
from repro_torch.core.topology import TopologyConfig as TTopologyConfig

torch.set_num_threads(1)

SCENARIO = dict(n_clients=12, n_tiers=3, samples_per_client=40,
                classes_per_client=2, image_hw=8, clients_per_round=4,
                local_epochs=2, n_unstable=2,
                # narrow bands: every tier commits within 4 updates, so
                # Eq. 3 mixes trained tier models into w_global
                delay_bands=((0.0, 0.0), (0.0, 0.5), (0.5, 1.0)))
RTOL = {"none": 1e-5, "quantize8": 1e-3,
        # polyline:4 rounds to 1e-4: a value within rounding noise of a
        # half-step lands on the neighbouring step.  Measured 3.8e-6
        # (tier models 6.3e-6); the reference moves itself 5.3e-5 from a
        # params0 changed by 1e-7 relative
        "polyline:4": 5e-5}
#: the baselines after 4 updates, relative L2 to the reference's global
#: model.  Measured on the CPU beside the reference's own spread (the
#: reference against itself from a params0 changed by 1e-7 relative, about
#: one fp32 ulp, over the same 4 updates).  With raw links the port's
#: rounding differs at every op of every local step, not once in params0,
#: so it sits above that spread; with quantize8 one code flip moves a
#: block by max|block|/127 and the trajectory amplifies it, so the bound
#: is the reference's own spread, which a flip on another CPU may reach.
BASELINE_RTOL = {
    ("fedavg", "none"): 1e-4,       # measured 2.0e-5; reference 1.2e-6
    ("fedavg", "quantize8"): 2e-2,  # measured 1.8e-3; reference 1.5e-2
    ("tifl", "none"): 3e-5,         # measured 5.7e-6; reference 3.5e-7
    ("tifl", "quantize8"): 2e-2,    # measured 6.3e-3; reference 1.6e-2
    ("fedasync", "none"): 1e-5,     # measured 1.0e-6; reference 1.3e-7
    ("fedasync", "quantize8"): 1e-2,  # measured 7.2e-8; reference 5.6e-3
}
ACC_TOL = 0.02 + 1e-9


def jax_perm_source(env):
    """The reference's permutations for an event: split the draw_seed key
    to the live count, pad with zero keys, split each per epoch and
    permute the sample slots (repro/core/executor.py:_pad_keys ->
    repro/core/clients.py)."""
    E = env.sc.local_epochs
    cap = env.client_cap

    def source(seed, n_live, n_slots):
        keys = jax.random.split(jax.random.PRNGKey(seed), n_live)
        if n_live < n_slots:
            keys = jnp.concatenate(
                [keys, jnp.zeros((n_slots - n_live,) + keys.shape[1:],
                                 keys.dtype)])
        return torch.from_numpy(np.stack([
            np.stack([np.asarray(jax.random.permutation(r, cap))
                      for r in jax.random.split(k, E)])
            for k in keys]).astype(np.int64))
    return source


@pytest.fixture(scope="module")
def envs():
    jenv = JSimEnv(JSimConfig(**SCENARIO))
    p0 = jax.tree.map(np.asarray, jenv.params0)
    tenv = TSimEnv(TSimConfig(**SCENARIO), device="cpu", params0=p0)
    tenv.executor().perm_source = jax_perm_source(tenv)
    return jenv, tenv


def _flat(tree):
    return np.concatenate([np.asarray(tree[k]).ravel() if not
                           isinstance(tree[k], torch.Tensor) else
                           tree[k].numpy().ravel() for k in sorted(tree)])


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_environment_matches_reference_bitwise(envs):
    jenv, tenv = envs
    for k in ("x", "y", "mask", "n_samples"):
        assert np.array_equal(jenv.train[k], tenv.train[k])
    for k in ("x", "y", "mask"):
        assert np.array_equal(jenv.test[k], tenv.test[k])
        assert tenv.train_dev[k].device.type == "cpu"
    assert np.array_equal(jenv.tm.tier_of, tenv.tm.tier_of)
    assert np.array_equal(jenv.tm.latencies, tenv.tm.latencies)
    assert all(np.array_equal(a, b)
               for a, b in zip(jenv.tm.members, tenv.tm.members))
    assert np.array_equal(jenv.dropout_at, tenv.dropout_at)
    assert jenv.model_bytes == tenv.model_bytes
    for now in (0.0, 60.0, 500.0):
        assert np.array_equal(jenv.alive(now), tenv.alive(now))


def _logged(env, method):
    """Record (positional args 2..) of every executor round call."""
    log = []
    ex = env.executor()
    orig = getattr(type(ex), method)

    def wrap(*a, **k):
        log.append(tuple(np.asarray(v).tolist() if isinstance(v, np.ndarray)
                         else v for v in a[2:5]))
        return orig(ex, *a, **k)
    setattr(ex, method, wrap)
    return log


@pytest.mark.parametrize("codec", ["none", "quantize8", "polyline:4"])
def test_fedat_slice_matches_reference(envs, codec):
    jenv, tenv = envs
    jlog = _logged(jenv, "fedat_round")
    tlog = _logged(tenv, "fedat_round")
    try:
        js = jstrategies.make_strategy("fedat", codec=codec)
        ts = tstrategies.make_strategy("fedat", codec=codec)
        jm = jrun_engine(jenv, js, JEngineConfig(total_updates=4,
                                                 eval_every=2))
        tm = trun_engine(tenv, ts, TEngineConfig(total_updates=4,
                                                 eval_every=2))
    finally:
        del jenv.executor().fedat_round, tenv.executor().fedat_round
    # event trace: (tier, live ids, draw seed) per commit, in order
    assert tlog == jlog and len(tlog) == 4
    assert {e[0] for e in tlog} == {0, 1, 2}
    assert tm.times == jm.times and tm.rounds == jm.rounds
    assert tm.bytes_up == jm.bytes_up and tm.bytes_down == jm.bytes_down
    assert np.array_equal(ts.counts, js.counts)
    assert all(abs(a - b) <= ACC_TOL for a, b in zip(tm.acc, jm.acc))
    w0 = _flat(jax.tree.map(np.asarray, jenv.params0))
    jw, tw = _flat(js.w_global), _flat(ts.w_global)
    assert np.linalg.norm(jw - w0) > 0           # the global model moved
    assert _rel(tw, jw) < RTOL[codec]
    assert _rel(_flat(ts.tier_models), _flat(js.tier_models)) < RTOL[codec]


@pytest.mark.parametrize("codec", ["none", "quantize8"])
@pytest.mark.parametrize("name", ["fedavg", "tifl", "fedasync"])
def test_baseline_round_bodies_match_reference(envs, name, codec):
    """FedAvg, TiFL and FedAsync train for 4 updates from the reference's
    params0 with its permutations: the event trace and byte ledger are
    equal, the global model within the strategy's bound
    (BASELINE_RTOL)."""
    jenv, tenv = envs
    method = "fedasync_round" if name == "fedasync" else "fedavg_round"
    jlog, tlog = _logged(jenv, method), _logged(tenv, method)
    try:
        js = jstrategies.make_strategy(name, codec=codec)
        ts = tstrategies.make_strategy(name, codec=codec)
        jm = jrun_engine(jenv, js, JEngineConfig(total_updates=4,
                                                 eval_every=2))
        tm = trun_engine(tenv, ts, TEngineConfig(total_updates=4,
                                                 eval_every=2))
    finally:
        delattr(jenv.executor(), method)
        delattr(tenv.executor(), method)
    assert tlog == jlog and len(tlog) == 4
    assert tm.times == jm.times and tm.rounds == jm.rounds
    assert tm.bytes_up == jm.bytes_up and tm.bytes_down == jm.bytes_down
    assert all(abs(a - b) <= ACC_TOL for a, b in zip(tm.acc, jm.acc))
    w0 = _flat(jax.tree.map(np.asarray, jenv.params0))
    jw, tw = _flat(js.global_params()), _flat(ts.global_params())
    assert np.linalg.norm(jw - w0) > 0           # the global model moved
    assert _rel(tw, jw) < BASELINE_RTOL[name, codec]


@pytest.mark.parametrize("codec", [None, "quantize8"])
@pytest.mark.parametrize("name", ["fedat", "fedavg", "tifl", "fedasync"])
def test_event_trace_matches_reference(envs, name, codec, monkeypatch):
    """Every strategy's rng draw order, event times and byte ledger,
    with the round bodies replaced by identities (the host-side half of
    the engine, without training)."""
    jenv, tenv = envs
    logs = []
    for env in (jenv, tenv):
        log = []
        ex = env.executor()

        def fedat(w, tiers, m, ids, seed, log=log, **k):
            log.append(("fedat", m, list(ids), seed))
            return w, tiers

        def fedavg(w, ids, seed, log=log, **k):
            log.append(("fedavg", list(ids), seed))
            return w

        def fedasync(w, c, a, seed, log=log, **k):
            log.append(("fedasync", c, float(a), seed))
            return w
        monkeypatch.setattr(ex, "fedat_round", fedat, raising=False)
        monkeypatch.setattr(ex, "fedavg_round", fedavg, raising=False)
        monkeypatch.setattr(ex, "fedasync_round", fedasync, raising=False)
        logs.append(log)
    kw = {} if codec is None else {"codec": codec}
    jm = jrun_engine(jenv, jstrategies.make_strategy(name, **kw),
                     JEngineConfig(total_updates=12, eval_every=4,
                                   retier_every=5))
    tm = trun_engine(tenv, tstrategies.make_strategy(name, **kw),
                     TEngineConfig(total_updates=12, eval_every=4,
                                   retier_every=5))
    assert logs[0] == logs[1] and len(logs[1]) >= 12
    assert tm.times == jm.times and tm.rounds == jm.rounds
    assert tm.bytes_up == jm.bytes_up and tm.bytes_down == jm.bytes_down
    assert all(abs(a - b) <= ACC_TOL for a, b in zip(tm.acc, jm.acc))


def test_padded_slots_are_exactly_neutral(envs):
    """A 2-client sample padded to K=4 slots gives the tier model of the
    2 live clients alone (zero Eq. 4 weights)."""
    _, tenv = envs
    ex = tenv.executor()
    codec = tstrategies.make_strategy("fedat", codec="none").codec
    ids = np.array([3, 5])
    w = {k: v.clone() for k, v in tenv.params0.items()}
    tiers = {k: torch.stack([v] * 3) for k, v in tenv.params0.items()}
    _, tiers = ex.fedat_round(w, tiers, 1, ids, 77, codec=codec,
                              use_prox=True,
                              cross_weights=np.ones(3, np.float32) / 3)
    perms = ex._perms(77, 2, 4)
    batch = ex._round_data(ex._pad_ids(ids)[0])
    live = {k: v[:2] for k, v in batch.items()}
    cp, _ = tenv.update_fn(tenv.params0, live, perms[:2])
    n = tenv.n_train_all[ids].astype(np.float32)
    wts = torch.from_numpy(n / n.sum())
    for k in tiers:
        ref = (cp[k] * wts.reshape((-1,) + (1,) * (cp[k].dim() - 1))).sum(0)
        torch.testing.assert_close(tiers[k][1], ref, rtol=1e-6, atol=1e-7)


def test_runs_are_deterministic(envs):
    _, tenv = envs
    out = []
    for _ in range(2):
        s = tstrategies.make_strategy("fedat", codec="quantize8")
        m = trun_engine(tenv, s, TEngineConfig(total_updates=2,
                                               eval_every=1))
        out.append((m.acc, m.times, _flat(s.w_global)))
    assert out[0][:2] == out[1][:2]
    assert np.array_equal(out[0][2], out[1][2])


@pytest.mark.parametrize("field,value,item", [
    ("churn_rate", 0.1, "A12"),
    ("population", TPopulationConfig(
        plane="stacked", availability="bernoulli:0.8:20",
        responsiveness="lognormal:0.3", eval_clients=2, seed=1), "A13"),
    ("topology", TTopologyConfig(
        n_silos=2, edges_per_silo=2, clients_per_edge=1,
        delay=(("silo_global", 1.0, 3.0),), silo_skew=0.5), "A14"),
    ("mesh", "host", "A16")])
def test_unported_planes_name_their_roadmap_item(field, value, item):
    """Every case refused to build naming its ROADMAP item before the
    item was ported (the ids are kept).  Churn (A12), the population
    plane (A13), the topology plane (A14) and the mesh (A16) are ported:
    the environment builds and equals the reference's (churn windows,
    tier map, eval subset, silo and edge membership, the mesh's data
    axis, bitwise)."""
    sc = TSimConfig(n_clients=4, n_tiers=2, clients_per_round=2,
                    n_unstable=1)
    setattr(sc, field, value)
    if item == "A16":
        # one rank, as the reference's one device: a (data=1, model=1)
        # mesh, data axis 1, the single-device round bodies
        env, jenv = TSimEnv(sc, device="cpu"), JSimEnv(JSimConfig(
            n_clients=4, n_tiers=2, clients_per_round=2, n_unstable=1,
            mesh=value))
        assert env.data_axis == jenv.data_axis == 1
        assert env.mesh.shape == dict(jenv.mesh.shape)
        assert np.array_equal(env.tm.tier_of, jenv.tm.tier_of)
        return
    env = TSimEnv(sc, device="cpu")
    if item == "A12":
        from repro.core.faults import churn_schedule
        want = churn_schedule(4, value, sc.churn_events, sc.churn_downtime,
                              sc.churn_window, sc.fault_seed)
        if want is None:
            assert env.churn_down is None
        else:
            assert all(np.array_equal(a, b)
                       for a, b in zip(env.churn_down, want))
        return
    from repro.core import population as jpopulation
    from repro.core import topology as jtopology
    jcls = {"population": jpopulation.PopulationConfig,
            "topology": jtopology.TopologyConfig}[field]
    jsc = JSimConfig(n_clients=4, n_tiers=2, clients_per_round=2,
                     n_unstable=1)
    setattr(jsc, field, jcls(**dataclasses.asdict(value)))
    jenv = JSimEnv(jsc)
    assert np.array_equal(env.tm.tier_of, jenv.tm.tier_of)
    assert np.array_equal(env.tm.latencies, jenv.tm.latencies)
    assert np.array_equal(env.dropout_at, jenv.dropout_at)
    if item == "A13":
        assert np.array_equal(env.population.eval_ids,
                              jenv.population.eval_ids)
        for k in ("x", "y", "mask", "n_samples"):
            assert np.array_equal(env.train[k], jenv.train[k])
        for k in ("x", "y", "mask"):
            assert np.array_equal(env.test[k], jenv.test[k])
        for now in (0.0, 25.0, 70.0):
            assert np.array_equal(env.alive(now), jenv.alive(now))
        return
    t, j = env.topology, jenv.topology
    assert t.k_edge == j.k_edge == 1
    assert all(np.array_equal(a, b)
               for a, b in zip(t.silo_members, j.silo_members))
    assert all(np.array_equal(a, b)
               for ta, ja in zip(t.edge_members, j.edge_members)
               for a, b in zip(ta, ja))
