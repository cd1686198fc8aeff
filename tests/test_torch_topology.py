"""The port's topology plane (core/topology.py, the spec's ``topology``
section, FedAT's silo rounds) against the JAX reference.

Both packages get the same numpy inputs.  The tree (silo and edge
membership, the per-edge sample size) and the link-delay stream are numpy
in both, so they must match bitwise, and so must every host-side record of
a run: event times, rounds, each silo round's per-edge ids and seed, the
Eq. 3 weights, the engine byte ledgers and the per-link-class ledger
``link_bytes``.  The runs start from the reference's ``params0`` with its
permutations (tests/test_torch_engine.py), and their final global models
are held within TOPO_RTOL, each bound beside the port's measured value and
the reference's own spread (the reference against itself from a
``params0`` changed by 1e-7 relative, over the same 8 updates, on the
CPU).  Inside the port, the degenerate tree (one silo, one edge, zero
delays) is the flat FedAT run bit for bit, and a resumed run is the
uninterrupted one bit for bit.
"""
import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import faults as jfaults
from repro.core import population as jpopulation
from repro.core import strategies as jstrategies
from repro.core import topology as jtopology
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.engine import run_engine as jrun_engine
from repro.core.simulation import SimConfig as JSimConfig
from repro.core.simulation import SimEnv as JSimEnv
from repro.runtime import elastic as jelastic
from repro_torch import api as tapi
from repro_torch.api import cli as tcli
from repro_torch.core import faults as tfaults
from repro_torch.core import population as tpopulation
from repro_torch.core import strategies as tstrategies
from repro_torch.core import tiering as ttiering
from repro_torch.core import topology as ttopology
from repro_torch.core.engine import EngineConfig as TEngineConfig
from repro_torch.core.engine import Outcome
from repro_torch.core.engine import run_engine as trun_engine
from repro_torch.core.simulation import SimConfig as TSimConfig
from repro_torch.core.simulation import SimEnv as TSimEnv

from test_torch_engine import _rel, jax_perm_source

torch.set_num_threads(1)

#: tests/test_topology.py's scenario: the edges are the latency tiers
#: inside each silo, so the flat tiers collapse to one
SCENARIO = dict(n_clients=24, samples_per_client=24, image_hw=8, n_tiers=1,
                clients_per_round=4, n_unstable=0, local_epochs=1)
#: 2 silos x 2 edges of 2 sampled clients, delays on every link class and
#: a skewed WAN, so the slow silo commits stale updates
TREE = dict(n_silos=2, edges_per_silo=2, clients_per_edge=2,
            delay=(("client_edge", 0.5, 1.5), ("edge_silo", 1.0, 3.0),
                   ("silo_global", 2.0, 6.0)),
            silo_skew=1.0, seed=9)
Q8 = (("client_edge", "quantize8"), ("edge_silo", "quantize8"),
      ("silo_global", "quantize8"))
UPDATES = 8
#: relative L2 of the final global model to the reference's after UPDATES
#: updates, measured on the CPU beside the reference's own spread.  With
#: quantize8 on all three links a code flip on any hop moves a block by
#: max|block|/127 and the trajectory amplifies it, so the port sits at the
#: reference's own spread, and so do the accuracies (ACC_TOL: the
#: reference moves its own by 0.016 from the 1e-7 change; the port 0.023)
TOPO_RTOL = {
    (0.0, "none"): 3e-5,        # measured 3.2e-6; reference 4.6e-7
    (0.5, "none"): 1e-5,        # measured 4.8e-7; reference 3.0e-7
    (0.5, "quantize8"): 3e-2,   # measured 8.0e-3; reference 8.4e-3
}
ACC_TOL = {"none": 0.02 + 1e-9, "quantize8": 0.05}


def _np(tree):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in tree.items()}


def _flat(tree):
    return np.concatenate([_np(tree)[k].ravel() for k in sorted(tree)])


def _tree(pkg, **over):
    return pkg.TopologyConfig(**dict(TREE, **over))


def _envs(scenario=None, pop=None, **tree_over):
    """The reference's and the port's env for one tree, the port from the
    reference's params0 with its permutations."""
    sc = dict(SCENARIO, **(scenario or {}))
    jsc = JSimConfig(topology=_tree(jtopology, **tree_over), **sc)
    tsc = TSimConfig(topology=_tree(ttopology, **tree_over), **sc)
    if pop is not None:
        jsc.population = jpopulation.PopulationConfig(**pop)
        tsc.population = tpopulation.PopulationConfig(**pop)
    jenv = JSimEnv(jsc)
    tenv = TSimEnv(tsc, device="cpu",
                   params0=jax.tree.map(np.asarray, jenv.params0))
    tenv.executor().perm_source = jax_perm_source(tenv)
    return jenv, tenv


def _logged(env):
    """Each silo round's (silo, per-edge ids, seed, Eq. 3 weights)."""
    log = []
    ex = env.executor()
    orig = type(ex).fedat_topology_round

    def wrap(w, silos, dispatch, s, ids_edges, seed, **k):
        log.append((int(s), [np.asarray(i).tolist() for i in ids_edges],
                    seed, np.asarray(k["cross_weights"]).tolist()))
        return orig(ex, w, silos, dispatch, s, ids_edges, seed, **k)
    ex.fedat_topology_round = wrap
    return log


def _identity_rounds(env, monkeypatch):
    """Replace the silo round by an identity that logs its arguments (the
    host-side half of the engine, without training)."""
    log = []

    def ident(w, silos, dispatch, s, ids_edges, seed, **k):
        log.append((int(s), [np.asarray(i).tolist() for i in ids_edges],
                    seed, np.asarray(k["cross_weights"]).tolist()))
        return w, silos, dispatch
    monkeypatch.setattr(env.executor(), "fedat_topology_round", ident,
                        raising=False)
    return log


def _metrics(m):
    return [m.times, m.rounds, m.bytes_up, m.bytes_down]


# ---------------------------------------------------------------------------
# the spec section
# ---------------------------------------------------------------------------

SPEC_CASES = [
    {"topology.n_silos": 2},
    {"topology.n_silos": 2, "topology.edges_per_silo": 2,
     "topology.clients_per_edge": 2,
     "topology.delay.client_edge": [0.5, 1.5],
     "topology.delay.silo_global": [2.0, 6.0],
     "topology.codec.silo_global": "quantize8",
     "topology.compensation": 0.5, "topology.silo_skew": 0.25,
     "topology.seed": 3},
    {"topology.delay.silo_global": [0.0, 0.0]},
    {"topology.codec.edge_silo": "quantize16"},
    {"topology.seed": 7},                               # inert: no config
    {"topology.n_silos": 0},
    {"topology.n_silos": 60},
    {"topology.clients_per_edge": -1},
    {"topology.n_silos": 2, "topology.delay.wan": [0, 1]},
    {"topology.n_silos": 2, "topology.codec.lan": "none"},
    {"topology.n_silos": 2, "topology.delay.silo_global": [3.0, 1.0]},
    {"topology.n_silos": 2, "topology.codec.silo_global": "zstd"},
    {"topology.n_silos": 2, "topology.compensation": 1.5},
    {"topology.n_silos": 2, "topology.silo_skew": -0.5},
    {"topology.n_silos": 2, "strategy.name": "fedavg"},
    {"topology.n_silos": 2, "faults.nan_rate": 0.1},
    {"topology.n_silos": 2, "faults.update_clip": 1.0},
]


def _spec_outcome(api, over):
    try:
        spec = api.ExperimentSpec().with_overrides(
            dict({"data.n_clients": 40}, **over)).validate()
    except api.SpecError as e:
        return ("error", str(e))
    tc = spec.to_sim_config().topology
    back = api.ExperimentSpec.from_json(spec.to_json())
    return ("ok", spec.hash(), spec.env_hash(), back == spec,
            back.hash() == spec.hash(),
            None if tc is None else dataclasses.asdict(tc),
            tc is None or type(spec.topology).from_config(tc)
            == spec.topology)


@pytest.mark.parametrize("over", SPEC_CASES)
def test_topology_spec_matches_the_reference(over):
    """Validation messages word for word; a valid section round-trips
    through JSON, hashes as in the reference and bridges to the same
    ``TopologyConfig``."""
    assert _spec_outcome(tapi, over) == _spec_outcome(japi, over)


def test_module_constants_match():
    assert ttopology.LINK_CLASSES == jtopology.LINK_CLASSES
    assert ttopology.LINK_STREAM == jtopology.LINK_STREAM
    assert ({f.name for f in dataclasses.fields(ttopology.TopologyConfig)}
            == {f.name for f in dataclasses.fields(jtopology.TopologyConfig)})


# ---------------------------------------------------------------------------
# the tree and its delay stream, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,S,E,k,skew", [
    (24, 2, 2, 2, 1.0), (24, 1, 1, 0, 0.0), (37, 3, 4, 3, 0.5),
    (100, 4, 3, 0, 3.0), (9, 3, 3, 1, 0.0)])
def test_tree_and_delays_are_bitwise_the_reference(n, S, E, k, skew):
    lat = ttiering.profile_latencies(np.full(n, 1.0),
                                     ((0.0, 0.0), (0.0, 5.0), (6.0, 10.0)),
                                     np.random.default_rng(n))
    kw = dict(n_silos=S, edges_per_silo=E, clients_per_edge=k,
              delay=TREE["delay"], silo_skew=skew, seed=S)
    t = ttopology.Topology(ttopology.TopologyConfig(**kw), n, lat, 5)
    j = jtopology.Topology(jtopology.TopologyConfig(**kw), n, lat, 5)
    assert t.k_edge == j.k_edge == (k or 5)
    assert (t.n_silos, t.edges_per_silo) == (j.n_silos, j.edges_per_silo)
    assert all(np.array_equal(a, b)
               for a, b in zip(t.silo_members, j.silo_members))
    assert all(a.dtype == b.dtype and np.array_equal(a, b)
               for ta, ja in zip(t.edge_members, j.edge_members)
               for a, b in zip(ta, ja))
    assert np.array_equal(t.silo_mult, j.silo_mult)
    tr, jr = t.new_link_rng(), j.new_link_rng()
    for s in list(range(S)) * 3:
        for a, b in zip(t.draw_delays(tr, s), j.draw_delays(jr, s)):
            assert np.array_equal(a, b)
    with pytest.raises(ValueError) as te:
        ttopology.Topology(ttopology.TopologyConfig(n_silos=n + 1), n,
                           lat, 5)
    with pytest.raises(ValueError) as je:
        jtopology.Topology(jtopology.TopologyConfig(n_silos=n + 1), n,
                           lat, 5)
    assert str(te.value) == str(je.value)


# ---------------------------------------------------------------------------
# the degenerate tree is the flat run, bit for bit
# ---------------------------------------------------------------------------

SMALL = {"data.n_clients": 24, "data.samples_per_client": 24,
         "data.image_hw": 8, "tiers.n_tiers": 1,
         "tiers.clients_per_round": 4, "tiers.n_unstable": 3,
         "engine.local_epochs": 1, "engine.total_updates": 6,
         "engine.eval_every": 2}


@pytest.mark.parametrize("codec", ["polyline:4", "quantize8"])
def test_degenerate_tree_is_bitwise_the_flat_run(codec):
    """1 silo, 1 edge, a zero-width delay band: the silo round's extra
    stages are exact identities (singleton averages, identity WAN
    codecs), so Metrics and every model equal the flat run's.  Dropouts
    shrink rounds, so padded slots are exercised too."""
    flat = dict(SMALL, **{"transport.codec": codec})
    runs = []
    for over in ({}, {"topology.delay.silo_global": [0.0, 0.0]}):
        run = tapi.build(tapi.ExperimentSpec().with_overrides(
            dict(flat, **over)), device="cpu")
        runs.append((run, run.run().metrics))
    (a, ma), (b, mb) = runs
    assert b.env.topology is not None and a.env.topology is None
    for f in ("times", "rounds", "acc", "acc_var", "bytes_up",
              "bytes_down"):
        assert getattr(ma, f) == getattr(mb, f), f
    pa, pb = a.strategy.global_params(), b.strategy.global_params()
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert all(torch.equal(a.strategy.tier_models[k],
                           b.strategy.tier_models[k]) for k in pa)


# ---------------------------------------------------------------------------
# hierarchical runs against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lam,codec", sorted(TOPO_RTOL))
def test_two_by_two_run_matches_the_reference(lam, codec):
    """Each silo round's per-edge ids, seed and Eq. 3 weights, the times,
    the engine byte ledgers and ``link_bytes`` equal the reference's; the
    final global model within TOPO_RTOL."""
    jenv, tenv = _envs(compensation=lam, codec=Q8 if codec != "none"
                       else ())
    jlog, tlog = _logged(jenv), _logged(tenv)
    try:
        js = jstrategies.make_strategy("fedat", codec=codec)
        ts = tstrategies.make_strategy("fedat", codec=codec)
        jm = jrun_engine(jenv, js, JEngineConfig(total_updates=UPDATES,
                                                 eval_every=4))
        tm = trun_engine(tenv, ts, TEngineConfig(total_updates=UPDATES,
                                                 eval_every=4))
    finally:
        del jenv.executor().fedat_topology_round
        del tenv.executor().fedat_topology_round
    assert tlog == jlog and len(tlog) == UPDATES
    assert {e[0] for e in tlog} == {0, 1}
    assert _metrics(tm) == _metrics(jm)
    assert ts.link_bytes == js.link_bytes
    assert all(v > 0 for v in ts.link_bytes.values())
    assert ts._link_ratios == js._link_ratios
    assert [c.name for c in ts.link_codecs] == \
        [c.name for c in js.link_codecs]
    assert np.array_equal(ts.counts, js.counts)
    assert all(abs(a - b) <= ACC_TOL[codec]
               for a, b in zip(tm.acc, jm.acc))
    w0 = _flat(jax.tree.map(np.asarray, jenv.params0))
    jw, tw = _flat(js.global_params()), _flat(ts.global_params())
    assert np.linalg.norm(jw - w0) > 0           # the global model moved
    assert _rel(tw, jw) < TOPO_RTOL[lam, codec]
    assert _rel(_flat(ts.dispatch), _flat(js.dispatch)) \
        < TOPO_RTOL[lam, codec]


def test_link_bytes_follow_the_live_counts():
    """The per-link ledger is the host-side sum over the committed silo
    rounds: 2 x live clients x client_edge payloads, 2 x live edges x
    edge_silo payloads, 2 silo_global payloads a round."""
    _, tenv = _envs(codec=Q8)
    log = _logged(tenv)
    st = tstrategies.make_strategy("fedat", codec="quantize8")
    ratios = []
    orig = st.on_eval

    def on_eval(env, ctx):
        orig(env, ctx)
        ratios.append(dict(st._link_ratios))
    st.on_eval = on_eval
    trun_engine(tenv, st, TEngineConfig(total_updates=4, eval_every=4))
    del tenv.executor().fedat_topology_round
    mb = tenv.model_bytes
    r = st.link_codecs[0].measure_ratio(tenv.params0)
    want = {"client_edge": 0.0, "edge_silo": 0.0, "silo_global": 0.0}
    for _, ids_edges, _, _ in log:
        want["client_edge"] += 2 * sum(map(len, ids_edges)) * mb * r
        want["edge_silo"] += 2 * sum(1 for i in ids_edges if i) * mb * r
        want["silo_global"] += 2 * mb * r
    assert st.link_bytes == want and len(log) == 4


def test_compensation_is_computed_without_contraction():
    """One silo round with lam = 0.5 against the same round with lam = 0
    from the same state: the silo slot differs by exactly
    ``np.float32(lam) * (g - st)`` added in float32 (product first, then
    the add: no fused multiply-add)."""
    lam = 0.5
    outs = []
    for c in (0.0, lam):
        _, tenv = _envs(compensation=c)
        ex = tenv.executor()
        st = tstrategies.make_strategy("fedat", codec="none")
        st.bind(tenv, TEngineConfig())
        g = {k: v + 0.01 * torch.sin(torch.arange(v.numel(),
                                                  dtype=v.dtype)
                                     .reshape(v.shape))
             for k, v in tenv.params0.items()}
        silos = {k: v.clone() for k, v in st.tier_models.items()}
        dispatch = {k: v.clone() for k, v in st.dispatch.items()}
        stale = _np({k: v[1].clone() for k, v in dispatch.items()})
        _, silos, dispatch = ex.fedat_topology_round(
            g, silos, dispatch, 1, [np.array([14, 20]), np.array([13])],
            4242, codecs=st.link_codecs, use_prox=True,
            cross_weights=np.array([0.25, 0.75], np.float32))
        outs.append((_np({k: v[1] for k, v in silos.items()}), _np(g),
                     stale, _np({k: v[1] for k, v in dispatch.items()})))
    (m0, g, st_, _), (m1, _, _, d1) = outs
    for k in m0:
        want = m0[k] + np.float32(lam) * (g[k] - st_[k])
        assert want.dtype == np.float32
        assert np.array_equal(m1[k], want), k
        # dispatch[s] was refreshed to the new global
        w_new = np.float32(0.25) * _np(tenv.params0)[k] \
            + np.float32(0.75) * m1[k]
        np.testing.assert_allclose(d1[k], w_new, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# faults and populations under the tree
# ---------------------------------------------------------------------------

#: one blackout of silo 1 (fault seed 2) from t = 40.4 to 80.4, inside
#: the 14 updates' 268 s of simulated time
BLACKOUT = dict(blackouts=1, blackout_window=(30.0, 60.0),
                blackout_duration=40.0, seed=2)


def test_silo_blackout_renormalizes_eq3_over_live_silos():
    """The fault plane counts silos under a tree (silo 1 can go dark,
    though the flat tier map has one tier): rounds of the dark silo are
    discarded, Eq. 3 gives it weight 0 and renormalizes over the live
    silo, and the silo rejoins from the global model; all as in the
    reference, the event trace and weights bitwise."""
    jenv, tenv = _envs()
    plane = tfaults.FaultPlane(tfaults.FaultConfig(**BLACKOUT), 2)
    assert [e[2] for e in plane.blackout_events] == [1]
    jlog, tlog = _logged(jenv), _logged(tenv)
    try:
        js = jstrategies.make_strategy("fedat", codec="none")
        ts = tstrategies.make_strategy("fedat", codec="none")
        jm = jrun_engine(jenv, js, JEngineConfig(
            total_updates=14, eval_every=7,
            faults=jfaults.FaultConfig(**BLACKOUT)))
        tm = trun_engine(tenv, ts, TEngineConfig(
            total_updates=14, eval_every=7,
            faults=tfaults.FaultConfig(**BLACKOUT)))
    finally:
        del jenv.executor().fedat_topology_round
        del tenv.executor().fedat_topology_round
    assert tlog == jlog and _metrics(tm) == _metrics(jm)
    assert ts.link_bytes == js.link_bytes
    dark = [e for e in tlog if e[3][1] == 0.0]
    assert dark and all(e[0] == 0 and e[3] == [1.0, 0.0] for e in dark)
    counts = np.array([3, 2], np.int64)
    assert np.array_equal(
        jelastic.masked_cross_weights(counts, np.array([True, False])),
        np.array([1.0, 0.0], np.float32))
    assert tlog[-1][3][1] > 0                    # silo 1 came back
    assert _rel(_flat(ts.global_params()), _flat(js.global_params())) \
        < TOPO_RTOL[0.0, "none"]


def test_churned_clients_never_reach_their_edge(monkeypatch):
    """Half the clients churn: every id a silo round aggregates is alive
    when the round completes and belongs to its edge, some rounds shrink,
    and the trace equals the reference's."""
    churn = dict(churn_rate=0.5, churn_events=2, churn_downtime=6.0,
                 churn_window=(1.0, 30.0), fault_seed=4)
    jenv, tenv = _envs(scenario=churn)
    jlog = _identity_rounds(jenv, monkeypatch)
    tlog = _identity_rounds(tenv, monkeypatch)
    ts = tstrategies.make_strategy("fedat")
    on_event, times = ts.on_event, []

    def timed(env, ctx, now, actor):
        out = on_event(env, ctx, now, actor)
        if out is Outcome.STEP:
            times.append(now)
        return out
    ts.on_event = timed
    jm = jrun_engine(jenv, jstrategies.make_strategy("fedat"),
                     JEngineConfig(total_updates=20, eval_every=10))
    tm = trun_engine(tenv, ts, TEngineConfig(total_updates=20,
                                             eval_every=10))
    assert tlog == jlog and len(tlog) == len(times) == 20
    assert _metrics(tm) == _metrics(jm)
    shrunk = 0
    for (s, ids_edges, _, _), now in zip(tlog, times):
        alive = tenv.alive(now)
        for e, ids in enumerate(ids_edges):
            assert all(alive[i] for i in ids)
            assert set(ids) <= set(tenv.topology.edge_members[s][e])
        shrunk += sum(map(len, ids_edges)) < 4
    assert shrunk > 0


@pytest.mark.parametrize("pop", [
    dict(availability="bernoulli:0.7:2", completion="bernoulli:0.8:2",
         responsiveness="lognormal:0.25", seed=1),
    dict(profile="phone:0.5", seed=2),
    dict(plane="streaming", availability="bernoulli:0.9:2", seed=3)])
def test_tree_composes_with_population_processes(pop, monkeypatch):
    """Availability, completion, responsiveness, the phone profile and
    the streaming plane under the tree: membership (built over the
    responsiveness-scaled latencies) and the event trace bitwise the
    reference's."""
    jenv, tenv = _envs(pop=pop)
    assert all(np.array_equal(a, b)
               for ta, ja in zip(tenv.topology.edge_members,
                                 jenv.topology.edge_members)
               for a, b in zip(ta, ja))
    jlog = _identity_rounds(jenv, monkeypatch)
    tlog = _identity_rounds(tenv, monkeypatch)
    jm = jrun_engine(jenv, jstrategies.make_strategy("fedat"),
                     JEngineConfig(total_updates=20, eval_every=10))
    tm = trun_engine(tenv, tstrategies.make_strategy("fedat"),
                     TEngineConfig(total_updates=20, eval_every=10))
    assert tlog == jlog and len(tlog) == 20
    assert _metrics(tm) == _metrics(jm)


def test_streaming_tree_trains_like_the_stacked_tree():
    """A 2 x 2 tree on the streaming plane is the stacked tree bit for
    bit (the silo round reads the uploaded rows)."""
    runs = []
    for plane in ("stacked", "streaming"):
        spec = tapi.ExperimentSpec().with_overrides(dict(SMALL, **{
            "transport.codec": "quantize8", "population.plane": plane,
            "topology.n_silos": 2, "topology.edges_per_silo": 2,
            "topology.clients_per_edge": 2,
            "topology.delay.silo_global": [1.0, 3.0]}))
        run = tapi.build(spec, device="cpu")
        runs.append((run, run.run().metrics))
    (a, ma), (b, mb) = runs
    assert ma.acc == mb.acc and ma.times == mb.times
    pa, pb = a.strategy.global_params(), b.strategy.global_params()
    assert all(torch.equal(pa[k], pb[k]) for k in pa)


# ---------------------------------------------------------------------------
# crash-resume
# ---------------------------------------------------------------------------

def _resume_spec(api):
    """tests/test_topology.py's crash-resume scenario."""
    return api.ExperimentSpec(
        data=api.DataSpec(n_clients=24, samples_per_client=24, image_hw=8),
        tiers=api.TierSpec(n_tiers=1, clients_per_round=4, n_unstable=0),
        engine=api.EngineSpec(total_updates=12, eval_every=2,
                              local_epochs=1),
        strategy=api.StrategySpec("fedat"),
        faults=api.FaultSpec(checkpoint_every=2, seed=4),
        topology=api.TopologySpec(n_silos=2, edges_per_silo=2,
                                  delay={"silo_global": (1.0, 3.0)},
                                  codec={"client_edge": "quantize8"},
                                  compensation=0.3))


class Abort(Exception):
    pass


def test_crash_resume_is_bitwise_under_topology(tmp_path):
    """An interrupted silo run resumes from its newest engine snapshot
    (dispatch stack, link-delay stream, per-link ledger included) to the
    uninterrupted trajectory and models, bit for bit; the snapshot's
    manifest equals the reference's."""
    spec = _resume_spec(tapi)
    first = tapi.build(spec, device="cpu")
    ref = first.run(checkpoint_dir=str(tmp_path / "full")).metrics
    seen = []

    def bomb(point):
        seen.append(point)
        if len(seen) == 3:
            raise Abort
    ck = str(tmp_path / "cut")
    with pytest.raises(Abort):
        tapi.build(spec, device="cpu").run(on_eval=bomb, checkpoint_dir=ck)
    run = tapi.build(spec, device="cpu")
    res = run.run(checkpoint_dir=ck, resume_engine=True)
    assert [getattr(res.metrics, f.name) for f in
            dataclasses.fields(res.metrics)] == \
        [getattr(ref, f.name) for f in dataclasses.fields(ref)]
    for name in ("w_global", "tier_models", "dispatch"):
        a, b = getattr(run.strategy, name), getattr(first.strategy, name)
        assert all(torch.equal(a[k], b[k]) for k in a), name
    assert run.strategy.link_bytes == first.strategy.link_bytes
    jck = str(tmp_path / "ref")
    japi.build(_resume_spec(japi)).run(checkpoint_dir=jck)
    for sub in ("engine/step_0000000012", "engine/step_0000000010",
                "step_0000000012"):
        a = json.loads(Path(jck, sub, "manifest.json").read_text())
        b = json.loads(Path(tmp_path, "full", sub,
                            "manifest.json").read_text())
        for k in ("paths", "shapes", "dtypes", "step"):
            assert a[k] == b[k], (sub, k)


def test_cli_runs_a_tree(tmp_path):
    out = tmp_path / "runs.json"
    res = tcli.main(["--device", "cpu", "--set", "data.n_clients=24",
                     "--set", "data.samples_per_client=24",
                     "--set", "data.image_hw=8", "--set", "tiers.n_tiers=1",
                     "--set", "tiers.n_unstable=0",
                     "--set", "engine.local_epochs=1",
                     "--set", "engine.total_updates=2",
                     "--set", "topology.n_silos=2",
                     "--out", str(out)])
    assert len(res) == 1 and res[0].metrics.rounds[-1] == 2
    doc = json.loads(out.read_text())
    assert doc["runs"][0]["spec"]["topology"]["n_silos"] == 2
