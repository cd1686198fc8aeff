"""The port's population plane (core/population.py, the spec's
``population`` section, the streaming data path) against the JAX
reference.

Both packages get the same numpy inputs.  The population's state is numpy
in both (per-client sizes, class pools and proportions, templates,
responsiveness factors, eval subset, per-client rows, the slotted
availability and completion masks), so it must match bitwise, and so must
every host-side record of a run (event times, rounds, the ids and seeds
of each round, the byte ledgers, the data-plane bytes).  The runs start
from the reference's ``params0`` with its permutations, like
tests/test_torch_engine.py, and their final global models are held within
POP_RTOL, each bound beside the port's measured value and the reference's
own spread (the reference against itself from a ``params0`` changed by
1e-7 relative, over the same 6 updates, on the CPU).  Inside the port, the
streaming plane must be the stacked plane bit for bit.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.core import population as jpopulation
from repro.core import strategies as jstrategies
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.engine import run_engine as jrun_engine
from repro.core.simulation import SimConfig as JSimConfig
from repro.core.simulation import SimEnv as JSimEnv
from repro.models import registry as jregistry
from repro_torch import api as tapi
from repro_torch.api import cli as tcli
from repro_torch.core import population as tpopulation
from repro_torch.core import strategies as tstrategies
from repro_torch.core.engine import EngineConfig as TEngineConfig
from repro_torch.core.engine import run_engine as trun_engine
from repro_torch.core.simulation import SimConfig as TSimConfig
from repro_torch.core.simulation import SimEnv as TSimEnv
from repro_torch.models import registry as tregistry

from test_torch_engine import _rel, jax_perm_source

torch.set_num_threads(1)

#: a small FedAT scenario; narrow bands, so every tier commits within the
#: run, and 1-second process slots, so availability and completion
#: change from round to round
SCENARIO = dict(n_clients=40, samples_per_client=20, image_hw=8,
                n_tiers=3, clients_per_round=4, n_unstable=4,
                local_epochs=1,
                delay_bands=((0.0, 0.0), (0.0, 0.5), (0.5, 1.0)))
PROCESSES = dict(availability="bernoulli:0.8:1", completion="bernoulli:0.8:1",
                 responsiveness="lognormal:0.25", eval_clients=16, seed=3)
UPDATES = 6
#: relative L2 of the final global model to the reference's, after
#: UPDATES updates, measured on the CPU (the same on both planes) beside
#: the reference's own spread.  A quantize8 code flip moves a block by
#: max|block|/127, and the trajectory amplifies it like a 1e-7 change
POP_RTOL = {
    ("fedat", "none"): 1e-5,        # measured 2.0e-7; reference 1.6e-7
    ("fedat", "quantize8"): 1e-2,   # measured 1.6e-3; reference 7.9e-4
    ("fedavg", "none"): 1e-3,       # measured 2.4e-5; reference 1.0e-4
    ("fedasync", "none"): 1e-3,     # measured 1.0e-4; reference 1.0e-4
}
ACC_TOL = 0.02 + 1e-9


def _np(tree):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in tree.items()}


def _flat(tree):
    return np.concatenate([_np(tree)[k].ravel() for k in sorted(tree)])


# ---------------------------------------------------------------------------
# the population's state, bitwise
# ---------------------------------------------------------------------------

#: (model, SimConfig overrides, PopulationConfig overrides): every data
#: kind, both partitioners, i.i.d. classes, every process grammar and the
#: phone profile
STATE_CASES = {
    "image-class": ("cnn", {}, dict(PROCESSES)),
    "image-dirichlet": ("cnn", {"partitioner": "dirichlet:0.3"},
                        dict(PROCESSES, plane="streaming")),
    "image-iid": ("cnn", {"classes_per_client": 10}, {}),
    "features": ("logreg", {"n_features": 12},
                 dict(availability="sine:0.6,0.3,100",
                      responsiveness="uniform:0.5,2.0",
                      completion="bernoulli:0.7:5", seed=5)),
    "tokens": ("tiny_lm", {"vocab_size": 32, "seq_len": 12},
               dict(eval_clients=7, seed=2)),
    "phone": ("cnn", {}, dict(profile="phone:0.4", seed=1)),
}


def _populations(case, n=40):
    model, sc_over, cfg_over = STATE_CASES[case]
    cfg = dict(plane="stacked")
    cfg.update(cfg_over)
    out = []
    for SimConfig, pop, reg in (
            (JSimConfig, jpopulation, jregistry),
            (TSimConfig, tpopulation, tregistry)):
        sc = SimConfig(model=model, **dict(SCENARIO, n_clients=n,
                                           **sc_over))
        m = reg.build_model(sc.model, reg.DataDims(
            n_classes=sc.n_classes, image_hw=sc.image_hw,
            n_features=sc.n_features, vocab_size=sc.vocab_size,
            seq_len=sc.seq_len, attention_backend=sc.attention_backend))
        out.append(pop.Population(pop.PopulationConfig(**cfg), sc, m))
    return out


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _same_dict(a, b):
    return sorted(a) == sorted(b) and all(_same(a[k], b[k]) for k in a)


@pytest.mark.parametrize("case", sorted(STATE_CASES))
def test_population_state_is_bitwise_the_reference(case):
    j, t = _populations(case)
    for name in ("n", "plane", "kind", "shape", "cap", "cap_train",
                 "cap_test"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.dtype == j.dtype
    for name in ("sizes", "n_train", "pools", "probs", "templates",
                 "resp_factors", "_phone", "eval_ids"):
        assert _same(getattr(t, name), getattr(j, name)), name
    # duplicate ids: the executor's dead-slot padding repeats a live id
    ids = np.array([5, 0, 39, 5, 17, 5], np.int32)
    assert _same_dict(t.materialize(ids), j.materialize(ids))
    assert _same_dict(t.materialize_stack(), j.materialize_stack())
    assert _same_dict(t.test_stack(t.eval_ids), j.test_stack(j.eval_ids))
    for k in (1, 4, 32):
        assert t.batch_nbytes(k) == j.batch_nbytes(k)
    for now in (0.0, 0.5, 3.0, 19.9, 20.0, 61.0, 250.0, 1000.0):
        assert _same(t.availability_mask(now), j.availability_mask(now))
        assert _same(t.completion_mask(now), j.completion_mask(now))


def test_stream_tags_and_presets_match():
    for name in ("SIZE_STREAM", "CLASS_STREAM", "TEMPLATE_STREAM",
                 "CONTENT_STREAM", "AVAIL_STREAM", "RESP_STREAM",
                 "COMPL_STREAM", "EVAL_STREAM", "PROFILE_STREAM", "PLANES",
                 "CAP_FACTOR", "MIN_SAMPLES", "DEFAULT_PERIOD",
                 "PHONE_AVAILABILITY", "PHONE_RESPONSIVENESS",
                 "PHONE_COMPLETION", "_SLOT_CACHE_MAX"):
        assert getattr(tpopulation, name) == getattr(jpopulation, name)
    assert ({f.name for f in dataclasses.fields(tpopulation.PopulationConfig)}
            == {f.name for f in
                dataclasses.fields(jpopulation.PopulationConfig)})
    for kw in ({}, {"plane": "stacked"}, {"eval_clients": 3}, {"seed": 9},
               {"profile": "phone:0.2"}):
        t = tpopulation.PopulationConfig(**kw)
        j = jpopulation.PopulationConfig(**kw)
        assert (t.active, t.indexed) == (j.active, j.indexed)


# ---------------------------------------------------------------------------
# grammars and spec validation, word for word
# ---------------------------------------------------------------------------

GRAMMAR_CASES = [
    ("parse_process", ("always", "availability", "always")),
    ("parse_process", ("bernoulli:0.3", "availability", "always")),
    ("parse_process", ("bernoulli:0.3:7", "completion", "none")),
    ("parse_process", ("sine:0.7,0.25,240", "availability", "always")),
    ("parse_process", ("poisson:1", "availability", "always")),
    ("parse_process", ("bernoulli:", "availability", "always")),
    ("parse_process", ("bernoulli:a:b", "completion", "none")),
    ("parse_process", ("bernoulli:1.5", "completion", "none")),
    ("parse_process", ("bernoulli:0.5:0", "availability", "always")),
    ("parse_process", ("bernoulli:0.1:2:3", "availability", "always")),
    ("parse_process", ("sine:0.5,0.1", "availability", "always")),
    ("parse_process", ("sine:1.5,0.1,10", "availability", "always")),
    ("parse_process", ("sine:0.5,-1,10", "availability", "always")),
    ("parse_process", ("sine:0.5,0.1,0", "availability", "always")),
    ("parse_responsiveness", ("lognormal:0.5",)),
    ("parse_responsiveness", ("uniform:0.5,2.0",)),
    ("parse_responsiveness", ("lognormal:x",)),
    ("parse_responsiveness", ("lognormal:-1",)),
    ("parse_responsiveness", ("uniform:2",)),
    ("parse_responsiveness", ("uniform:2,1",)),
    ("parse_responsiveness", ("gamma:1",)),
    ("parse_profile", ("phone:0.3",)),
    ("parse_profile", ("tablet:0.3",)),
    ("parse_profile", ("phone:x",)),
    ("parse_profile", ("phone:0",)),
]


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("fn,args", GRAMMAR_CASES)
def test_grammars_match_the_reference(fn, args):
    assert (_outcome(getattr(tpopulation, fn), *args)
            == _outcome(getattr(jpopulation, fn), *args))


SPEC_CASES = [
    {"population.plane": "streaming"},
    {"population.plane": "stacked", "population.eval_clients": 5},
    {"population.availability": "sine:0.7,0.25,240",
     "population.completion": "bernoulli:0.9:10"},
    {"population.responsiveness": "uniform:0.5,2.0", "population.seed": 4},
    {"population.profile": "phone:0.3"},
    {"population.seed": 9},                         # inert: no config
    {"population.plane": "bogus"},
    {"population.availability": "poisson:1"},
    {"population.completion": "bernoulli:2"},
    {"population.responsiveness": "gamma:1"},
    {"population.profile": "tablet:0.5"},
    {"population.profile": "phone:0.3",
     "population.availability": "bernoulli:0.5"},
    {"population.eval_clients": 101},
    {"population.eval_clients": -1},
]


def _spec_outcome(api, over):
    try:
        spec = api.ExperimentSpec().with_overrides(over).validate()
    except api.SpecError as e:
        return ("error", str(e))
    pc = spec.to_sim_config().population
    back = type(spec.population).from_config(pc)
    return ("ok", spec.hash(), spec.env_hash(),
            None if pc is None else dataclasses.asdict(pc),
            pc is None or back == spec.population)


@pytest.mark.parametrize("over", SPEC_CASES)
def test_population_spec_matches_the_reference(over):
    """Validation messages word for word; a valid section hashes as in
    the reference and bridges to the same ``PopulationConfig``."""
    assert _spec_outcome(tapi, over) == _spec_outcome(japi, over)


def test_default_spec_hash_and_legacy_section():
    spec = tapi.ExperimentSpec()
    assert spec.hash() == japi.ExperimentSpec().hash() == "60fd95ec9d49"
    assert spec.to_sim_config().population is None
    seeded = spec.with_overrides({"population.seed": 9})
    assert seeded.to_sim_config().population is None


# ---------------------------------------------------------------------------
# the environment and the runs against the reference
# ---------------------------------------------------------------------------

def _envs(plane, **cfg_over):
    cfg = dict(PROCESSES, plane=plane, **cfg_over)
    jenv = JSimEnv(JSimConfig(
        population=jpopulation.PopulationConfig(**cfg), **SCENARIO))
    p0 = jax.tree.map(np.asarray, jenv.params0)
    tenv = TSimEnv(TSimConfig(
        population=tpopulation.PopulationConfig(**cfg), **SCENARIO),
        device="cpu", params0=p0)
    tenv.executor().perm_source = jax_perm_source(tenv)
    return jenv, tenv


@pytest.fixture(scope="module", params=["stacked", "streaming"])
def envs(request):
    return _envs(request.param)


def test_environment_matches_the_reference(envs):
    jenv, tenv = envs
    assert tenv.streaming == jenv.streaming
    assert (tenv.train is None) == (jenv.train is None)
    assert (tenv.train_dev is None) == tenv.streaming
    if tenv.train is not None:
        assert _same_dict(tenv.train, jenv.train)
    assert _same_dict(tenv.test, jenv.test)
    assert _same(tenv.n_train_all, jenv.n_train_all)
    assert _same(tenv.population.eval_ids, jenv.population.eval_ids)
    assert np.array_equal(tenv.tm.tier_of, jenv.tm.tier_of)
    assert np.array_equal(tenv.tm.latencies, jenv.tm.latencies)
    assert all(np.array_equal(a, b)
               for a, b in zip(tenv.tm.members, jenv.tm.members))
    assert np.array_equal(tenv.dropout_at, jenv.dropout_at)
    assert tenv.client_cap == tenv.population.cap_train
    for now in (0.0, 0.7, 2.0, 5.5, 60.0, 500.0):
        assert np.array_equal(tenv.alive(now), jenv.alive(now))
        assert np.array_equal(tenv.completion(now), jenv.completion(now))
    assert tenv.data_plane_bytes() == jenv.data_plane_bytes()


def _logged(env, method):
    """Every round call's (ids, seed) in order; the executor's own
    arguments, so the trace is the same on either plane."""
    log = []
    ex = env.executor()
    orig = getattr(type(ex), method)

    def fedat(w, tiers, m, ids, seed, **k):
        log.append((m, np.asarray(ids).tolist(), seed))
        return orig(ex, w, tiers, m, ids, seed, **k)

    def fedavg(w, ids, seed, **k):
        log.append((np.asarray(ids).tolist(), seed))
        return orig(ex, w, ids, seed, **k)

    def fedasync(w, c, a, seed, **k):
        log.append((int(c), float(a), seed))
        return orig(ex, w, c, a, seed, **k)
    setattr(ex, method, {"fedat_round": fedat, "fedavg_round": fedavg,
                         "fedasync_round": fedasync}[method])
    return log


@pytest.mark.parametrize("name,codec", sorted(POP_RTOL))
def test_run_matches_the_reference(envs, name, codec):
    """The event trace (ids after the availability and completion
    filters, seeds), times, rounds, byte ledgers and data-plane bytes
    equal the reference's on the stacked and the streaming plane; the
    final global model within POP_RTOL."""
    jenv, tenv = envs
    method = {"fedat": "fedat_round", "fedavg": "fedavg_round",
              "fedasync": "fedasync_round"}[name]
    jlog, tlog = _logged(jenv, method), _logged(tenv, method)
    try:
        js = jstrategies.make_strategy(name, codec=codec)
        ts = tstrategies.make_strategy(name, codec=codec)
        jm = jrun_engine(jenv, js, JEngineConfig(total_updates=UPDATES,
                                                 eval_every=2))
        tm = trun_engine(tenv, ts, TEngineConfig(total_updates=UPDATES,
                                                 eval_every=2))
    finally:
        delattr(jenv.executor(), method)
        delattr(tenv.executor(), method)
    assert tlog == jlog and len(tlog) == UPDATES
    assert tm.times == jm.times and tm.rounds == jm.rounds
    assert tm.bytes_up == jm.bytes_up and tm.bytes_down == jm.bytes_down
    assert all(abs(a - b) <= ACC_TOL for a, b in zip(tm.acc, jm.acc))
    assert tenv.data_plane_bytes() == jenv.data_plane_bytes()
    assert tenv.executor().stream_bytes == jenv.executor().stream_bytes
    w0 = _flat(jax.tree.map(np.asarray, jenv.params0))
    jw, tw = _flat(js.global_params()), _flat(ts.global_params())
    assert np.linalg.norm(jw - w0) > 0           # the global model moved
    assert _rel(tw, jw) < POP_RTOL[name, codec]


@pytest.mark.parametrize("name", ["fedat", "fedavg", "tifl", "fedasync"])
def test_event_trace_matches_the_reference(name, monkeypatch):
    """The host-side half at 200 clients and 30 updates, with the round
    bodies replaced by identities: the availability, completion and
    responsiveness processes drive the same draws, filters and times."""
    cfg = dict(PROCESSES, plane="streaming", eval_clients=8)
    sc = dict(SCENARIO, n_clients=200, n_unstable=20)
    jenv = JSimEnv(JSimConfig(
        population=jpopulation.PopulationConfig(**cfg), **sc))
    tenv = TSimEnv(TSimConfig(
        population=tpopulation.PopulationConfig(**cfg), **sc),
        device="cpu", params0=jax.tree.map(np.asarray, jenv.params0))
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
    jm = jrun_engine(jenv, jstrategies.make_strategy(name),
                     JEngineConfig(total_updates=30, eval_every=10))
    tm = trun_engine(tenv, tstrategies.make_strategy(name),
                     TEngineConfig(total_updates=30, eval_every=10))
    assert logs[0] == logs[1] and len(logs[1]) >= 20
    assert tm.times == jm.times and tm.rounds == jm.rounds
    assert tm.bytes_up == jm.bytes_up and tm.bytes_down == jm.bytes_down


# ---------------------------------------------------------------------------
# inside the port: streaming is the stacked plane, bit for bit
# ---------------------------------------------------------------------------

def _spec(plane, **over):
    d = {"data.n_clients": 40, "data.samples_per_client": 20,
         "data.image_hw": 8, "tiers.n_tiers": 3,
         "tiers.clients_per_round": 4, "tiers.n_unstable": 4,
         "tiers.delay_bands": [[0.0, 0.0], [0.0, 0.5], [0.5, 1.0]],
         "engine.local_epochs": 1, "engine.total_updates": 6,
         "engine.eval_every": 2, "transport.codec": "quantize8",
         "population.plane": plane,
         "population.availability": "bernoulli:0.8:1",
         "population.completion": "bernoulli:0.8:1",
         "population.responsiveness": "lognormal:0.25",
         "population.eval_clients": 16, "population.seed": 3}
    d.update(over)
    return tapi.ExperimentSpec().with_overrides(d)


@pytest.mark.parametrize("name", ["fedat", "fedavg", "fedasync"])
def test_streaming_is_bitwise_the_stacked_plane(name):
    """The uploaded batch equals the resident gather byte for byte
    (padded dead slots included), so the whole run is bitwise equal:
    Metrics, the final global model and FedAT's tier models."""
    out = []
    for plane in ("stacked", "streaming"):
        run = tapi.build(_spec(plane, **{"strategy.name": name}),
                         device="cpu")
        out.append((run, run.run().metrics))
    (a, ma), (b, mb) = out
    assert b.env.train_dev is None and a.env.train_dev is not None
    assert b.env.executor().stream_bytes > 0
    for f in ("times", "rounds", "acc", "acc_var", "bytes_up",
              "bytes_down"):
        assert getattr(ma, f) == getattr(mb, f), f
    pa, pb = a.strategy.global_params(), b.strategy.global_params()
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    if name == "fedat":
        assert all(torch.equal(a.strategy.tier_models[k],
                               b.strategy.tier_models[k])
                   for k in pa)


def test_streamed_rows_equal_the_resident_gather():
    """One padded id vector (a dead slot repeats a live id) through both
    planes' ``_round_data``: equal tensors, dtypes and shapes."""
    sa = tapi.build(_spec("stacked"), device="cpu").env.executor()
    sb = tapi.build(_spec("streaming"), device="cpu").env.executor()
    pid = np.array([7, 31, 7, 7], np.int32)
    a, b = sa._round_data(pid), sb._round_data(pid)
    for k in ("x", "y", "mask"):
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
    assert sb.stream_bytes == sb.env.population.batch_nbytes(4)


def test_flat_memory_and_cli(tmp_path):
    """Data-plane bytes at 4,000 clients equal those at 400 on the
    streaming plane (the reference's flat-memory bound is 10%), and the
    CLI runs ``--set population.plane=streaming`` on the CPU."""
    def nbytes(n):
        run = tapi.build(_spec("streaming", **{
            "data.n_clients": n, "tiers.n_unstable": n // 16,
            "engine.total_updates": 2}), device="cpu")
        run.run()
        return run.env.data_plane_bytes()
    small, big = nbytes(400), nbytes(4000)
    assert small == big
    out = tmp_path / "runs.json"
    res = tcli.main(["--device", "cpu", "--set", "data.n_clients=40",
                     "--set", "data.samples_per_client=20",
                     "--set", "data.image_hw=8",
                     "--set", "tiers.clients_per_round=4",
                     "--set", "tiers.n_unstable=2",
                     "--set", "engine.local_epochs=1",
                     "--set", "engine.total_updates=2",
                     "--set", "population.plane=streaming",
                     "--set", "population.eval_clients=8",
                     "--out", str(out)])
    assert len(res) == 1 and res[0].metrics.rounds[-1] == 2
    assert res[0].spec_hash == japi.ExperimentSpec().with_overrides({
        "data.n_clients": 40, "data.samples_per_client": 20,
        "data.image_hw": 8, "tiers.clients_per_round": 4,
        "tiers.n_unstable": 2, "engine.local_epochs": 1,
        "engine.total_updates": 2, "population.plane": "streaming",
        "population.eval_clients": 8}).hash()
