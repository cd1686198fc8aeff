"""The client-sharded round executor on a mesh of ranks, against the JAX
reference's mesh contract (tests/test_mesh_executor.py).

* **D == 1 is bitwise.**  A one-rank host mesh (no process group) runs
  the single-device round bodies: the trajectory, the final global and
  tier models and the step keys equal the no-mesh run's, bit for bit,
  for FedAT, FedAvg, TiFL and FedAsync, and under the population plane
  (stacked and streaming).
* **D > 1 is tolerance-pinned.**  2 and 4 gloo ranks, each a process
  (``launch/mesh.py`` ``run_ranks``, a ``file://`` store so parallel test
  workers never share an address): the event times equal the reference's
  single-device run bit for bit (the host program is the same on every
  rank); one FedAT round (polyline:4) and one FedAvg round (raw f32) are
  within ``ROUND_ATOL`` of the one-rank round, the reference's own pin
  (2e-3) for its forced-device mesh; a quantize8 FedAT round within
  ``Q8_ATOL`` (each rank's uplink codec groups its K/D clients' blocks
  itself, so a value near a code boundary can land on the neighbouring
  code, a step of max|block|/127); a 30-update trajectory's accuracy
  within 0.1 of the one-rank run's, the reference's pin; every rank ends
  with the same global model, bit for bit.  Measured on the CPU at D = 2
  and 4: 6.0e-8 (FedAT, polyline:4), 1.2e-7 (FedAvg), 8.2e-4 / 8.3e-4
  (quantize8: one code step), accuracy differences 0.0.
* The refusals under D > 1: the "multiple of 4" pad error under 4 ranks,
  the gated steps and the topology round, with the reference's words.
"""
import json
import os
import textwrap

import pytest
import torch

from repro.core.fedat import FedATConfig as JFedATConfig
from repro.core.fedat import run_fedat as jrun_fedat
from repro.core.simulation import SimConfig as JSimConfig
from repro.core.simulation import SimEnv as JSimEnv
from repro_torch.core import strategies as tstrategies
from repro_torch.core.engine import EngineConfig as TEngineConfig
from repro_torch.core.engine import run_engine as trun_engine
from repro_torch.core.population import PopulationConfig as TPopConfig
from repro_torch.core.simulation import SimConfig as TSimConfig
from repro_torch.core.simulation import SimEnv as TSimEnv
from repro_torch.launch import mesh as mesh_mod

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = dict(n_clients=16, n_tiers=3, samples_per_client=20,
            classes_per_client=2, image_hw=8, clients_per_round=8,
            local_epochs=1, n_unstable=2)
ROUND_ATOL = 2e-3
Q8_ATOL = 2e-3
ACC_ATOL = 0.1
UPDATES = 30

_RANK = textwrap.dedent("""
    import hashlib, json, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    from repro_torch import api
    from repro_torch.compress import transport
    from repro_torch.core import aggregation, strategies
    from repro_torch.core.engine import EngineConfig, run_engine
    from repro_torch.core.fedat import FedATConfig, run_fedat
    from repro_torch.core.simulation import SimConfig, SimEnv
    from repro_torch.core.steps import UpdateGate
    from repro_torch.launch import mesh as mesh_mod

    dev = mesh_mod.init_from_env(torch.device("cpu"))
    base = json.loads(sys.argv[1])
    updates = int(sys.argv[2])
    env0 = SimEnv(SimConfig(**base), device="cpu")
    env1 = SimEnv(SimConfig(**base, mesh="host"), device="cpu")
    out = {"world": mesh_mod.world_size(), "data_axis": env1.data_axis,
           "rank": mesh_mod.rank()}

    def flat(p):
        return torch.cat([p[k].reshape(-1) for k in sorted(p)])

    M = env0.tm.n_tiers
    cw = aggregation.uniform_weights_host(M)
    ids = np.arange(base["clients_per_round"], dtype=np.int32)

    def fedat(env, codec):
        w = {k: v.clone() for k, v in env.params0.items()}
        t = {k: torch.stack([v] * M) for k, v in env.params0.items()}
        return flat(env.executor().fedat_round(
            w, t, 0, ids, 7, codec=transport.get_codec(codec),
            use_prox=True, cross_weights=cw)[0])

    for codec in ("polyline:4", "quantize8"):
        d = (fedat(env0, codec) - fedat(env1, codec)).abs().max()
        out[f"fedat_{codec}_maxdiff"] = float(d)
    w0 = env0.executor().fedavg_round(dict(env0.params0), ids, 7)
    w1 = env1.executor().fedavg_round(dict(env1.params0), ids, 7)
    out["fedavg_maxdiff"] = float((flat(w0) - flat(w1)).abs().max())

    m1 = run_fedat(env1, FedATConfig(total_updates=updates, eval_every=6))
    out["times"] = m1.times
    out["acc"] = m1.acc
    out["keys"] = sorted(map(str, env1.executor().trace_counts))

    ex = env1.executor()
    t = {k: torch.stack([v] * M) for k, v in env1.params0.items()}
    refusals = {}
    for name, call in (
            ("fedat_gate", lambda: ex.fedat_round(
                dict(env1.params0), t, 0, ids, 7,
                codec=transport.get_codec("none"), use_prox=True,
                cross_weights=cw, gate=UpdateGate())),
            ("fedavg_gate", lambda: ex.fedavg_round(
                dict(env1.params0), ids, 7, gate=UpdateGate())),
            ("topology", lambda: ex.fedat_topology_round(
                dict(env1.params0), t, t, 0, [ids], 7, codecs=None,
                use_prox=True, cross_weights=cw))):
        try:
            call()
            refusals[name] = None
        except NotImplementedError as e:
            refusals[name] = str(e)
    out["refusals"] = refusals
    try:
        api.get_env(api.ExperimentSpec(
            data=api.DataSpec(n_clients=16, samples_per_client=20,
                              image_hw=8),
            tiers=api.TierSpec(n_tiers=3, clients_per_round=10,
                               n_unstable=2),
            mesh=api.MeshSpec(kind="host")), device="cpu")
        out["pad_error"] = None
    except api.SpecError as e:
        out["pad_error"] = str(e)
    s = strategies.make_strategy("fedat", codec="quantize8")
    run_engine(env1, s, EngineConfig(total_updates=4, eval_every=2))
    out["w_final"] = hashlib.sha256(
        flat(s.global_params()).numpy().tobytes()).hexdigest()
    print("RESULT" + json.dumps(out), flush=True)
    mesh_mod.shutdown()
""")


def _launch(world: int):
    res = mesh_mod.run_ranks(
        ["-c", _RANK, json.dumps(BASE), str(UPDATES)], world, timeout=400,
        env={"PYTHONPATH": os.path.join(REPO, "src"),
             "OMP_NUM_THREADS": "1"})
    outs = []
    for rc, so, se in res:
        assert rc == 0, se[-3000:]
        line = [x for x in so.splitlines() if x.startswith("RESULT")][0]
        outs.append(json.loads(line[len("RESULT"):]))
    return outs


@pytest.fixture(scope="module")
def ranks():
    return {world: _launch(world) for world in (2, 4)}


@pytest.fixture(scope="module")
def jax_times():
    env = JSimEnv(JSimConfig(**BASE))
    return jrun_fedat(env, JFedATConfig(total_updates=UPDATES,
                                        eval_every=6)).times


@pytest.fixture(scope="module")
def one_rank():
    """The port's run with no mesh: (metrics, step keys)."""
    env = TSimEnv(TSimConfig(**BASE), device="cpu")
    m = trun_engine(env, tstrategies.make_strategy("fedat"),
                    TEngineConfig(total_updates=UPDATES, eval_every=6))
    return m, sorted(map(str, env.executor().trace_counts))


# ---------------------------------------------------------------------------
# D == 1: bitwise the no-mesh run
# ---------------------------------------------------------------------------

def _flat(p):
    return torch.cat([p[k].reshape(-1) for k in sorted(p)])


@pytest.mark.parametrize("name", ["fedat", "fedavg", "tifl", "fedasync"])
def test_one_rank_host_mesh_is_bitwise_no_mesh(name):
    kw = {"codec": "quantize8"} if name != "fedasync" else {}
    out = []
    for mesh in (None, "host"):
        env = TSimEnv(TSimConfig(**BASE, mesh=mesh), device="cpu")
        s = tstrategies.make_strategy(name, **kw)
        m = trun_engine(env, s, TEngineConfig(total_updates=6,
                                              eval_every=3))
        tiers = getattr(s, "tier_models", None)
        out.append((m.times, m.acc, m.acc_var, _flat(s.global_params()),
                    None if tiers is None else _flat(tiers),
                    sorted(env.executor().trace_counts), env))
    (t0, a0, v0, w0, s0, k0, e0), (t1, a1, v1, w1, s1, k1, e1) = out
    assert e0.mesh is None and e1.mesh.shape == {"data": 1, "model": 1}
    assert e1.data_axis == 1
    assert t0 == t1 and a0 == a1 and v0 == v1
    assert torch.equal(w0, w1)
    assert (s0 is None and s1 is None) or torch.equal(s0, s1)
    assert k0 == k1 and not any("data" in str(k) for k in k1)


@pytest.mark.parametrize("plane", ["stacked", "streaming"])
def test_one_rank_host_mesh_bitwise_under_population(plane):
    pop = TPopConfig(plane=plane, availability="bernoulli:0.9:20",
                     eval_clients=8, seed=3)
    base = {**BASE, "n_clients": 64, "n_unstable": 6}
    out = []
    for mesh in (None, "host"):
        env = TSimEnv(TSimConfig(**base, mesh=mesh, population=pop),
                      device="cpu")
        s = tstrategies.make_strategy("fedat")
        m = trun_engine(env, s, TEngineConfig(total_updates=8,
                                              eval_every=4))
        out.append((m.times, m.acc, _flat(s.global_params()),
                    set(env.executor().trace_counts)))
    assert out[0][0] == out[1][0] and out[0][1] == out[1][1]
    assert torch.equal(out[0][2], out[1][2]) and out[0][3] == out[1][3]
    assert all(("stream" in k) == (plane == "streaming") for k in out[1][3])


def test_more_ranks_than_the_world_raises():
    """A mesh of more than one rank without a process group raises; a
    production mesh is shape-only and cannot run a round."""
    with pytest.raises(ValueError, match="no process group"):
        mesh_mod.make_mesh((2, 1), ("data", "model"))
    with pytest.raises(ValueError, match="shape-only"):
        TSimEnv(TSimConfig(**{**BASE, "clients_per_round": 16},
                           mesh="production"), device="cpu")


# ---------------------------------------------------------------------------
# D > 1: gloo ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_sharded_event_times_equal_the_reference(ranks, jax_times,
                                                 one_rank, world):
    for r in ranks[world]:
        assert r["world"] == world and r["data_axis"] == world
        assert r["times"] == one_rank[0].times == jax_times


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_round_within_pinned_bound(ranks, world):
    for r in ranks[world]:
        assert r["fedat_polyline:4_maxdiff"] < ROUND_ATOL, r
        assert r["fedavg_maxdiff"] < ROUND_ATOL, r
        assert r["fedat_quantize8_maxdiff"] < Q8_ATOL, r


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_trajectory_and_ranks_agree(ranks, one_rank, world):
    rs = ranks[world]
    m0, keys0 = one_rank
    for r in rs:
        assert max(abs(a - b) for a, b in zip(m0.acc, r["acc"])) < ACC_ATOL
        assert all(f"data{world}" in k for k in r["keys"])
        assert not any("data" in k for k in keys0)
    # every rank holds the same metrics and the same global model
    assert all(r["acc"] == rs[0]["acc"] for r in rs)
    assert all(r["w_final"] == rs[0]["w_final"] for r in rs)


def test_sharded_refusals_and_pad_error(ranks):
    r = ranks[4][0]
    assert r["pad_error"] is not None and "multiple of 4" in r["pad_error"]
    assert "tiers.clients_per_round=10" in r["pad_error"]
    gate = ("the update validation gate is single-device only for now "
            "(mesh data axis D=4)")
    assert r["refusals"]["fedat_gate"].startswith(gate)
    assert r["refusals"]["fedavg_gate"].startswith(gate)
    assert r["refusals"]["topology"].startswith(
        "the topology plane is single-data-axis for now (mesh data axis "
        "D=4)")
    assert ranks[2][0]["pad_error"] is None


def test_cli_on_two_ranks_writes_once(tmp_path):
    """``python -m repro_torch.api.cli --set mesh.kind=host`` on 2 ranks
    (the launcher's environment): rank 0 prints the run and writes
    ``--out``, rank 1 neither; the record's spec hash is the reference's
    for the same overrides."""
    from repro import api as japi
    sets = {"mesh.kind": "host", "data.n_clients": 12,
            "data.samples_per_client": 20, "data.image_hw": 8,
            "tiers.n_tiers": 3, "tiers.clients_per_round": 4,
            "tiers.n_unstable": 2, "engine.local_epochs": 1,
            "engine.total_updates": 4, "engine.eval_every": 2,
            "transport.codec": "quantize8"}
    argv = ["-m", "repro_torch.api.cli", "--device", "cpu",
            "--out", str(tmp_path / "out.json")]
    for k, v in sets.items():
        argv += ["--set", f"{k}={v}"]
    res = mesh_mod.run_ranks(argv, 2, timeout=300, env={
        "PYTHONPATH": os.path.join(REPO, "src"), "OMP_NUM_THREADS": "1"})
    assert [rc for rc, _, _ in res] == [0, 0], [e[-2000:] for *_, e in res]
    want = japi.ExperimentSpec().with_overrides(sets).hash()
    assert f"spec {want}" in res[0][1] and res[1][1] == ""
    with open(tmp_path / "out.json") as f:
        doc = json.load(f)
    assert doc["runs"][0]["spec_hash"] == want
