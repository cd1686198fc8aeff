"""``shard_tiers``: the tier-model stack laid over the mesh's ``pod`` axis,
against the JAX reference's ``_tier_place`` on forced host devices.

The reference runs in two JAX subprocesses: 4 forced devices for the
client-sharded FedAT round on ``(pod=2, data=2, model=1)``, 2 for the
topology round on ``(pod=2, data=1, model=1)``.  The port's ranks run as
gloo processes (``launch/mesh.py`` ``run_ranks``), from the reference's
``params0`` with its permutations (tests/test_torch_engine.py).

* Layout: each rank's slots of the stack equal the index of the
  reference's ``addressable_shards`` on that rank's device: pod p of 2
  holds tiers [2p, 2p+2) of 4, and silo p of 2.  With five tiers over two
  pods the reference keeps the whole stack on every device (a
  ``with_sharding_constraint`` that does not divide is left whole), and so
  does the port: the run is bitwise the unsharded run on the same mesh.
* Trajectory: event times bitwise the reference's.  After 6 updates the
  final global and tier models are held to the reference's by the
  trajectory pins of tests/test_torch_engine.py (``RTOL``, relative L2;
  the one-round pins of tests/test_torch_mesh_executor.py do not hold a
  quantize8 trajectory, where one code flip grows over the later
  rounds), and to the unsharded port run on the same mesh by the
  one-round pins ``ROUND_ATOL`` / ``Q8_ATOL``: at M = 4 the sharded run
  re-associates Eq. 3 (each pod sums its two slots, then the pods' sums
  are added).  Measured on the CPU, relative L2 of the tier models to
  the reference's: polyline:4 1.2e-5 sharded, 1.4e-5 unsharded;
  quantize8 6.7e-4 sharded, 6.5e-4 unsharded (so the layout adds
  nothing); against the unsharded run, max |diff| of the tier models
  1.0e-4 (polyline:4, one rounding step) and 1.7e-3 (quantize8).
* Topology on (pod=2, data=1): event times bitwise the reference's, the
  global model within tests/test_torch_topology.py's ``TOPO_RTOL`` (read
  3.0e-3).  Eq. 3 over two silos is one add however it is split, so the
  sharded run is bitwise the one-rank run, and snapshots taken on 2 pods
  resume on 1 rank, and the reverse, to the uninterrupted run's bits.
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.core import strategies as tstrategies
from repro_torch.core import topology as ttopology
from repro_torch.core.engine import EngineConfig as TEngineConfig
from repro_torch.core.engine import run_engine as trun_engine
from repro_torch.core.faults import FaultConfig as TFaultConfig
from repro_torch.core.simulation import SimConfig as TSimConfig
from repro_torch.core.simulation import SimEnv as TSimEnv
from repro_torch.launch import mesh as mesh_mod
from repro_torch.runtime import sharding as shd

from test_torch_engine import jax_perm_source

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: narrow delay bands: every tier commits within the run, so Eq. 3 mixes
#: trained tier models into the global model
BASE = dict(n_clients=16, samples_per_client=20, classes_per_client=2,
            image_hw=8, clients_per_round=8, local_epochs=1, n_unstable=2,
            delay_bands=((0.0, 0.0), (0.0, 0.5), (0.5, 1.0)))
UPDATES = 6
CODECS = ("polyline:4", "quantize8")
#: tests/test_torch_mesh_executor.py's one-round pins
ROUND_ATOL = 2e-3
Q8_ATOL = 2e-3
ATOL = {"polyline:4": ROUND_ATOL, "quantize8": Q8_ATOL}
#: tests/test_torch_engine.py's and tests/test_torch_topology.py's
#: trajectory pins (relative L2)
RTOL = {"polyline:4": 5e-5, "quantize8": 1e-3}
TOPO_RTOL = 3e-2
#: tests/test_torch_topology.py's 2 x 2 tree on one flat tier
TOPO_BASE = dict(n_clients=24, samples_per_client=24, image_hw=8, n_tiers=1,
                 clients_per_round=4, n_unstable=0, local_epochs=1)
TREE = dict(n_silos=2, edges_per_silo=2, clients_per_edge=2,
            delay=[["client_edge", 0.5, 1.5], ["edge_silo", 1.0, 3.0],
                   ["silo_global", 2.0, 6.0]],
            codec=[["edge_silo", "quantize8"], ["silo_global", "quantize8"]],
            compensation=0.5, silo_skew=1.0, seed=9)
TOPO_UPDATES = 6
TOPO_SNAPSHOT_AT = 4

_JAX = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = (
        "--xla_force_host_platform_device_count=" + sys.argv[2])
    import json, pickle
    import jax, numpy as np
    from repro.core import strategies, topology
    from repro.core.engine import EngineConfig, run_engine
    from repro.core.simulation import SimConfig, SimEnv

    cfg = json.loads(sys.argv[3])

    def slots(tree, mesh):
        leaf = jax.tree.leaves(tree)[0]
        n = leaf.shape[0]
        by_dev = {d: sh.index[0] for sh in leaf.addressable_shards
                  for d in [sh.device]}
        return [list(range(n))[by_dev[d]] for d in mesh.devices.reshape(-1)]

    def np_tree(t):
        return {k: np.asarray(v) for k, v in t.items()}

    res = {}
    if sys.argv[2] == "4":
        for M in (4, 5):
            for codec in cfg["codecs"]:
                env = SimEnv(SimConfig(**cfg["base"], n_tiers=M,
                                       mesh="host:2", shard_tiers=True))
                s = strategies.make_strategy("fedat", codec=codec)
                m = run_engine(env, s, EngineConfig(
                    total_updates=cfg["updates"], eval_every=2))
                res[(M, codec)] = {
                    "params0": np_tree(env.params0), "times": m.times,
                    "w": np_tree(s.w_global),
                    "tiers": np_tree(s.tier_models),
                    "slots": slots(s.tier_models, env.mesh),
                    "mesh": dict(env.mesh.shape)}
    else:
        tree = dict(cfg["tree"])
        tree["delay"] = tuple(tuple(d) for d in tree["delay"])
        tree["codec"] = tuple(tuple(c) for c in tree["codec"])
        env = SimEnv(SimConfig(**cfg["topo_base"], mesh="host:2",
                               shard_tiers=True,
                               topology=topology.TopologyConfig(**tree)))
        s = strategies.make_strategy("fedat")
        m = run_engine(env, s, EngineConfig(total_updates=cfg["updates"],
                                            eval_every=2))
        res["topology"] = {"params0": np_tree(env.params0), "times": m.times,
                           "w": np_tree(s.w_global),
                           "tiers": np_tree(s.tier_models),
                           "slots": slots(s.tier_models, env.mesh),
                           "mesh": dict(env.mesh.shape)}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(res, f)
""")

_RANK = textwrap.dedent("""
    import json, pickle, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    sys.path.insert(0, sys.argv[4])
    from test_torch_engine import jax_perm_source
    from repro_torch.core import strategies, topology
    from repro_torch.core.engine import EngineConfig, run_engine
    from repro_torch.core.faults import FaultConfig
    from repro_torch.core.simulation import SimConfig, SimEnv
    from repro_torch.launch import mesh as mesh_mod

    mesh_mod.init_from_env(torch.device("cpu"))
    ref_path, out_path = sys.argv[1], sys.argv[2].format(mesh_mod.rank())
    cfg = json.loads(sys.argv[3])
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)

    def np_tree(t):
        return {k: v.numpy().copy() for k, v in t.items()}

    def run(sc, params0, strategy, updates, **kw):
        env = SimEnv(sc, device="cpu", params0=params0)
        env.executor().perm_source = jax_perm_source(env)
        s = strategies.make_strategy("fedat", **strategy)
        m = run_engine(env, s, EngineConfig(total_updates=updates,
                                            eval_every=2, **kw.pop("eng", {})),
                       **kw)
        whole = env.executor().whole_tiers(s.tier_models, len(s.counts))
        return {"slots": list(s.slots), "times": m.times,
                "w": np_tree(s.w_global), "tiers": np_tree(whole),
                "held": list(next(iter(s.tier_models.values())).shape),
                "mesh": dict(env.mesh.shape)}

    out = {"rank": mesh_mod.rank()}
    if mesh_mod.world_size() == 4:
        for M in (4, 5):
            for codec in cfg["codecs"]:
                p0 = ref[(M, codec)]["params0"]
                for shard in (True, False):
                    sc = SimConfig(**cfg["base"], n_tiers=M, mesh="host:2",
                                   shard_tiers=shard)
                    out[(M, codec, shard)] = run(
                        sc, p0, {"codec": codec}, cfg["updates"])
    else:
        tree = dict(cfg["tree"])
        tree["delay"] = tuple(tuple(d) for d in tree["delay"])
        tree["codec"] = tuple(tuple(c) for c in tree["codec"])
        sc = SimConfig(**cfg["topo_base"], mesh="host:2", shard_tiers=True,
                       topology=topology.TopologyConfig(**tree))
        p0 = ref["topology"]["params0"]
        faults = FaultConfig(checkpoint_every=2)
        out["topology"] = run(sc, p0, {}, cfg["updates"])
        # the one rank's snapshot resumed on 2 pods, then a snapshot of
        # 2 pods for the one rank to resume
        out["resumed"] = run(sc, p0, {}, cfg["updates"],
                             eng={"faults": faults},
                             checkpoint_dir=cfg["one_rank_dir"], resume=True)
        run(sc, p0, {}, cfg["snapshot_at"], eng={"faults": faults},
            checkpoint_dir=cfg["pods_dir"])
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    mesh_mod.shutdown()
""")


def _topology_sc(**over):
    tree = dict(TREE)
    tree["delay"] = tuple(tuple(d) for d in tree["delay"])
    tree["codec"] = tuple(tuple(c) for c in tree["codec"])
    return TSimConfig(**TOPO_BASE, topology=ttopology.TopologyConfig(**tree),
                      **over)


def _one_rank_topology(p0, updates, **kw):
    env = TSimEnv(_topology_sc(), device="cpu", params0=p0)
    env.executor().perm_source = jax_perm_source(env)
    s = tstrategies.make_strategy("fedat")
    faults = kw.pop("faults", None)
    m = trun_engine(env, s, TEngineConfig(total_updates=updates,
                                          eval_every=2, faults=faults), **kw)
    return {"times": m.times, "w": {k: v.numpy().copy()
                                    for k, v in s.w_global.items()},
            "tiers": {k: v.numpy().copy()
                      for k, v in s.tier_models.items()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("shard_tiers")
    cfg = {"base": BASE, "codecs": CODECS, "updates": UPDATES,
           "topo_base": TOPO_BASE, "tree": TREE,
           "one_rank_dir": str(d / "one_rank"), "pods_dir": str(d / "pods"),
           "snapshot_at": TOPO_SNAPSHOT_AT}
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "JAX_PLATFORMS": "cpu"}
    refs = {}
    procs = {n: subprocess.Popen(
        [sys.executable, "-c", _JAX, str(d / f"ref{n}.pkl"), str(n),
         json.dumps({**cfg, "updates": UPDATES if n == 4 else TOPO_UPDATES})],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for n in (4, 2)}
    for n, p in procs.items():
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
        with open(d / f"ref{n}.pkl", "rb") as f:
            refs[n] = pickle.load(f)
    # the one-rank topology runs: uninterrupted, and a snapshot for the
    # pods to resume
    p0 = refs[2]["topology"]["params0"]
    faults = TFaultConfig(checkpoint_every=2)
    one = _one_rank_topology(p0, TOPO_UPDATES)
    _one_rank_topology(p0, TOPO_SNAPSHOT_AT, faults=faults,
                       checkpoint_dir=cfg["one_rank_dir"])
    ranks = {}
    for world, n in ((4, 4), (2, 2)):
        store = d / f"store{world}"
        store.mkdir()
        res = mesh_mod.run_ranks(
            ["-c", _RANK, str(d / f"ref{n}.pkl"),
             str(d / f"w{world}_rank{{}}.pkl"),
             json.dumps({**cfg, "updates": UPDATES if world == 4
                         else TOPO_UPDATES}),
             os.path.join(REPO, "tests")], world, timeout=600,
            store_dir=str(store),
            env={"PYTHONPATH": os.path.join(REPO, "src"),
                 "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"})
        assert all(rc == 0 for rc, _, _ in res), [e[-3000:] for *_, e in res]
        ranks[world] = []
        for r in range(world):
            with open(d / f"w{world}_rank{r}.pkl", "rb") as f:
                ranks[world].append(pickle.load(f))
    # the pods' snapshot resumed on one rank
    resumed = _one_rank_topology(p0, TOPO_UPDATES, faults=faults,
                                 checkpoint_dir=cfg["pods_dir"], resume=True)
    return refs, ranks, one, resumed


def _flat(tree):
    return np.concatenate([np.asarray(tree[k]).ravel() for k in sorted(tree)])


def _rel(a, b):
    assert sorted(a) == sorted(b)
    fa, fb = _flat(a), _flat(b)
    return float(np.linalg.norm(fa - fb) / np.linalg.norm(fb))


def _max_diff(a, b):
    assert sorted(a) == sorted(b)
    return max(float(np.abs(np.asarray(a[k]) - np.asarray(b[k])).max())
               for k in a)


def _equal(a, b):
    return sorted(a) == sorted(b) and all(
        np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------

def test_tier_slots_follow_the_rule_and_stay_whole_when_uneven():
    """``sharding.tier_slots`` on shape-only meshes: pod p of P holds its
    block of M slots; no pod axis, or P not dividing M, keeps all M."""
    prod = mesh_mod.make_production_mesh(multi_pod=True)
    assert list(shd.tier_slots(prod, 4)) == [0, 1]
    assert list(shd.tier_slots(prod, 5)) == [0, 1, 2, 3, 4]
    single = mesh_mod.make_production_mesh(multi_pod=False)
    assert list(shd.tier_slots(single, 4)) == [0, 1, 2, 3]


@pytest.mark.parametrize("M", [4, 5])
@pytest.mark.parametrize("codec", CODECS)
def test_slots_are_the_reference_addressable_shards(runs, M, codec):
    refs, ranks, _, _ = runs
    ref = refs[4][(M, codec)]
    assert ref["mesh"] == {"pod": 2, "data": 2, "model": 1}
    for r, info in enumerate(ranks[4]):
        got = info[(M, codec, True)]
        assert got["mesh"] == ref["mesh"]
        assert got["slots"] == ref["slots"][r]
        assert got["held"][0] == len(ref["slots"][r])
        # without the flag every rank holds the whole stack
        assert info[(M, codec, False)]["slots"] == list(range(M))
    if M == 4:
        assert [i[(M, codec, True)]["slots"] for i in ranks[4]] == \
            [[0, 1], [0, 1], [2, 3], [2, 3]]


def test_topology_silo_slots_are_the_reference_addressable_shards(runs):
    refs, ranks, _, _ = runs
    ref = refs[2]["topology"]
    assert ref["mesh"] == {"pod": 2, "data": 1, "model": 1}
    assert ref["slots"] == [[0], [1]]
    for r, info in enumerate(ranks[2]):
        got = info["topology"]
        assert got["mesh"] == ref["mesh"]
        assert got["slots"] == ref["slots"][r] and got["held"][0] == 1


# ---------------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [4, 5])
@pytest.mark.parametrize("codec", CODECS)
def test_trajectory_against_the_reference(runs, M, codec):
    refs, ranks, _, _ = runs
    ref = refs[4][(M, codec)]
    for info in ranks[4]:
        got = info[(M, codec, True)]
        assert got["times"] == ref["times"]
        assert _rel(got["w"], ref["w"]) <= RTOL[codec]
        assert _rel(got["tiers"], ref["tiers"]) <= RTOL[codec]
    # every rank ends with the same models
    first = ranks[4][0][(M, codec, True)]
    for info in ranks[4][1:]:
        assert _equal(info[(M, codec, True)]["w"], first["w"])
        assert _equal(info[(M, codec, True)]["tiers"], first["tiers"])


@pytest.mark.parametrize("codec", CODECS)
def test_sharded_against_the_unsharded_port_run(runs, codec):
    """M = 5 over 2 pods: the stack stays whole and the run is bitwise the
    unsharded one; M = 4: Eq. 3 re-associated, within the pin."""
    ranks = runs[1][4]
    for info in ranks:
        whole, split = info[(5, codec, False)], info[(5, codec, True)]
        assert split["held"][0] == 5
        assert split["times"] == whole["times"]
        assert _equal(split["w"], whole["w"])
        assert _equal(split["tiers"], whole["tiers"])
        whole, split = info[(4, codec, False)], info[(4, codec, True)]
        assert split["times"] == whole["times"]
        assert _max_diff(split["w"], whole["w"]) <= ATOL[codec]
        assert _max_diff(split["tiers"], whole["tiers"]) <= ATOL[codec]


def test_topology_on_two_pods_against_reference_and_one_rank(runs):
    refs, ranks, one, _ = runs
    ref = refs[2]["topology"]
    for info in ranks[2]:
        got = info["topology"]
        assert got["times"] == ref["times"] == one["times"]
        assert _rel(got["w"], ref["w"]) <= TOPO_RTOL
        # two silos: Eq. 3 is one add however the stack is split
        assert _equal(got["w"], one["w"])
        assert _equal(got["tiers"], one["tiers"])


# ---------------------------------------------------------------------------
# snapshots across pod counts
# ---------------------------------------------------------------------------

def test_snapshot_of_one_rank_resumes_on_two_pods(runs):
    _, ranks, one, _ = runs
    for info in ranks[2]:
        got = info["resumed"]
        assert got["held"][0] == 1
        assert got["times"] == one["times"]
        assert _equal(got["w"], one["w"])
        assert _equal(got["tiers"], one["tiers"])


def test_snapshot_of_two_pods_resumes_on_one_rank(runs):
    _, _, one, resumed = runs
    assert resumed["times"] == one["times"]
    assert _equal(resumed["w"], one["w"])
    assert _equal(resumed["tiers"], one["tiers"])
