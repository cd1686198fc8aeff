"""The port's mesh layer (launch/mesh.py, runtime/sharding.py, the
``MeshSpec`` section) against the JAX reference.

* The mesh-name grammar: ``parse_mesh_name`` results and every error
  message equal to the reference's; ``resolve_mesh`` on one rank (the
  reference's one device) and its divisibility error, whose hint names
  launching ranks instead of ``XLA_FLAGS``.
* ``_resolve`` equal to the reference's ``_resolve`` (given a mesh that
  has only ``.shape``: the rules read nothing else) for the default
  rules, overrides, a duplicate axis and an axis the mesh lacks, and for
  every leaf of ``lm.param_axes`` of every registered config at tp = 16
  on both production shapes.
* ``tp_size`` / ``mesh_axis_size`` / ``logical_sharding`` under
  ``use_mesh``; ``shard`` the identity; a one-rank host mesh is ``(data=1,
  model=1)``; the production meshes are shape-only.
* ``MeshSpec``: ``from_name`` round trips and ``validate`` messages word
  for word (the static pad error of the production mesh included);
  tests/test_torch_api.py holds a ``mesh.kind=host`` spec's hashes.
"""
import types

import pytest
import torch

from repro import api as japi
from repro.configs import registry as jregistry
from repro.launch import mesh as jmesh
from repro.models import lm as jlm
from repro.runtime import sharding as jshd
from repro_torch import api as tapi
from repro_torch.configs import registry as tregistry
from repro_torch.launch import mesh as tmesh
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.runtime import sharding as tshd

torch.set_num_threads(1)

SHAPES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16},
          "host": {"data": 4, "model": 1}}


def _duck(shape):
    return types.SimpleNamespace(shape=dict(shape))


def _errors(fn, arg):
    try:
        return ("ok", fn(arg))
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("name", [None, "single", "host", "host:4",
                                  "production", "production:2", "cluster",
                                  "host:x", "host:0", "production:3",
                                  "host:-1"])
def test_parse_mesh_name_matches_reference(name):
    assert _errors(tmesh.parse_mesh_name, name) == \
        _errors(jmesh.parse_mesh_name, name)


def test_resolve_mesh_on_one_rank():
    assert tmesh.resolve_mesh(None) is None
    assert jmesh.resolve_mesh(None) is None
    m = tmesh.resolve_mesh("host")
    assert m.shape == {"data": 1, "model": 1} and m.size == 1
    assert m is tmesh.make_host_mesh()
    # host:2 on one rank: the indivisible count fails loudly on the
    # declarative path, falls back to one pod for direct callers
    msgs = []
    for mod in (jmesh, tmesh):
        with pytest.raises(ValueError) as e:
            mod.resolve_mesh("host:2")
        msgs.append(str(e.value))
    head = "mesh 'host:2' needs a "
    assert msgs[0].startswith(head + "device count divisible by n_pods=2")
    assert msgs[1].startswith(head + "world size divisible by n_pods=2")
    assert "torch.distributed.run --nproc-per-node" in msgs[1]
    assert tmesh.make_host_mesh(n_pods=2).shape == {"data": 1, "model": 1}
    p = tmesh.resolve_mesh("production:2")
    assert p.shape == {"pod": 2, "data": 16, "model": 16} and p.size == 512
    assert not p.runnable
    with pytest.raises(ValueError, match="shape-only"):
        p.require_runnable("a round")
    assert tmesh.MESH_KINDS == jmesh.MESH_KINDS
    assert tmesh.STATIC_DATA_AXIS == jmesh.STATIC_DATA_AXIS


def test_one_rank_mesh():
    m = tmesh.make_mesh((1, 1, 1), ("pod", "data", "model"))
    assert m.coords == {"pod": 0, "data": 0, "model": 0} and m.rank == 0
    assert tmesh.world_size() == 1 and tmesh.is_writer()
    assert tmesh.default_backend(torch.device("cpu"), 2) == "gloo"


RULE_CASES = [
    (("batch", None, "tp"), None),
    (("batch",), {"batch": ("pod", "data")}),
    (("batch", "tp"), {"batch": None}),
    (("a", "b"), {"a": "data", "b": "data"}),           # duplicate axis
    (("tiers", "clients", "fsdp"), None),              # pod absent / used
    (("cache_batch", "kv_seq", "kv_heads", None), None),
    (("experts", "fsdp", "tp"), None),
    (("nope", "layers", "embed"), None),
]


@pytest.mark.parametrize("mesh", sorted(SHAPES))
@pytest.mark.parametrize("axes,rules", RULE_CASES)
def test_resolve_matches_reference(mesh, axes, rules):
    duck = _duck(SHAPES[mesh])
    jr = dict(jshd.DEFAULT_RULES, **(rules or {}))
    tr = dict(tshd.DEFAULT_RULES, **(rules or {}))
    assert tshd._resolve(axes, duck, tr) == tuple(
        jshd._resolve(axes, duck, jr))


@pytest.mark.parametrize("arch", tregistry.ARCH_IDS)
def test_param_axes_resolve_as_reference_at_tp16(arch):
    assert tshd.DEFAULT_RULES == jshd.DEFAULT_RULES
    tcfg, jcfg = tregistry.get_config(arch), jregistry.get_config(arch)
    tax = tcommon.flatten_tree(tlm.param_axes(tcfg, 16))
    jax_ = tcommon.flatten_tree(jlm.param_axes(jcfg, 16))
    assert sorted(tax) == sorted(jax_)
    for mesh in ("single", "multi"):
        duck = _duck(SHAPES[mesh])
        for k, ax in tax.items():
            assert ax == jax_[k], (arch, k)
            got = tshd._resolve(ax, duck, tshd.DEFAULT_RULES)
            want = tuple(jshd._resolve(jax_[k], duck, jshd.DEFAULT_RULES))
            assert got == want, (arch, mesh, k)


def test_ambient_mesh_helpers():
    p = tmesh.make_production_mesh(multi_pod=True)
    assert tshd.tp_size() == 1 and tshd.current_mesh() is None
    assert tshd.logical_sharding(("batch",)) is None
    with tshd.use_mesh(p, {"batch": None}):
        assert tshd.tp_size() == 16 and tshd.mesh_axis_size("pod") == 2
        assert tshd.mesh_axis_size("nope") == 1
        assert tshd.logical_sharding(("batch", "tp")) == (None, "model")
        x = torch.ones(3)
        assert tshd.shard(x, "batch") is x
        tree = tshd.tree_shardings({"w": ("fsdp", "tp"), "b": ("tp",)})
        assert tree == {"w": ("data", "model"), "b": ("model",)}
    assert tshd.tree_shardings({"w": ("fsdp",)}) == {"w": None}
    assert tshd.current_rules() == tshd.DEFAULT_RULES
    # a device's bytes: each sharded dim split (an uneven one padded up)
    assert tshd.device_bytes((32, 10), 4, ("data", None), p) == 2 * 10 * 4
    assert tshd.device_bytes((17, 10), 2, (("pod", "data"), "model"), p) \
        == 1 * 1 * 2
    assert tshd.shard_factors(("data", ("pod", "model")), p) == (16, 32)


@pytest.mark.parametrize("spec", [(None, False), ("host", False),
                                  ("host:2", False), ("host:2", True),
                                  ("production", False),
                                  ("production:2", True)])
def test_mesh_spec_round_trips(spec):
    name, shard = spec
    for api in (japi, tapi):
        m = api.MeshSpec.from_name(name, shard_tiers=shard)
        back = api.MeshSpec.from_name(m.to_name(), shard_tiers=shard)
        assert (back.kind, back.n_pods, back.shard_tiers) == \
            (m.kind, m.n_pods, shard)
    t = tapi.MeshSpec.from_name(name, shard_tiers=shard)
    j = japi.MeshSpec.from_name(name, shard_tiers=shard)
    assert (t.kind, t.n_pods, t.to_name()) == (j.kind, j.n_pods, j.to_name())


@pytest.mark.parametrize("overrides", [
    {"mesh.kind": "cluster"}, {"mesh.n_pods": 2},
    {"mesh.kind": "host", "mesh.shard_tiers": True},
    {"mesh.kind": "host", "mesh.n_pods": 0},
    {"mesh.kind": "production", "mesh.n_pods": 3},
    {"mesh.kind": "production"},
    {"mesh.kind": "production", "topology.n_silos": 2,
     "tiers.n_tiers": 1, "tiers.clients_per_round": 32,
     "topology.clients_per_edge": 3},
])
def test_mesh_spec_errors_match_reference(overrides):
    msgs = []
    for api in (japi, tapi):
        with pytest.raises(api.SpecError) as e:
            api.ExperimentSpec().with_overrides(overrides).validate()
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0]


def test_production_pad_validation_is_static():
    spec = tapi.ExperimentSpec(mesh=tapi.MeshSpec(kind="production"))
    with pytest.raises(tapi.SpecError,
                       match=r"clients_per_round=10.*multiple of 16"):
        spec.validate()
    spec.tiers.clients_per_round = 32
    spec.validate()
