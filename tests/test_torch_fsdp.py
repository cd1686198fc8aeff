"""FSDP (ZeRO-3) over ``data``: the trainer's params and AdamW moments
held as 1/D shards, gathered one layer at a time, gradients
reduce-scattered, against the JAX reference's GSPMD layouts and steps.

The reference runs in one JAX subprocess on 4 forced host devices; the
port's ranks run as gloo processes (``launch/mesh.py`` ``run_ranks``).

* Layout: the reference's ``init_state`` params, jitted with its
  ``state_shardings`` on a ``(data=2, model=1)`` and a ``(data=4,
  model=1)`` mesh, carried over (models/convert.py): each port rank's
  shard of every leaf (``sharding.local_shard``) is bitwise the
  reference's ``addressable_shards`` on that rank's device, and a
  rank's bytes of params, ``m`` and ``v`` equal the dry-run's
  ``device_bytes`` arithmetic.  An uneven split raises, as jax does.
* Single-pod, 2 steps, microbatch 2, from the carried params, on 2 and 4
  ranks: losses, ``grad_norm`` and the gathered params against the
  one-rank port run (``DP_ATOL``/``DP_RTOL``) and against the
  reference's step jitted on the forced mesh (``REF_ATOL``/``REF_RTOL``).
* Families: one case per layer loop (dense, moe, audio through
  ``transformer._run_layers``, rwkv6's, zamba2's with its shared block),
  smoke configs from the reference's params, 2 steps on 2 ranks with
  microbatch 1 against one rank with microbatch 2 on the same global
  batch (its two microbatches are the ranks' rows, so MoE routing and
  its aux loss see the same split; ``FAMILY_ATOL``) and against the
  reference's step at microbatch 2 on the ``(data=2)`` mesh
  (``FAMILY_REF_ATOL``); the shards of the 2-rank ``init_state`` are
  blocks of the one-rank draws, bitwise.
* No whole stack: under remat the gather's counter of live gathered
  bytes never holds more than one layer's leaves plus the embedding and
  head; without remat it sees every layer's (the matmuls save them).

Tolerances, pinned beside their readings on the CPU.  2 and 4 ranks
against one rank: losses 9.8e-8 relative, grad_norm 1.2e-7, params
5.0e-6 (D = 2) and 3.9e-6 (D = 4); against the reference: losses 9.8e-8,
grad_norm 1.3e-7, params 3.3e-5 / 3.0e-5, where the one-rank port itself
reads 2.8e-5 / 2.6e-5 from the reference on the same inputs.  The
params' worst leaf is ``w_out`` every time: AdamW's first steps move a
value by lr * g / (|g| + eps), so where |g| is near eps a gradient summed
in another order moves it by a fraction of lr (1e-3 here).  Families
against one rank: losses equal, params 3.0e-8; against the reference:
losses 9.9e-8 relative, params 3.2e-6 (rwkv6; 1.5e-7 the others), each
what the one-rank port itself reads from the reference.
"""
import os
import pickle
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import TrainConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core import steps
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import common, lm
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.runtime import sharding as shd

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ("qwen2-7b", "granite-moe-3b-a800m", "hubert-xlarge",
            "rwkv6-3b", "zamba2-2.7b")
#: readings in the module docstring; each bound a few times above its own
DP_ATOL, DP_RTOL = 2e-5, 1e-6
REF_ATOL, REF_RTOL = 1e-4, 1e-6
FAMILY_ATOL, FAMILY_RTOL = 2e-7, 1e-6
FAMILY_REF_ATOL, FAMILY_REF_RTOL = 1e-5, 1e-6
TCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10)
B, S = 8, 64

_JAX = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import TrainConfig, registry
    from repro.core import steps
    from repro.configs.shapes import ShapeConfig
    from repro.data.pipeline import TokenPipeline
    from repro.launch import mesh as mesh_mod
    from repro.runtime import sharding as shd

    B, S = %d, %d
    cfg = registry.get_smoke_config("qwen2-7b").replace(microbatch=2)
    tcfg = TrainConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    batches = [np.random.default_rng(10 + i).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32) for i in range(2)]
    res = {"batches": batches}

    def named(tree, prefix=""):
        out = {}
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                out.update(named(tree[k], prefix + k + "/"))
            else:
                out[prefix + k] = tree[k]
        return out

    for D in (2, 4):
        mesh = mesh_mod.make_mesh((D, 1), ("data", "model"))
        with mesh, shd.use_mesh(mesh):
            fns = steps.make_single_pod_step(cfg, tcfg, mesh)
            state = jax.jit(fns.init_state, out_shardings=fns.state_shardings)(
                jax.random.PRNGKey(0))
            init = jax.tree.map(np.array, state["params"])
            shards = {}
            for name, x in named(state["params"]).items():
                by_dev = {s.device: np.array(s.data)
                          for s in x.addressable_shards}
                shards[name] = [by_dev[mesh.devices[r, 0]] for r in range(D)]
            fn = jax.jit(fns.train_step,
                         in_shardings=(fns.state_shardings,
                                       fns.batch_shardings),
                         out_shardings=(fns.state_shardings, None))
            losses, norms, params = [], [], []
            for b in batches:
                state, m = fn(state, {"tokens": jnp.asarray(b)})
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                params.append(jax.tree.map(np.array, state["params"]))
        res[D] = {"init": init, "shards": shards, "losses": losses,
                  "grad_norm": norms, "params": params}
    # each layer loop on the (data=2) mesh, microbatch 2 (a slice a rank)
    mesh = mesh_mod.make_mesh((2, 1), ("data", "model"))
    res["families"] = {}
    for arch in sys.argv[2].split(","):
        fcfg = registry.get_smoke_config(arch).replace(microbatch=2)
        pipe = TokenPipeline(fcfg, ShapeConfig("s", 64, 4, "train"), seed=0)
        with mesh, shd.use_mesh(mesh):
            fns = steps.make_single_pod_step(fcfg, TrainConfig(lr=1e-3), mesh)
            state = jax.jit(fns.init_state, out_shardings=fns.state_shardings)(
                jax.random.PRNGKey(1))
            init = jax.tree.map(np.array, state["params"])
            fn = jax.jit(fns.train_step,
                         in_shardings=(fns.state_shardings,
                                       fns.batch_shardings),
                         out_shardings=(fns.state_shardings, None))
            losses = []
            for i in range(2):
                state, m = fn(state, {k: jnp.asarray(v)
                                      for k, v in pipe.batch(i).items()})
                losses.append(float(m["loss"]))
        res["families"][arch] = {
            "init": init, "losses": losses,
            "params": jax.tree.map(np.array, state["params"])}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(res, f)
""" % (B, S))

_RANK = textwrap.dedent("""
    import pickle, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    from repro_torch.configs import TrainConfig
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.core import steps
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models.convert import params_from_numpy, params_to_numpy
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    from repro_torch.runtime import sharding as shd

    def snap(tree):
        # copies: the step updates the state in place
        return tree_map(np.copy, params_to_numpy(tree))

    mesh_mod.init_from_env(torch.device("cpu"))
    ref_path, out_path = sys.argv[1], sys.argv[2].format(mesh_mod.rank())
    families = [a for a in sys.argv[3].split(",") if a]
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    D = mesh_mod.world_size()
    mesh = mesh_mod.make_mesh((D, 1), ("data", "model"))
    out = {"rank": mesh_mod.rank(), "index": mesh.coord("data")}
    fsdp = shd.FSDP.over(mesh)          # the one every step on it uses

    def whole(fns, state):
        return snap(fsdp.gather_tree(
            state["params"], fns.state_shardings["params"]))

    # the layout and two steps from the reference's params
    cfg = get_smoke_config("qwen2-7b").replace(microbatch=2)
    fns = steps.make_single_pod_step(
        cfg, TrainConfig(lr=1e-3, warmup_steps=2, total_steps=10), mesh,
        device="cpu")
    state = fns.init_state(0)
    carried = shd.shard_tree(params_from_numpy(ref[D]["init"], device="cpu"),
                             fns.state_shardings["params"], mesh)
    out["shards"] = snap(carried)
    state["params"] = carried          # m and v: zeros of the shards
    out["state_bytes"] = sum(x.numel() * x.element_size() for x in
                             tree_leaves(state["params"])
                             + tree_leaves(state["opt"]["m"])
                             + tree_leaves(state["opt"]["v"]))
    losses, norms, params = [], [], []
    for b in ref["batches"]:
        state, m = fns.train_step(state, {"tokens": b})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        params.append(whole(fns, state))
    out["single_pod"] = {"losses": losses, "grad_norm": norms,
                         "params": params}
    try:
        shd.local_shard(torch.zeros(6, 3), ("data", None), mesh)
    except ValueError as e:
        out["uneven"] = str(e)

    # one case per layer loop: microbatch 1 a rank
    shape = ShapeConfig("s", 64, 4, "train")
    out["families"] = {}
    for arch in families:
        fcfg = get_smoke_config(arch).replace(microbatch=1)
        fns = steps.make_single_pod_step(fcfg, TrainConfig(lr=1e-3), mesh,
                                         device="cpu")
        state = fns.init_state(0)
        init = snap(state["params"])
        # from the reference's params
        state["params"] = shd.shard_tree(params_from_numpy(
            ref["families"][arch]["init"], device="cpu"),
            fns.state_shardings["params"], mesh)
        pipe = TokenPipeline(fcfg, shape, seed=0)
        losses = []
        for i in range(2):
            state, m = fns.train_step(state, pipe.batch(i))
            losses.append(float(m["loss"]))
        out["families"][arch] = {"init": init, "losses": losses,
                                 "params": whole(fns, state)}

    # live gathered bytes, 4 layers, with and without remat
    if families:
        out["live"] = {}
        for remat in (True, False):
            lcfg = get_smoke_config("qwen2-7b").replace(
                n_layers=4, microbatch=1, remat=remat)
            fns = steps.make_single_pod_step(lcfg, TrainConfig(), mesh,
                                             device="cpu")
            state = fns.init_state(0)
            fsdp.reset_stats()
            fns.train_step(state, TokenPipeline(lcfg, shape, seed=0).batch(0))
            out["live"][remat] = {"peak": fsdp.peak_live_bytes,
                                  "stats": dict(fsdp.stats)}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    mesh_mod.shutdown()
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("fsdp")
    ref_path = str(d / "ref.pkl")
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", _JAX, ref_path,
                           ",".join(FAMILIES)], capture_output=True,
                          text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = {}
    for D, fam in ((2, ",".join(FAMILIES)), (4, "")):
        store = d / f"store{D}"
        store.mkdir()
        res = mesh_mod.run_ranks(
            ["-c", _RANK, ref_path, str(d / f"d{D}_rank{{}}.pkl"), fam], D,
            timeout=600, store_dir=str(store),
            env={"PYTHONPATH": os.path.join(REPO, "src"),
                 "OMP_NUM_THREADS": "1"})
        assert all(rc == 0 for rc, _, _ in res), [e[-3000:] for *_, e in res]
        ranks = []
        for r in range(D):
            with open(d / f"d{D}_rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        out[D] = sorted(ranks, key=lambda x: x["index"])
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    return ref, out


def _flat(tree):
    return common.flatten_tree(tree)


def _snap(tree):
    """numpy copies (the step updates the state in place)."""
    return common.unflatten_tree({k: np.copy(v) for k, v in _flat(
        params_to_numpy(tree)).items()})


def _one_rank(cfg, batches, init=None):
    """The one-rank port run: losses, grad_norms and params a step."""
    fns = steps.make_single_pod_step(cfg, TrainConfig(**TCFG), device="cpu")
    state = fns.init_state(0)
    if init is not None:
        state["params"] = params_from_numpy(init, device="cpu")
    losses, norms, params = [], [], []
    for b in batches:
        state, m = fns.train_step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        params.append(_snap(state["params"]))
    return losses, norms, params


def _max_diff(a, b):
    a, b = _flat(a), _flat(b)
    assert sorted(a) == sorted(b)
    return max(float(np.abs(a[k] - b[k]).max()) for k in a)


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [2, 4])
def test_shards_are_the_reference_addressable_shards(runs, D):
    ref, ranks = runs
    for r, info in enumerate(ranks[D]):
        got = _flat(info["shards"])
        assert sorted(got) == sorted(ref[D]["shards"])
        for name, want in ref[D]["shards"].items():
            assert got[name].shape == want[r].shape, name
            assert np.array_equal(got[name], want[r]), name


@pytest.mark.parametrize("D", [2, 4])
def test_state_bytes_are_the_dry_run_arithmetic(runs, D):
    """params, m and v (fp32) of one rank equal ``device_bytes`` of the
    layouts on the mesh, as the dry-run counts them: 1/D of each leaf
    with an fsdp axis, the others whole."""
    cfg = get_smoke_config("qwen2-7b")
    mesh = types.SimpleNamespace(shape={"data": D, "model": 1})
    want = split = kept = 0
    for _, spec in common.iter_specs(lm.param_specs(cfg, 1)):
        lay = shd._resolve(spec.axes, mesh, shd.DEFAULT_RULES)
        want += 3 * shd.device_bytes(spec.shape, 4, lay, mesh)
        nbytes = 3 * 4 * int(np.prod(spec.shape))
        if "fsdp" in spec.axes:
            split += nbytes
        else:
            kept += nbytes
    for info in runs[1][D]:
        assert info["state_bytes"] == want == split // D + kept


def test_uneven_split_is_refused(runs):
    """6 rows split 2 ways are 3 a rank; 4 ways the split is uneven, and
    the port refuses it as jax refuses such an array sharding."""
    for info in runs[1][2]:
        assert "uneven" not in info
    for info in runs[1][4]:
        assert "does not divide 6" in info["uneven"]


# ---------------------------------------------------------------------------
# single-pod steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D", [2, 4])
def test_single_pod_matches_one_rank_and_reference(runs, D):
    ref, ranks = runs
    cfg = get_smoke_config("qwen2-7b").replace(microbatch=2)
    batches = [{"tokens": b} for b in ref["batches"]]
    losses, norms, params = _one_rank(cfg, batches, ref[D]["init"])
    for info in ranks[D]:
        got = info["single_pod"]
        np.testing.assert_allclose(got["losses"], losses, rtol=DP_RTOL)
        np.testing.assert_allclose(got["grad_norm"], norms, rtol=DP_RTOL)
        np.testing.assert_allclose(got["losses"], ref[D]["losses"],
                                   rtol=REF_RTOL)
        np.testing.assert_allclose(got["grad_norm"], ref[D]["grad_norm"],
                                   rtol=REF_RTOL)
        for step in range(2):
            assert _max_diff(got["params"][step], params[step]) <= DP_ATOL
            assert _max_diff(got["params"][step],
                             ref[D]["params"][step]) <= REF_ATOL
    # every rank gathers the same params
    for info in ranks[D][1:]:
        assert _max_diff(info["single_pod"]["params"][1],
                         ranks[D][0]["single_pod"]["params"][1]) == 0.0


# ---------------------------------------------------------------------------
# the five layer loops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_family_on_two_ranks_matches_one_rank(runs, arch):
    ref = runs[0]["families"][arch]
    cfg = get_smoke_config(arch).replace(microbatch=2)
    pipe = TokenPipeline(cfg, ShapeConfig("s", 64, 4, "train"), seed=0)
    fns = steps.make_single_pod_step(cfg, TrainConfig(lr=1e-3),
                                     device="cpu")
    init = _flat(_snap(fns.init_state(0)["params"]))
    state = fns.init_state(0)
    state["params"] = params_from_numpy(ref["init"], device="cpu")
    losses = []
    for i in range(2):
        state, m = fns.train_step(state, pipe.batch(i))
        losses.append(float(m["loss"]))
    want = _snap(state["params"])
    split = _flat(shd.tree_shardings(lm.param_axes(cfg, 1),
                                     types.SimpleNamespace(
                                         shape={"data": 2, "model": 1})))
    for r, info in enumerate(runs[1][2]):
        got = info["families"][arch]
        np.testing.assert_allclose(got["losses"], losses, rtol=FAMILY_RTOL)
        assert _max_diff(got["params"], want) <= FAMILY_ATOL, arch
        np.testing.assert_allclose(got["losses"], ref["losses"],
                                   rtol=FAMILY_REF_RTOL)
        assert _max_diff(got["params"], ref["params"]) <= FAMILY_REF_ATOL
        # the rank drew the one-rank draws and kept its block
        for name, shard in _flat(got["init"]).items():
            dim = shd.split_dim(split[name])
            if dim is None:
                assert np.array_equal(shard, init[name]), name
                continue
            n = shard.shape[dim]
            assert np.array_equal(shard, np.take(
                init[name], range(r * n, (r + 1) * n), axis=dim)), name


def test_no_layer_outlives_its_block_under_remat(runs):
    """The live gathered bytes under remat stay at one layer's leaves
    plus the embedding and head; without remat every layer's are alive
    at once (the counter sees a whole stack when there is one)."""
    cfg = get_smoke_config("qwen2-7b").replace(n_layers=4)
    layer = outside = 0
    for path, spec in common.iter_specs(lm.param_specs(cfg, 1)):
        if "fsdp" not in spec.axes:
            continue
        nbytes = 4 * int(np.prod(spec.shape))
        if path[0] == "layers":
            layer += nbytes // cfg.n_layers
        else:
            outside += nbytes
    for info in runs[1][2]:
        remat, plain = info["live"][True], info["live"][False]
        assert remat["peak"] <= layer + outside, (remat, layer, outside)
        assert plain["peak"] >= cfg.n_layers * layer
        # one gather a layer forward and again in the recompute, the
        # embedding and head once; a reduce-scatter each but the recompute
        assert remat["stats"]["gathers"] == 2 * cfg.n_layers + 2
        assert plain["stats"]["gathers"] == cfg.n_layers + 2
        assert remat["stats"]["reduce_scatters"] == cfg.n_layers + 2
        assert plain["stats"]["reduce_scatters"] == cfg.n_layers + 2
