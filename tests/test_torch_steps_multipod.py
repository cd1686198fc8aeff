"""The multi-pod FedAT trainer step (pods as tiers) and the data-parallel
single-pod step, against the JAX reference (tests/test_steps_multipod.py).

* The reference's four tests (steps and counts advance, the pods converge
  at a sync, the loss falls on a repeated batch, the single-pod step
  trains granite-moe smoke) on one rank with a pod dim of 1, and on 2
  gloo ranks (``launch/mesh.py`` ``run_ranks``), one pod a rank, where
  the pods differ after step 1 and are bitwise equal after step 2's
  sync.
* Against the reference's ``make_fedat_step`` on a forced 2-device host
  mesh ``(pod=2, data=1, model=1)`` in one JAX subprocess: the port's 2
  ranks start from the reference's params and take the same 3 batches,
  at bits 16, 8, 4 and 0.  Losses within ``LOSS_RTOL`` relative and every
  pod's params within ``PARAM_ATOL[bits]`` of the reference's after each
  step (fp32 sums in another order through AdamW; at 16 bits a value
  within rounding noise of a code boundary takes the neighbouring code,
  one int16 step).  Measured on the CPU: losses 2.0e-7 relative at every
  width; params 2.2e-7 after step 1, and after the sync 6.4e-6 (16 bits:
  one int16 code), 6.0e-8 (8 and 4), 1.1e-7 (0).  Each width's bound
  sits a few times above its own reading, so the 8-, 4- and 0-bit bounds
  admit no code flip.
* ``split_batch_for_pods`` equal to the reference's; ``quantize_rows``
  codes and scales equal to the reference's ``_mix_leaf`` arithmetic,
  bitwise.
* ``make_single_pod_step`` on 2 data ranks within ``DP_ATOL`` of one
  rank after 2 steps (each rank's half batch, gradients averaged over the
  ranks: the mean re-associates the sum).  Measured 1.9e-8, the losses
  equal.  The 2 ranks hold the state sharded over ``data`` (FSDP), each
  its own half of every split leaf; the params gathered are compared.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import steps as jsteps
from repro_torch.configs import TrainConfig as TTrainConfig
from repro_torch.configs.registry import get_smoke_config as tsmoke
from repro_torch.core import steps as tsteps
from repro_torch.launch import mesh as mesh_mod

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BITS = (16, 8, 4, 0)
LOSS_RTOL = 1e-5
#: per width, from its own reading (docstring): one int16 code at 16 bits,
#: fp32 reassociation noise at 8, 4 and 0
PARAM_ATOL = {16: 2e-5, 8: 1e-6, 4: 1e-6, 0: 1e-6}
DP_ATOL = 1e-5

_JAX = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import TrainConfig, registry
    from repro.core import steps
    from repro.launch import mesh as mesh_mod
    from repro.runtime import sharding as shd

    cfg = registry.get_smoke_config("qwen2-7b")
    mesh = mesh_mod.make_mesh((2, 1, 1), ("pod", "data", "model"))
    batches = [np.random.default_rng(i).integers(
        0, cfg.vocab_size, (2, 4, 128)).astype(np.int32) for i in range(3)]
    res = {"batches": batches}
    for bits in (16, 8, 4, 0):
        tcfg = TrainConfig(fedat_enabled=True, fedat_sync_every=2,
                           fedat_compress_bits=bits, lr=1e-3)
        with mesh, shd.use_mesh(mesh):
            fns = steps.make_fedat_step(cfg, tcfg, mesh)
            state = jax.jit(fns.init_state)(jax.random.PRNGKey(0))
            res["init"] = jax.tree.map(lambda a: np.asarray(a[0]),
                                       state["params"])
            fn = jax.jit(fns.train_step)
            losses, snaps = [], []
            for b in batches:
                state, m = fn(state, {"tokens": jnp.asarray(b)})
                losses.append(float(m["loss"]))
                snaps.append(jax.tree.map(np.asarray, state["params"]))
        res[bits] = {"losses": losses, "params": snaps}
    with open(sys.argv[1], "wb") as f:
        pickle.dump(res, f)
""")

_RANK = textwrap.dedent("""
    import pickle, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    from repro_torch.configs import TrainConfig
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core import steps
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import common
    from repro_torch.models.convert import params_from_numpy, params_to_numpy
    from repro_torch.optim.optimizers import tree_map

    mesh_mod.init_from_env(torch.device("cpu"))
    ref_path, out_path = sys.argv[1], sys.argv[2].format(mesh_mod.rank())
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    cfg = get_smoke_config("qwen2-7b")
    mesh = mesh_mod.make_mesh((2, 1, 1), ("pod", "data", "model"))
    out = {"rank": mesh_mod.rank(), "pod": mesh.coord("pod")}

    def snap(state):
        # a copy: the step updates the params in place
        return params_to_numpy(tree_map(lambda a: a[0].clone(),
                                        state["params"]))

    # against the reference, from its params, at each width
    for bits in (16, 8, 4, 0):
        tcfg = TrainConfig(fedat_enabled=True, fedat_sync_every=2,
                           fedat_compress_bits=bits, lr=1e-3)
        fns = steps.make_fedat_step(cfg, tcfg, mesh, device="cpu")
        state = fns.init_state(0)
        state["params"] = tree_map(lambda a: a.unsqueeze(0),
                                   params_from_numpy(ref["init"],
                                                     device="cpu"))
        losses, snaps, sent = [], [], []
        for b in ref["batches"]:
            state, m = fns.train_step(state, {"tokens": b})
            losses.append(float(m["loss"]))
            snaps.append(snap(state))
            sent.append(float(m["payload_bytes"]))
        out[bits] = {"losses": losses, "params": snaps, "sent": sent}

    # elastic.reshard onto the mesh: a full 2-pod state keeps this rank's
    # pod slot, the update counts whole
    from repro_torch.runtime import elastic
    full = {"params": {"w": torch.arange(6.).reshape(2, 3)},
            "opt": {"m": {"w": torch.zeros(2, 3)}, "count": torch.zeros(
                2, dtype=torch.int32)},
            "step": torch.zeros(2, dtype=torch.int32),
            "counts": torch.tensor([1.0, 2.0])}
    mine = elastic.reshard(full, mesh, device="cpu")
    out["reshard"] = {"w": mine["params"]["w"].tolist(),
                      "count": mine["opt"]["count"].tolist(),
                      "counts": mine["counts"].tolist()}

    # the reference's four tests, on this pod
    tcfg = TrainConfig(fedat_enabled=True, fedat_sync_every=2,
                       fedat_compress_bits=8, lr=1e-3)
    fns = steps.make_fedat_step(cfg, tcfg, mesh, device="cpu")
    state = fns.init_state(0)
    batch = lambda seed: {"tokens": np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, 4, 128)).astype(np.int32)}
    for i in range(3):
        state, m = fns.train_step(state, batch(i))
    out["advance"] = {"step": int(state["step"][0]),
                      "counts": state["counts"].tolist(),
                      "loss": float(m["loss"])}
    state = fns.init_state(0)
    state, _ = fns.train_step(state, batch(0))
    out["after1"] = snap(state)
    state, _ = fns.train_step(state, batch(1))
    out["after2"] = snap(state)
    state = fns.init_state(0)
    losses = []
    for _ in range(8):
        state, m = fns.train_step(state, batch(42))
        losses.append(float(m["loss"]))
    out["repeat_losses"] = losses

    # single-pod step: 2 data ranks against one (a dense model: MoE
    # routing groups and its load-balancing loss depend on the batch split)
    dp = mesh_mod.make_mesh((2, 1), ("data", "model"))
    one = steps.make_single_pod_step(cfg, TrainConfig(lr=1e-3),
                                     device="cpu")
    two = steps.make_single_pod_step(cfg, TrainConfig(lr=1e-3), dp,
                                     device="cpu")
    s1, s2 = one.init_state(0), two.init_state(0)
    b = {"tokens": np.random.default_rng(5).integers(
        0, cfg.vocab_size, (4, 128)).astype(np.int32)}
    l1, l2 = [], []
    for _ in range(2):
        s1, m1 = one.train_step(s1, b)
        s2, m2 = two.train_step(s2, b)
        l1.append(float(m1["loss"]))
        l2.append(float(m2["loss"]))
    # the 2-rank state is sharded over data: the whole params gathered
    from repro_torch.runtime import sharding as shd
    whole = shd.FSDP.over(dp).gather_tree(s2["params"],
                                          two.state_shardings["params"])
    out["dp"] = {"losses": [l1, l2], "params": [
        params_to_numpy(s1["params"]), params_to_numpy(whole)],
        "shards": params_to_numpy(s2["params"]),
        "split": {k: shd.split_dim(v) for k, v in common.flatten_tree(
            two.state_shardings["params"]).items()}}
    # the reference's single-pod test, on 2 data ranks
    g = get_smoke_config("granite-moe-3b-a800m")
    two = steps.make_single_pod_step(g, TrainConfig(lr=1e-3), dp,
                                     device="cpu")
    s2 = two.init_state(0)
    b = {"tokens": np.ones((4, 128), np.int32)}
    losses = []
    for _ in range(5):
        s2, m = two.train_step(s2, b)
        losses.append(float(m["loss"]))
    out["dp_train"] = {"losses": losses, "step": int(s2["step"])}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    mesh_mod.shutdown()
""")


def _leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return _run_both(tmp_path_factory.mktemp("multipod"))


def _run_both(d):
    """The reference on 2 forced devices, then the port on 2 gloo ranks
    from the reference's params (one subprocess each)."""
    ref_path = str(d / "ref.pkl")
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", _JAX, ref_path],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = mesh_mod.run_ranks(
        ["-c", _RANK, ref_path, str(d / "rank{}.pkl")], 2, timeout=600,
        env={"PYTHONPATH": os.path.join(REPO, "src"),
             "OMP_NUM_THREADS": "1"})
    assert all(rc == 0 for rc, _, _ in res), [e[-3000:] for _, _, e in res]
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    ranks = []
    for r in range(2):
        with open(str(d / f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    return ref, sorted(ranks, key=lambda r: r["pod"])


# ---------------------------------------------------------------------------
# one rank: pod dim 1
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank():
    mesh = mesh_mod.make_mesh((1, 1, 1), ("pod", "data", "model"))
    cfg = tsmoke("qwen2-7b")
    tcfg = TTrainConfig(fedat_enabled=True, fedat_sync_every=2,
                        fedat_compress_bits=8, lr=1e-3)
    return cfg, tsteps.make_fedat_step(cfg, tcfg, mesh, device="cpu")


def _batch(cfg, n_pods, B=4, S=128, seed=0):
    return {"tokens": np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (n_pods, B, S)).astype(np.int32)}


def test_counts_and_steps_advance(one_rank, runs):
    cfg, fns = one_rank
    state = fns.init_state(0)
    assert state["params"]["embed"].shape[0] == 1    # pod dim 1
    for i in range(3):
        state, m = fns.train_step(state, _batch(cfg, 1, seed=i))
    assert int(state["step"][0]) == 3
    np.testing.assert_allclose(state["counts"].numpy(), 3.0)
    assert np.isfinite(float(m["loss"]))
    for r in runs[1]:
        a = r["advance"]
        assert a["step"] == 3 and a["counts"] == [3.0, 3.0]
        assert np.isfinite(a["loss"])
    assert runs[1][0]["advance"]["loss"] == runs[1][1]["advance"]["loss"]


def test_pods_converge_at_sync(runs):
    p0, p1 = runs[1]
    a0, a1 = _leaves(p0["after1"]), _leaves(p1["after1"])
    # pods diverged: each trained its own rows (the token embedding's
    # rows differ; AdamW's first step moves a norm gain by lr on both)
    assert not np.allclose(p0["after1"]["embed"], p1["after1"]["embed"])
    assert any(not np.array_equal(x, y) for x, y in zip(a0, a1))
    for x, y in zip(_leaves(p0["after2"]), _leaves(p1["after2"])):
        assert np.array_equal(x, y)                      # synced: bitwise


def test_loss_decreases_over_steps(one_rank, runs):
    cfg, fns = one_rank
    state = fns.init_state(0)
    b = _batch(cfg, 1, seed=42)
    losses = []
    for _ in range(8):
        state, m = fns.train_step(state, b)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    for r in runs[1]:
        assert r["repeat_losses"][-1] < r["repeat_losses"][0]


def test_single_pod_step_runs(runs):
    mesh = mesh_mod.make_mesh((1, 1), ("data", "model"))
    cfg = tsmoke("granite-moe-3b-a800m")
    fns = tsteps.make_single_pod_step(cfg, TTrainConfig(lr=1e-3), mesh,
                                      device="cpu")
    state = fns.init_state(0)
    b = {"tokens": np.ones((4, 128), np.int32)}
    losses = []
    for _ in range(5):
        state, m = fns.train_step(state, b)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] and int(state["step"]) == 5
    for r in runs[1]:
        t = r["dp_train"]
        assert t["losses"][-1] < t["losses"][0] and t["step"] == 5


# ---------------------------------------------------------------------------
# against the reference's forced 2-device step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", BITS)
def test_multipod_matches_reference(runs, bits):
    ref, ranks = runs
    want = ref[bits]
    for r in ranks:
        got = r[bits]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LOSS_RTOL)
        for step in range(3):
            g = _leaves(got["params"][step])
            w = [x[r["pod"]] for x in _leaves(want["params"][step])]
            assert len(g) == len(w)
            for x, y in zip(g, w):
                assert float(np.abs(x - y).max()) <= PARAM_ATOL[bits], \
                    (bits, step)
    # after the sync (step 2) the two pods hold the same params, bit for
    # bit; a sync step sends each rank's payload and scales, others none
    for x, y in zip(_leaves(ranks[0][bits]["params"][1]),
                    _leaves(ranks[1][bits]["params"][1])):
        assert np.array_equal(x, y)
    sent = ranks[0][bits]["sent"]
    assert sent[0] == sent[2] == 0 and sent[1] > 0


def test_payload_bytes_follow_the_width(runs):
    """At a sync a rank sends its pod's payload plus one fp32 scale a row:
    int16 twice int8's codes, int4 packed half of int8's where the last
    dim is even, fp32 four bytes a value and no scale."""
    sent = {b: runs[1][0][b]["sent"][1] for b in BITS}
    n = sum(x.size for x in _leaves(runs[0]["init"]))
    rows = sum(x.size // x.shape[-1] for x in _leaves(runs[0]["init"]))
    assert sent[0] == 4 * n
    assert sent[8] == n + 4 * rows and sent[16] == 2 * n + 4 * rows
    odd = sum(x.size for x in _leaves(runs[0]["init"]) if x.shape[-1] % 2)
    assert sent[4] == (n - odd) // 2 + odd + 4 * rows


def test_split_batch_and_quantize_rows_match_reference():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 100, (8, 16)).astype(np.int32)
    want = np.asarray(jsteps.split_batch_for_pods(
        {"tokens": jnp.asarray(toks)}, 2)["tokens"])
    got = tsteps.split_batch_for_pods({"tokens": torch.from_numpy(toks)},
                                      2)["tokens"]
    assert np.array_equal(got.numpy(), want)
    meta = tsteps.split_batch_for_pods(
        {"tokens": torch.empty((8, 16), device="meta")}, 2)["tokens"]
    assert tuple(meta.shape) == (2, 4, 16)
    x = rng.normal(0, 1, (6, 10)).astype(np.float32)
    x[2] = 0.0                                # an all-zero row: 1e-30 scale
    for bits in (16, 8, 4):
        qmax = 7.0 if bits == 4 else float((1 << (bits - 1)) - 1)
        xf = jnp.asarray(x)
        scale = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
                            / qmax, 1e-30)
        q = jnp.clip(jnp.round(xf / scale), -qmax, qmax)
        pay, sc = tsteps.quantize_rows(torch.from_numpy(x), bits)
        assert np.array_equal(sc.numpy(), np.asarray(scale))
        if bits == 4:
            pairs = (q + 8.0).reshape(6, 5, 2)
            want = np.asarray((pairs[..., 0] * 16 + pairs[..., 1]).astype(
                jnp.uint8))
            back = tsteps.dequantize_rows(pay, sc, (6, 10))
            assert np.array_equal(back.numpy(), np.asarray(q * scale))
        else:
            want = np.asarray(q.astype(jnp.int8 if bits <= 8
                                       else jnp.int16))
        assert np.array_equal(pay.numpy(), want)


def test_single_pod_step_on_two_data_ranks(runs):
    r = runs[1][0]["dp"]
    (l1, l2) = r["losses"]
    np.testing.assert_allclose(l2, l1, rtol=DP_ATOL)
    for x, y in zip(_leaves(r["params"][0]), _leaves(r["params"][1])):
        assert float(np.abs(x - y).max()) <= DP_ATOL
    # both ranks gather the same state, each holding its own block of
    # every leaf split over data and the rest whole
    a, b = runs[1][0]["dp"], runs[1][1]["dp"]
    for x, y in zip(_leaves(a["params"][1]), _leaves(b["params"][1])):
        assert np.array_equal(x, y)
    from repro_torch.models.common import flatten_tree
    whole = flatten_tree(a["params"][1])
    for rank, r in enumerate((a, b)):
        for name, shard in flatten_tree(r["shards"]).items():
            dim = r["split"][name]
            if dim is None:
                assert np.array_equal(shard, whole[name])
                continue
            n = shard.shape[dim]
            assert whole[name].shape[dim] == 2 * n
            assert np.array_equal(shard, np.take(
                whole[name], range(rank * n, (rank + 1) * n), axis=dim))


def test_reshard_keeps_each_ranks_pod_slot(runs):
    for r in runs[1]:
        p = r["pod"]
        assert r["reshard"] == {"w": [[3.0 * p, 3.0 * p + 1, 3.0 * p + 2]],
                                "count": [0], "counts": [1.0, 2.0]}


def test_fedat_step_needs_a_pod_axis():
    cfg = tsmoke("qwen2-7b")
    with pytest.raises(ValueError, match="pod"):
        tsteps.make_fedat_step(cfg, TTrainConfig(), None, device="cpu")
    with pytest.raises(ValueError, match="shape-only"):
        tsteps.make_fedat_step(
            cfg, TTrainConfig(), mesh_mod.make_production_mesh(
                multi_pod=True), device="cpu")


def test_trainer_multipod_on_two_ranks(tmp_path):
    """``launch/train.py --multi-pod --codec quantize8`` on 2 ranks: one
    pod a rank, the same loss logged on both (the mean over pods), each
    pod's first data rank writing its slot under ``<ckpt-dir>/pod<p>``."""
    ck = tmp_path / "ck"
    res = mesh_mod.run_ranks(
        ["-m", "repro_torch.launch.train", "--smoke", "--multi-pod",
         "--codec", "quantize8", "--fedat-sync-every", "2", "--steps", "3",
         "--ckpt-every", "2", "--ckpt-dir", str(ck), "--device", "cpu"],
        2, timeout=300, env={"PYTHONPATH": os.path.join(REPO, "src"),
                             "OMP_NUM_THREADS": "1"})
    assert [rc for rc, _, _ in res] == [0, 0], [e[-2000:] for *_, e in res]
    last = [[x for x in e.splitlines() if "step 3 loss" in x][0]
            for _, _, e in res]
    assert last[0] == last[1]
    for p in ("pod0", "pod1"):
        assert sorted(os.listdir(ck / p)) == [f"step_{2:010d}",
                                              f"step_{3:010d}"]
