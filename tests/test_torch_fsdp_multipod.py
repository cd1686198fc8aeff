"""The multi-pod FedAT step with each pod's state sharded over its data
ranks (FSDP), against the JAX reference's ``make_fedat_step``.

The reference runs on a forced 4-device host mesh ``(pod=2, data=2,
model=1)`` in one JAX subprocess, jitted with its ``state_shardings``;
the port on 4 gloo ranks laid out the same way, from the reference's
params (each rank its pod slot and its data shard of every leaf).

* At bits 16, 8, 4 and 0: losses within ``LOSS_RTOL`` relative, and each
  pod's params, gathered over its data ranks, within ``PARAM_ATOL[bits]``
  of the reference's pod slot after each of 3 steps (sync every 2).  The
  pods are bitwise equal after the sync.  A rank sends its shard's
  payload and the scales of its rows: the dry-run's per-device sync
  bytes (``launch/dryrun.py`` ``sync_bytes``) on this mesh, half of what
  a pod of one data rank sends for the split leaves.
* ``quantize_shards``: where a leaf's last dimension is split over the
  data ranks, each rank's codes and scales are bitwise the whole rows'
  (``quantize_rows`` of the whole leaf), at every width; with the
  rank's own amax they are not.

Readings on the CPU: losses 9.8e-8 relative (2.0e-7 at 8 bits); params
2.0e-7 after step 1, and after the sync 6.4e-6 (16 bits: one int16
code), 6.0e-8 (8 and 4), 1.0e-7 (0), as on one data rank a pod
(tests/test_torch_steps_multipod.py), whose bounds these are.
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

from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import common

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BITS = (16, 8, 4, 0)
LOSS_RTOL = 1e-5
#: per width, a few times above its own reading (module docstring)
PARAM_ATOL = {16: 2e-5, 8: 1e-6, 4: 1e-6, 0: 1e-6}

_JAX = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import TrainConfig, registry
    from repro.core import steps
    from repro.launch import mesh as mesh_mod
    from repro.runtime import sharding as shd

    cfg = registry.get_smoke_config("qwen2-7b")
    mesh = mesh_mod.make_mesh((2, 2, 1), ("pod", "data", "model"))
    batches = [np.random.default_rng(i).integers(
        0, cfg.vocab_size, (2, 4, 128)).astype(np.int32) for i in range(3)]
    res = {"batches": batches}
    for bits in (16, 8, 4, 0):
        tcfg = TrainConfig(fedat_enabled=True, fedat_sync_every=2,
                           fedat_compress_bits=bits, lr=1e-3)
        with mesh, shd.use_mesh(mesh):
            fns = steps.make_fedat_step(cfg, tcfg, mesh)
            state = jax.jit(fns.init_state, out_shardings=fns.state_shardings)(
                jax.random.PRNGKey(0))
            res["init"] = jax.tree.map(lambda a: np.array(a[0]),
                                       state["params"])
            fn = jax.jit(fns.train_step,
                         in_shardings=(fns.state_shardings,
                                       fns.batch_shardings),
                         out_shardings=(fns.state_shardings, None))
            losses, snaps = [], []
            for b in batches:
                state, m = fn(state, {"tokens": jnp.asarray(b)})
                losses.append(float(m["loss"]))
                snaps.append(jax.tree.map(np.array, state["params"]))
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
    from repro_torch.models.convert import params_from_numpy, params_to_numpy
    from repro_torch.optim.optimizers import tree_map
    from repro_torch.runtime import sharding as shd

    mesh_mod.init_from_env(torch.device("cpu"))
    ref_path, out_path = sys.argv[1], sys.argv[2].format(mesh_mod.rank())
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    cfg = get_smoke_config("qwen2-7b")
    mesh = mesh_mod.make_mesh((2, 2, 1), ("pod", "data", "model"))
    fsdp = shd.FSDP.over(mesh)
    out = {"pod": mesh.coord("pod"), "data": mesh.coord("data")}
    stacked = params_from_numpy(tree_map(
        lambda a: np.stack([a, a]), ref["init"]), device="cpu")

    for bits in (16, 8, 4, 0):
        tcfg = TrainConfig(fedat_enabled=True, fedat_sync_every=2,
                           fedat_compress_bits=bits, lr=1e-3)
        fns = steps.make_fedat_step(cfg, tcfg, mesh, device="cpu")
        lay = fns.state_shardings["params"]
        state = fns.init_state(0)
        state["params"] = shd.shard_tree(stacked, lay, mesh)
        losses, snaps, sent = [], [], []
        for b in ref["batches"]:
            state, m = fns.train_step(state, {"tokens": b})
            losses.append(float(m["loss"]))
            snaps.append(tree_map(np.copy, params_to_numpy(
                fsdp.gather_tree(state["params"], lay))))
            sent.append(float(m["payload_bytes"]))
        out[bits] = {"losses": losses, "params": snaps, "sent": sent}

    # codes of rows split over the data ranks
    group, _ = mesh.group("data")
    x = torch.from_numpy(np.random.default_rng(7).normal(
        0, 1, (6, 16)).astype(np.float32))
    x[2] = 0.0
    x[3, 5] = 40.0                  # a row whose max lies on rank 0's half
    n = 16 // 2
    mine = x[:, out["data"] * n:(out["data"] + 1) * n].contiguous()
    out["codes"] = {}
    for bits in (16, 8, 4):
        (pay, sc), = steps.quantize_shards([mine], bits, [True], group)
        (lpay, lsc), = steps.quantize_shards([mine], bits, [True], None)
        wpay, wsc = steps.quantize_rows(x, bits)
        k = n // 2 if bits == 4 else n
        want = wpay[:, out["data"] * k:(out["data"] + 1) * k]
        out["codes"][bits] = {
            "payload": torch.equal(pay, want), "scale": torch.equal(sc, wsc),
            "local_differs": not (torch.equal(lpay, want)
                                  and torch.equal(lsc, wsc))}
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    mesh_mod.shutdown()
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("fsdp_multipod")
    ref_path = str(d / "ref.pkl")
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, "-c", _JAX, ref_path],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = mesh_mod.run_ranks(
        ["-c", _RANK, ref_path, str(d / "rank{}.pkl")], 4, timeout=600,
        env={"PYTHONPATH": os.path.join(REPO, "src"),
             "OMP_NUM_THREADS": "1"})
    assert all(rc == 0 for rc, _, _ in res), [e[-3000:] for *_, e in res]
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    ranks = []
    for r in range(4):
        with open(d / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ref, sorted(ranks, key=lambda x: (x["pod"], x["data"]))


def _leaves(tree):
    return [v for _, v in sorted(common.flatten_tree(tree).items())]


@pytest.mark.parametrize("bits", BITS)
def test_sharded_multipod_matches_reference(runs, bits):
    ref, ranks = runs
    want = ref[bits]
    for r in ranks:
        got = r[bits]
        np.testing.assert_allclose(got["losses"], want["losses"],
                                   rtol=LOSS_RTOL)
        for step in range(3):
            g = _leaves(got["params"][step])
            w = [x[r["pod"]:r["pod"] + 1]
                 for x in _leaves(want["params"][step])]
            assert len(g) == len(w)
            for x, y in zip(g, w):
                assert x.shape == y.shape
                assert float(np.abs(x - y).max()) <= PARAM_ATOL[bits], \
                    (bits, step)
    # the pods are bitwise equal after the sync (step 2), and a pod's
    # data ranks gather the same params
    after = [_leaves(r[bits]["params"][1]) for r in ranks]
    for other in after[1:]:
        for x, y in zip(after[0], other):
            assert np.array_equal(x, y)


@pytest.mark.parametrize("bits", BITS)
def test_a_rank_sends_its_shard(runs, bits):
    """At a sync a rank sends the dry-run's per-device bytes on this
    mesh: its shard's payload and its rows' scales; nothing otherwise."""
    cfg = get_smoke_config("qwen2-7b")
    mesh = types.SimpleNamespace(shape={"pod": 2, "data": 2, "model": 1})
    want = dryrun.sync_bytes(cfg, 1, mesh)[str(bits)]
    one = dryrun.sync_bytes(cfg, 1, types.SimpleNamespace(
        shape={"pod": 2, "data": 1, "model": 1}))[str(bits)]
    assert want < 0.6 * one
    for r in runs[1]:
        assert r[bits]["sent"] == [0.0, float(want), 0.0]


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_split_rows_quantize_bitwise(runs, bits):
    for r in runs[1]:
        c = r["codes"][bits]
        assert c["payload"] and c["scale"]
        assert c["local_differs"]
