"""The trainer's checkpoints on gloo ranks: failure injection and
``--resume`` restore one agreed step on every rank.

Each rank writes its checkpoints under a directory of its own (a host
that cannot see the other's files): in a single-pod run only rank 0, the
writer, saves, and rank 1 reads nothing from the disk; the state it
restores is rank 0's, each leaf broadcast and every rank keeping its
FSDP shard.  Under ``--multi-pod`` each rank writes its pod's slot, and
the two writers agree on the newest step that both hold.  The runner's
injected failures are drawn from ``--seed`` on every rank, so the ranks
fail, restore and retry at the same steps.

The files are layout-free: a single-pod run on 2 ranks (each holding
half of every split leaf) writes whole leaves, which restore on 1 and on
4 ranks to the same params and moments, bit for bit, and a checkpoint
written on 4 restores on 2 and on 1.  A guarded restore on 2 sharded
ranks, a checkpoint every step, resumes to the uninterrupted run's
losses within ``RESUME_RTOL`` (read: equal).
"""
import json
import os
import shutil
import textwrap

import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import mesh as mesh_mod

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMON = ["--smoke", "--device", "cpu", "--ckpt-every", "2", "--seed", "3"]
#: seed 3 at rate 0.3 fails step 1 twice (no checkpoint yet: retried
#: from the current state), step 3 once (restores step 2), step 5 once
#: and step 6 once (each restores step 4, so step 5 runs twice): 5
#: failures, 3 restores, 7 steps run
FAILURES = ["--inject-failure-rate", "0.3"]
RESUME_RTOL = 1e-6

_RANK = textwrap.dedent("""
    import json, os, sys
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train
    from repro_torch.optim.optimizers import tree_leaves

    out, argv = sys.argv[1], sys.argv[2:]
    args = train.parser().parse_args(argv)
    rank = int(os.environ["RANK"])
    args.ckpt_dir = os.path.join(args.ckpt_dir, f"host{rank}")
    try:
        res = train.run(args)
        # the state is sharded over the data ranks: gathered whole
        from repro_torch.runtime import sharding as shd
        mesh = mesh_mod.make_host_mesh(n_pods=2 if args.multi_pod else 1)
        fsdp = shd.FSDP.over(mesh)
        state = (res.state if fsdp is None else
                 fsdp.gather_tree(res.state, res.layouts))
        torch.save({k: torch.cat([x.reshape(-1).to(torch.float64)
                                  for x in tree_leaves(t)])
                    for k, t in (("params", state["params"]),
                                 ("m", state["opt"]["m"]),
                                 ("v", state["opt"]["v"]))},
                   out.format(rank) + ".pt")
        with open(out.format(rank), "w") as f:
            json.dump({"losses": res.losses, "start": res.start_step,
                       "end": res.end_step, "stats": res.runner_stats}, f)
    finally:
        mesh_mod.shutdown()
""")


def _ranks(tmp_path, argv, tag, world=2):
    out = str(tmp_path / f"{tag}_rank{{}}.json")
    store = tmp_path / f"store_{tag}"
    store.mkdir()
    res = mesh_mod.run_ranks(
        ["-c", _RANK, out, *argv, "--ckpt-dir", str(tmp_path / "ck")],
        world, timeout=120, store_dir=str(store),
        env={"PYTHONPATH": os.path.join(REPO, "src"),
             "OMP_NUM_THREADS": "1"})
    assert [rc for rc, _, _ in res] == [0] * world, \
        [e[-3000:] for *_, e in res]
    docs = []
    for r in range(world):
        with open(out.format(r)) as f:
            doc = json.load(f)
        doc.update(torch.load(out.format(r) + ".pt"))
        docs.append(doc)
    return docs


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["single_pod", "multi_pod"])
def test_two_ranks_restore_together(tmp_path, multi_pod):
    extra = (["--multi-pod", "--codec", "quantize8", "--fedat-sync-every",
              "2"] if multi_pod else [])
    a = _ranks(tmp_path, COMMON + FAILURES + extra + ["--steps", "6"], "a")
    for r in a:
        st = dict(r["stats"], straggler_steps=0)
        assert st == {"failures": 5, "restores": 3, "steps": 7,
                      "straggler_steps": 0}, r["stats"]
        assert (r["start"], r["end"]) == (0, 6)
    assert a[0]["losses"] == a[1]["losses"]
    # single-pod: the data ranks hold one model; multi-pod: step 6 synced
    assert torch.equal(a[0]["params"], a[1]["params"])
    # the writers' checkpoints: rank 0's alone (single-pod), or each
    # pod's under its rank's directory
    dirs = ([tmp_path / "ck" / f"host{p}" / f"pod{p}" for p in range(2)]
            if multi_pod else [tmp_path / "ck" / "host0"])
    for d in dirs:
        assert CheckpointManager(str(d)).all_steps() == [2, 4, 6]
    assert multi_pod or not (tmp_path / "ck" / "host1").exists()
    # the first writer loses step 6: every rank resumes from step 4
    shutil.rmtree(dirs[0] / "step_0000000006")
    b = _ranks(tmp_path, COMMON + extra + ["--steps", "6", "--resume"], "b")
    for r in b:
        assert (r["start"], r["end"]) == (4, 6) and len(r["losses"]) == 2
    assert b[0]["losses"] == b[1]["losses"]
    assert torch.equal(b[0]["params"], b[1]["params"])


def _one_rank_restore(tmp_path, steps):
    """``--resume`` on one rank (no process group) from the writer's
    directory: the whole state it restores, flat."""
    from repro_torch.launch import train
    from repro_torch.optim.optimizers import tree_leaves
    args = train.parser().parse_args(
        COMMON + ["--steps", str(steps), "--resume", "--ckpt-dir",
                  str(tmp_path / "ck" / "host0")])
    res = train.run(args)
    assert (res.start_step, res.end_step) == (steps, steps)
    return {k: torch.cat([x.reshape(-1).to(torch.float64)
                          for x in tree_leaves(t)])
            for k, t in (("params", res.state["params"]),
                         ("m", res.state["opt"]["m"]),
                         ("v", res.state["opt"]["v"]))}


def _same_state(a, b):
    return all(torch.equal(a[k], b[k]) for k in ("params", "m", "v"))


def test_checkpoints_are_layout_free(tmp_path):
    # written on 2 ranks, restored on 4 and on 1
    two = _ranks(tmp_path, COMMON + ["--steps", "4"], "d2")
    assert _same_state(two[0], two[1])
    four = _ranks(tmp_path, COMMON + ["--steps", "4", "--resume"], "d4",
                  world=4)
    for r in four:
        assert (r["start"], r["end"]) == (4, 4)
        assert _same_state(r, two[0])
    assert _same_state(_one_rank_restore(tmp_path, 4), two[0])
    # and the reverse: 2 more steps written on 4, restored on 2 and on 1
    four = _ranks(tmp_path, COMMON + ["--steps", "6", "--resume"], "d4b",
                  world=4)
    assert four[0]["start"] == 4 and not _same_state(four[0], two[0])
    two = _ranks(tmp_path, COMMON + ["--steps", "6", "--resume"], "d2b")
    for r in two:
        assert (r["start"], r["end"]) == (6, 6)
        assert _same_state(r, four[0])
    assert _same_state(_one_rank_restore(tmp_path, 6), four[0])


def test_guarded_restore_resumes_the_uninterrupted_losses(tmp_path):
    """A checkpoint every step: each failure restores the step before it
    and retries the same batch, so the run's losses are the uninterrupted
    run's."""
    argv = ["--smoke", "--device", "cpu", "--ckpt-every", "1", "--seed",
            "3", "--steps", "6"]
    a = _ranks(tmp_path, argv + FAILURES, "faulty")
    assert a[0]["stats"]["failures"] == 5 and a[0]["stats"]["restores"] == 3
    shutil.rmtree(tmp_path / "ck")
    b = _ranks(tmp_path, argv, "clean")
    assert b[0]["stats"]["failures"] == 0
    for x, y in zip(a, b):
        assert len(x["losses"]) == len(y["losses"]) == 6
        for p, q in zip(x["losses"], y["losses"]):
            assert abs(p - q) <= RESUME_RTOL * abs(q)
        assert _same_state(x, y)
