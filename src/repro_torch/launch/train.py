"""Training entry point: fault-tolerant, checkpointed, FedAT-aware.

The port of ``repro/launch/train.py``: the single-pod step or, with
``--multi-pod``, the FedAT pods-as-tiers step (core/steps.py), the
synthetic token pipeline, asynchronous checkpoints and the guarded runner
that restores the last good checkpoint on a failed step.  It runs on the
card unless ``--device cpu`` is given; the params are drawn on the device
from a ``torch.Generator`` seeded with ``--seed``.  Every family of the
zoo trains: dense, moe, the vlm and audio frontends (with the pipeline's
patch and frame batches; the MoE aux loss is logged beside the
cross-entropy), and the recurrent rwkv6 and zamba2 (their scans' backward
a kernel on the card).

The mesh is the host mesh over the launched ranks (launch/mesh.py; the
production shapes are read by the dry-run only).  ``--multi-pod`` lays
two pods over them, each pod a FedAT tier that mixes with the other every
``--fedat-sync-every`` steps at ``--fedat-bits`` (or the int width of
``--codec`` quantize8/quantize16); on one rank the mesh has no pod axis
and the run is single-pod, the reference's rule.  Each rank draws the
same global batch and trains its pod's (and data rank's) rows.  With
more than one data rank each holds its 1/D FSDP shard of the params and
AdamW moments (core/steps.py), so a model whose state one card cannot
hold trains over several: qwen2-7b at its 28 layers needs about 122 GB
of fp32 params, moments and gradients whole, 30.47 GB a rank on 4
ranks (arithmetic: runtime/sharding.py ``device_bytes``).

Rank 0 writes the checkpoints of a single-pod run; under ``--multi-pod``
each pod's first data rank writes its pod's slot under
``<ckpt-dir>/pod<p>``.  The files are layout-free, as the reference's
(which saves global arrays): whole leaves, gathered leaf by leaf from
the data ranks' shards, so a checkpoint written on D ranks restores on
any other number.  A restore (``--resume``, or the guarded runner after
a failed step) is collective: the writers agree on one step, load it
and send each leaf to their data ranks, each of which keeps its shard
(:class:`RankCheckpoints`).

Examples (CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
      --smoke --steps 4 --ckpt-dir /tmp/ckpt --device cpu
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \\
      -m repro_torch.launch.train --smoke --multi-pod --codec quantize8 \\
      --fedat-sync-every 2 --steps 4 --ckpt-every 0 --device cpu
Sharded over 4 cards (nccl, one a rank):
  PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \\
      -m repro_torch.launch.train --arch qwen2-7b --steps 20
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.configs.shapes import SHAPES, smoke_shape
from repro_torch.core import steps as steps_mod
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.optim.optimizers import tree_map
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.fault import GuardedRunner

log = logging.getLogger("repro_torch.train")


@dataclasses.dataclass
class TrainResult:
    losses: List[float]
    metrics: List[Dict[str, float]]
    start_step: int
    end_step: int
    seconds: float
    step_seconds: List[float]
    batch_seconds: List[float]
    runner_stats: Dict[str, int]
    state: Any
    #: the state's layouts (the step's ``state_shardings``; None
    #: without a mesh): ``sharding.FSDP.gather_tree`` makes it whole
    layouts: Any = None


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + tiny shape (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--multi-pod", action="store_true",
                    help="two pods as FedAT tiers (needs an even number "
                         "of ranks; single-pod on one rank)")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=10,
                    help="steps between checkpoints; 0 writes none")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--inject-failure-rate", type=float, default=0.0)
    ap.add_argument("--fedat-sync-every", type=int, default=4)
    ap.add_argument("--fedat-bits", type=int, default=8)
    ap.add_argument("--codec", default=None,
                    help="transport codec for the cross-tier link "
                         "(quantize8/quantize16; overrides --fedat-bits)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device: cuda (default), cuda:N or cpu")
    return ap


class RankCheckpoints:
    """The checkpoints of a run over the ranks of ``mesh``, with the
    :class:`CheckpointManager` calls the guarded runner makes.

    The first rank of each data line, the writer, alone holds ``ckpt``
    (``None`` on the others) and writes.  With ``layouts`` (the step's
    ``state_shardings``) splitting leaves over ``data`` > 1, :meth:`save`
    is collective over the data line: every rank gathers the state leaf
    by leaf and the writer keeps the whole leaves on the host, so the
    files hold whole leaves whatever D was.  :meth:`latest_step` and
    :meth:`restore` are collective over the world, so every rank calls
    them at the same step (the runner's injected failures are drawn from
    the same seed on every rank): each writer waits for its pending
    save, the writers agree on the newest step that all of them hold (a
    min over the world) and load it on the host, and each leaf goes to
    the data line by a broadcast, every rank keeping its block of it.
    On one rank they are the manager's own."""

    def __init__(self, ckpt: Optional[CheckpointManager], mesh, device,
                 layouts: Any = None):
        self.ckpt = ckpt
        self.mesh = mesh
        self.device = device
        self.layouts = layouts
        self.fsdp = shd.FSDP.over(mesh) if layouts is not None else None

    def save(self, step: int, state: Any, blocking: bool = False) -> None:
        if self.fsdp is not None:
            state = self.fsdp.gather_tree(
                state, self.layouts, (lambda t: t.detach().cpu())
                if self.ckpt is not None else (lambda t: None))
        if self.ckpt is not None:
            self.ckpt.save(step, state, blocking=blocking)

    def _agree(self, step: Optional[int]) -> Optional[int]:
        """The min over the world of the writers' ``step`` (None: -1)."""
        if self.ckpt is None:
            step = 2 ** 62
        t = torch.tensor([-1 if step is None else step], dtype=torch.int64,
                         device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        return None if int(t) < 0 else int(t)

    def latest_step(self) -> Optional[int]:
        if mesh_mod.world_size() == 1:
            return self.ckpt.latest_step()
        if self.ckpt is not None:
            self.ckpt.wait()
        return self._agree(None if self.ckpt is None
                           else self.ckpt.latest_step())

    def restore(self, like: Any):
        """``like`` (the state this rank holds) with the agreed step's
        values written into it in place; returns (state, step)."""
        if mesh_mod.world_size() == 1:
            return self.ckpt.restore(like)
        host = tree_map(lambda _: None, like)   # leaves stay numpy
        loaded, step = None, None
        if self.ckpt is not None:
            try:
                loaded, step = self.ckpt.restore(host)
            except FileNotFoundError:
                pass
        agreed = self._agree(step)
        if agreed is None:
            raise FileNotFoundError("no checkpoint that every writer can "
                                    "restore")
        if self.ckpt is not None and step != agreed:
            loaded, _ = self.ckpt.restore(host, step=agreed)
        self._place(like, loaded, self.layouts)
        return like, agreed

    def _place(self, like, loaded, layouts) -> None:
        """Each leaf of ``loaded`` (the writer's whole numpy leaves; None
        on the other ranks) into ``like``: broadcast over the data line
        when it has more than one rank, this rank's block kept."""
        if isinstance(like, dict):
            for k in sorted(like):
                self._place(like[k], None if loaded is None else loaded[k],
                            None if layouts is None else layouts[k])
            return
        d = self.mesh.shape.get("data", 1)
        dim = shd.split_dim(layouts)
        shape = list(like.shape)
        if dim is not None:
            shape[dim] *= d
        if loaded is not None:
            whole = torch.from_numpy(loaded).to(like.device, like.dtype)
        else:
            whole = torch.empty(shape, dtype=like.dtype, device=like.device)
        if d > 1:
            group, ranks = self.mesh.group("data")
            dist.broadcast(whole, src=ranks[0], group=group)
        if dim is not None:
            n = like.shape[dim]
            whole = whole.narrow(dim, self.mesh.coord("data") * n, n)
        like.copy_(whole)


def build(cfg, tcfg, mesh, multi_pod: bool, device=None):
    if multi_pod:
        return steps_mod.make_fedat_step(cfg, tcfg, mesh, device=device)
    return steps_mod.make_single_pod_step(cfg, tcfg, mesh, device=device)


def run(args: argparse.Namespace, cfg=None, shape=None) -> TrainResult:
    """Train ``args.steps`` steps (from the latest checkpoint with
    ``--resume``).  ``cfg`` / ``shape`` override what ``--arch`` /
    ``--shape`` / ``--smoke`` resolve to (a depth-cut config, say).
    Under a launcher's environment (``WORLD_SIZE`` > 1) the rank joins
    the process group first."""
    if args.codec:
        from repro_torch.compress import transport
        try:
            args.fedat_bits = transport.cross_tier_bits(args.codec)
        except ValueError as e:
            parser().error(str(e))
    dev = mesh_mod.init_from_env(resolve_device(args.device))
    if cfg is None:
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(
            args.arch)
    if shape is None:
        shape = smoke_shape("train") if args.smoke else SHAPES[args.shape]
    tcfg = TrainConfig(
        fedat_enabled=args.multi_pod, fedat_sync_every=args.fedat_sync_every,
        fedat_compress_bits=args.fedat_bits, total_steps=args.steps,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, seed=args.seed)
    mesh = mesh_mod.make_host_mesh(n_pods=2 if args.multi_pod else 1)
    multi_pod = args.multi_pod and "pod" in mesh.shape
    n_pods = mesh.shape.get("pod", 1)
    fns = build(cfg, tcfg, mesh, multi_pod, device=dev)
    pipe = TokenPipeline(cfg, shape, seed=args.seed)
    ckpt_dir = args.ckpt_dir
    if multi_pod:
        ckpt_dir = os.path.join(ckpt_dir, f"pod{mesh.coord('pod')}")
    ckpt = RankCheckpoints(
        CheckpointManager(ckpt_dir, keep=3) if mesh.coord("data") == 0
        else None, mesh, dev, fns.state_shardings)

    state = fns.init_state(args.seed)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        state, start = ckpt.restore(state)
        log.info("resumed from step %d", start)

    batch_s: List[float] = []

    def batches():
        step = start
        while True:
            t = time.perf_counter()
            batch = pipe.batch(step)
            if multi_pod:
                batch = steps_mod.split_batch_for_pods(batch, n_pods)
            batch_s.append(time.perf_counter() - t)
            yield batch
            step += 1

    losses: List[float] = []
    history: List[Dict[str, float]] = []
    stamps: List[float] = []

    def on_metrics(step, metrics):
        # float() waits for the step, so the stamps bound each step and
        # the making of its batch
        row = {k: float(v) for k, v in metrics.items()}
        stamps.append(time.perf_counter())
        losses.append(row["loss"])
        history.append(row)
        if step % 5 == 0 or step == args.steps:
            log.info("step %d loss %.4f (ce_loss %.4f aux_loss %.4f)", step,
                     losses[-1], row["ce_loss"], row["aux_loss"])

    runner = GuardedRunner(fns.train_step, ckpt, ckpt_every=args.ckpt_every,
                           inject_failure_rate=args.inject_failure_rate,
                           seed=args.seed)
    t0 = time.perf_counter()
    state, end = runner.run(state, batches(), args.steps, start_step=start,
                            on_metrics=on_metrics)
    dt = time.perf_counter() - t0
    log.info("done: %d steps in %.1fs (%.3fs/step); runner stats %s",
             end - start, dt, dt / max(end - start, 1), runner.stats)
    steps = [b - a - d for a, b, d in zip([t0] + stamps, stamps, batch_s)]
    return TrainResult(losses, history, start, end, dt, steps,
                       batch_s[:len(steps)], dict(runner.stats), state,
                       fns.state_shardings)


def main(argv: Optional[List[str]] = None) -> List[float]:
    args = parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    try:
        return run(args).losses
    finally:
        mesh_mod.shutdown()


if __name__ == "__main__":
    main()
