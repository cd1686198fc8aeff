"""Training entry point: checkpointed, restart-on-failure, one device.

The port of ``repro/launch/train.py`` for one device: the single-pod step
(core/steps.py), the synthetic token pipeline, asynchronous checkpoints
and the guarded runner that restores the last good checkpoint on a failed
step.  It runs on the card unless ``--device cpu`` is given; the params
are drawn on the device from a ``torch.Generator`` seeded with
``--seed``.  Every transformer family trains (dense, moe, the vlm and
audio frontends, with the pipeline's patch and frame batches; the MoE aux
loss is logged beside the cross-entropy); the recurrent families raise
naming ROADMAP A17.  ``--multi-pod`` and ``--codec`` (pods as FedAT tiers
and the cross-tier link) raise naming ROADMAP A16.

Example (CPU):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \\
      --smoke --steps 4 --ckpt-dir /tmp/ckpt --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import time
from typing import Any, Dict, List, Optional

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.configs.shapes import SHAPES, smoke_shape
from repro_torch.core import steps as steps_mod
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import resolve_device
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


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + tiny shape (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--multi-pod", action="store_true",
                    help="not ported yet (ROADMAP A16)")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=10,
                    help="steps between checkpoints; 0 writes none")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--inject-failure-rate", type=float, default=0.0)
    ap.add_argument("--codec", default=None,
                    help="not ported yet (ROADMAP A16)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device: cuda (default), cuda:N or cpu")
    return ap


def run(args: argparse.Namespace, cfg=None, shape=None) -> TrainResult:
    """Train ``args.steps`` steps (from the latest checkpoint with
    ``--resume``).  ``cfg`` / ``shape`` override what ``--arch`` /
    ``--shape`` / ``--smoke`` resolve to (a depth-cut config, say)."""
    if args.multi_pod or args.codec:
        raise NotImplementedError(
            "--multi-pod and --codec (pods as FedAT tiers, the cross-tier "
            "link) are not ported to the PyTorch package yet (ROADMAP A16)")
    dev = resolve_device(args.device)
    if cfg is None:
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(
            args.arch)
    if shape is None:
        shape = smoke_shape("train") if args.smoke else SHAPES[args.shape]
    tcfg = TrainConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every, seed=args.seed)
    fns = steps_mod.make_single_pod_step(cfg, tcfg, device=dev)
    pipe = TokenPipeline(cfg, shape, seed=args.seed)
    ckpt = CheckpointManager(args.ckpt_dir, keep=3)

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
                       batch_s[:len(steps)], dict(runner.stats), state)


def main(argv: Optional[List[str]] = None) -> List[float]:
    args = parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return run(args).losses


if __name__ == "__main__":
    main()
