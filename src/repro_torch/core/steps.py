"""Train steps: the single-pod step of ``repro/core/steps.py``.

The port's counterpart of the reference's jitted single-pod step, on one
device (tensor parallelism 1, so the state and batch shardings are
``None``): a forward and backward of ``lm.loss_fn`` per microbatch with
the gradients summed in fp32 and divided by the microbatch count, the
cosine schedule, and AdamW with global-norm clipping.  The trainer's
state is updated in place (``optim.adamw``), so a model of billions of
parameters keeps one copy of its params and moments on the card.

The multi-pod FedAT step (pods as tiers), the batch split for pods and
the fault plane's update gate are not ported yet: they raise naming
ROADMAP A16 (the mesh) and A12 (the fault plane).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import common, lm
from repro_torch.optim import adamw, cosine_schedule, global_norm


@dataclasses.dataclass(frozen=True)
class StepFns:
    train_step: Callable
    init_state: Callable
    state_shardings: Any
    batch_shardings: Any


def _loss_and_grads(cfg: ModelConfig, params, batch, tp: int,
                    microbatch: int) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """(mean loss, grads tree).  With ``microbatch`` k > 1 the batch is
    split into k slices along its leading dim; their fp32 gradients are
    summed and divided by k, and so are their losses."""
    flat = common.flatten_tree(params)
    names = list(flat)

    def value_and_grad(b):
        leaves = [flat[n].detach().requires_grad_(True) for n in names]
        with torch.enable_grad():
            loss, _ = lm.loss_fn(
                cfg, common.unflatten_tree(dict(zip(names, leaves))), b, tp)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), grads

    if microbatch and microbatch > 1:
        k = microbatch
        mb = {key: x.reshape(k, x.shape[0] // k, *x.shape[1:])
              for key, x in batch.items()}
        gsum = [torch.zeros(flat[n].shape, dtype=torch.float32,
                            device=flat[n].device) for n in names]
        lsum = torch.zeros((), dtype=torch.float32,
                           device=flat[names[0]].device)
        for i in range(k):
            loss, grads = value_and_grad({key: x[i] for key, x in mb.items()})
            for acc, g in zip(gsum, grads):
                acc.add_(g.float())
            del grads
            lsum = lsum + loss
        grads = [g.div_(k) for g in gsum]
        return lsum / k, common.unflatten_tree(dict(zip(names, grads)))
    loss, grads = value_and_grad(batch)
    return loss, common.unflatten_tree(dict(zip(names, grads)))


def _to_device(batch, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: (torch.from_numpy(np.asarray(v)) if not isinstance(
        v, torch.Tensor) else v).to(device) for k, v in batch.items()}


def make_single_pod_step(cfg: ModelConfig, tcfg: TrainConfig,
                         mesh: Any = None, param_dtype=torch.float32,
                         device: DeviceLike = None) -> StepFns:
    """``init_state(seed)`` draws the params on ``device`` (None = the
    card) from a generator seeded with ``seed``; ``train_step(state,
    batch)`` -> (state, {"loss", "grad_norm", "lr_scale"}), the state
    updated in place.  ``mesh`` must be None or a one-device mesh: the
    port has no mesh (ROADMAP A16)."""
    if mesh is not None and getattr(mesh, "size", 1) != 1:
        raise NotImplementedError(
            "a device mesh is not ported to the PyTorch package yet "
            "(ROADMAP A16); the single-pod step runs on one device")
    tp = 1
    dev = resolve_device(device)
    opt = adamw(tcfg.lr, tcfg.betas[0], tcfg.betas[1], tcfg.eps,
                tcfg.weight_decay, grad_clip=tcfg.grad_clip)
    sched = cosine_schedule(1.0, tcfg.warmup_steps, tcfg.total_steps)

    def init_state(seed: int):
        params = lm.init_params(cfg, seed, tp, param_dtype, device=dev)
        return {"params": params, "opt": opt.init(params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def train_step(state, batch):
        batch = _to_device(batch, dev)
        params = state["params"]
        loss, grads = _loss_and_grads(cfg, params, batch, tp, cfg.microbatch)
        lr_scale = sched(state["step"])
        grad_norm = global_norm(grads)
        new_params, new_opt = opt.step(params, grads, state["opt"],
                                       lr_scale)
        metrics = {"loss": loss, "grad_norm": grad_norm,
                   "lr_scale": lr_scale}
        return ({"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1}, metrics)

    return StepFns(train_step, init_state, None, None)


# ---------------------------------------------------------------------------
# not ported yet
# ---------------------------------------------------------------------------

def make_fedat_step(*args, **kwargs):
    raise NotImplementedError(
        "the multi-pod FedAT step (pods as tiers) is not ported to the "
        "PyTorch package yet (ROADMAP A16: the mesh)")


def split_batch_for_pods(*args, **kwargs):
    raise NotImplementedError(
        "splitting batches for pods is not ported to the PyTorch package "
        "yet (ROADMAP A16: the mesh)")


def _fault_plane(what: str):
    return NotImplementedError(
        f"{what} (the fault plane's update gate) is not ported to the "
        f"PyTorch package yet (ROADMAP A12)")


class UpdateGate:
    def __init__(self, *args, **kwargs):
        raise _fault_plane("UpdateGate")


def poison_updates(*args, **kwargs):
    raise _fault_plane("poison_updates")


def gate_updates(*args, **kwargs):
    raise _fault_plane("gate_updates")
