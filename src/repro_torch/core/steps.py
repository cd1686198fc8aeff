"""Train steps: the single-pod step of ``repro/core/steps.py``.

The port's counterpart of the reference's jitted single-pod step, on one
device (tensor parallelism 1, so the state and batch shardings are
``None``): a forward and backward of ``lm.loss_fn`` per microbatch with
the gradients summed in fp32 and divided by the microbatch count, the
cosine schedule, and AdamW with global-norm clipping.  It is the same for
every family: ``lm.loss_fn`` dispatches (the recurrent families' scans
carry their own backward).  The trainer's
state is updated in place (``optim.adamw``), so a model of billions of
parameters keeps one copy of its params and moments on the card.

The fault plane's server-side update gate (:class:`UpdateGate`,
:func:`poison_updates`, :func:`gate_updates`) runs as plain torch ops on
the K-stacked client dict, with no host read, inside the executor's gated
rounds.  The multi-pod FedAT step (pods as tiers) and the batch split for
pods are not ported yet: they raise naming ROADMAP A16 (the mesh).
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
                    microbatch: int
                    ) -> Tuple[torch.Tensor, Dict[str, Any],
                               Dict[str, torch.Tensor]]:
    """(mean loss, grads tree, mean loss metrics: ``ce_loss`` and
    ``aux_loss``).  With ``microbatch`` k > 1 the batch is split into k
    slices along its leading dim; their fp32 gradients are summed and
    divided by k, and so are their losses."""
    flat = common.flatten_tree(params)
    names = list(flat)

    def value_and_grad(b):
        leaves = [flat[n].detach().requires_grad_(True) for n in names]
        with torch.enable_grad():
            loss, metrics = lm.loss_fn(
                cfg, common.unflatten_tree(dict(zip(names, leaves))), b, tp)
            # a leaf the loss does not read (the audio family's token
            # embedding) gets a zero gradient, as jax.grad gives it
            grads = [torch.zeros_like(x) if g is None else g for x, g in zip(
                leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
        return loss.detach(), grads, {k: v.detach()
                                      for k, v in metrics.items()}

    if microbatch and microbatch > 1:
        k = microbatch
        mb = {key: x.reshape(k, x.shape[0] // k, *x.shape[1:])
              for key, x in batch.items()}
        gsum = [torch.zeros(flat[n].shape, dtype=torch.float32,
                            device=flat[n].device) for n in names]
        lsum = torch.zeros((), dtype=torch.float32,
                           device=flat[names[0]].device)
        msum: Dict[str, torch.Tensor] = {}
        for i in range(k):
            loss, grads, metrics = value_and_grad(
                {key: x[i] for key, x in mb.items()})
            for acc, g in zip(gsum, grads):
                acc.add_(g.float())
            del grads
            lsum = lsum + loss
            for key, v in metrics.items():
                msum[key] = msum[key] + v if key in msum else v
        grads = [g.div_(k) for g in gsum]
        return (lsum / k, common.unflatten_tree(dict(zip(names, grads))),
                {key: v / k for key, v in msum.items()})
    loss, grads, metrics = value_and_grad(batch)
    return loss, common.unflatten_tree(dict(zip(names, grads))), metrics


def _to_device(batch, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: (torch.from_numpy(np.asarray(v)) if not isinstance(
        v, torch.Tensor) else v).to(device) for k, v in batch.items()}


def make_single_pod_step(cfg: ModelConfig, tcfg: TrainConfig,
                         mesh: Any = None, param_dtype=torch.float32,
                         device: DeviceLike = None) -> StepFns:
    """``init_state(seed)`` draws the params on ``device`` (None = the
    card) from a generator seeded with ``seed``; ``train_step(state,
    batch)`` -> (state, {"loss", "grad_norm", "lr_scale", "ce_loss",
    "aux_loss"}), the state updated in place (the reference's metrics,
    plus the loss's two parts).  ``mesh`` must be None or a one-device mesh: the
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
        loss, grads, parts = _loss_and_grads(cfg, params, batch, tp,
                                             cfg.microbatch)
        lr_scale = sched(state["step"])
        grad_norm = global_norm(grads)
        new_params, new_opt = opt.step(params, grads, state["opt"],
                                       lr_scale)
        metrics = {"loss": loss, "grad_norm": grad_norm,
                   "lr_scale": lr_scale, **parts}
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


# ---------------------------------------------------------------------------
# server-side update validation gate (the fault plane)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class UpdateGate:
    """Validation applied to *decoded* client uplinks before Eq. 4:
    non-finite client updates are zero-weighted (and their payloads
    sanitized to the reference params, since NaN * 0 is still NaN inside
    the weighted average) and, when ``clip_norm > 0``, every surviving
    update's delta from the reference is L2-clipped."""
    clip_norm: float = 0.0


def _expand(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (leaf.dim() - 1))


def poison_updates(client_params: Dict[str, torch.Tensor],
                   poison: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Overwrite poisoned clients' float leaves with NaN — the fault
    plane's stand-in for a corrupted uplink.  Applied *after* the uplink
    codec decode (a lossy codec would otherwise scrub the injected NaNs
    before the gate sees them).  ``poison`` is a (K,) bool tensor over the
    padded client axis."""
    return {k: (torch.where(_expand(poison, v),
                            torch.full((), float("nan"), dtype=v.dtype,
                                       device=v.device), v)
                if v.is_floating_point() else v)
            for k, v in client_params.items()}


def gate_updates(client_params: Dict[str, torch.Tensor],
                 w_intra: torch.Tensor, ref: Dict[str, torch.Tensor],
                 clip_norm: float):
    """The gate body: ``client_params`` is the K-stacked decoded uplink
    dict, ``w_intra`` the (K,) Eq. 4 sample weights, ``ref`` the params
    the clients trained from.  Returns ``(sanitized_params,
    gated_weights, any_ok)``, ``any_ok`` a 0-d bool tensor (never read on
    the host here):

      * clients with any non-finite float leaf get weight 0 and their
        payload replaced by ``ref`` (sanitize, then weight);
      * with ``clip_norm > 0`` each surviving delta from ``ref`` is
        clipped to that L2 norm, summed in f32 over the leaves in the
        reference's leaf order (sorted keys);
      * surviving weights renormalize to 1 over the finite clients;
      * ``any_ok`` is False when *no* client survived — callers keep the
        previous model in that case.
    """
    keys = sorted(client_params)
    k = w_intra.shape[0]
    ok = torch.ones((k,), dtype=torch.bool, device=w_intra.device)
    for key in keys:
        leaf = client_params[key]
        if leaf.is_floating_point():
            ok = ok & torch.isfinite(leaf).reshape(k, -1).all(dim=1)
    client_params = {
        key: torch.where(_expand(ok, client_params[key]), client_params[key],
                         ref[key][None].expand_as(client_params[key]))
        for key in keys}

    if clip_norm > 0:
        sq = torch.zeros((k,), dtype=torch.float32, device=w_intra.device)
        for key in keys:
            d = (client_params[key].to(torch.float32)
                 - ref[key][None].to(torch.float32))
            sq = sq + (d.reshape(k, -1) ** 2).sum(dim=1)
        norm = torch.sqrt(sq)
        scale = (clip_norm / norm.clamp_min(1e-12)).clamp_max(1.0)
        client_params = {
            key: (ref[key][None].to(torch.float32)
                  + (client_params[key].to(torch.float32)
                     - ref[key][None].to(torch.float32))
                  * _expand(scale, client_params[key])
                  ).to(client_params[key].dtype)
            for key in keys}

    w = w_intra * ok
    total = w.sum()
    any_ok = total > 0
    w = torch.where(any_ok, w / total.clamp_min(1e-30), torch.zeros_like(w))
    return client_params, w, any_ok
