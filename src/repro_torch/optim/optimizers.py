"""Optimizers over trees of tensors: SGD(+momentum), Adam, AdamW.

The port of ``repro/optim/optimizers.py``, with its arithmetic:

    opt = adamw(lr=3e-4, weight_decay=0.1)
    state = opt.init(params)
    params, state = opt.step(params, grads, state, lr_scale=1.0)

Params, grads and state are nested dicts of tensors; the state mirrors
the params' tree (AdamW: fp32 moments ``m``, ``v`` whatever the param
dtype, and an int32 ``count``).  Gradients are clipped by their global
norm (``+1e-12`` in the divisor), the bias corrections ``1 - b**count``
are taken in fp32, and the decoupled weight decay is added to the
update, as in the reference.

``sgd``'s step returns new params and state.  ``adamw``'s updates the
params and the moments in place, leaf by leaf, and returns them: a model
of billions of parameters then holds one copy of each (the trainer's
qwen2-7b-width state is 21.5 GB).  Each product is still formed before
its sum, so the roundings are the reference's functional form's.  The
update is elementwise, so on a rank's FSDP shards (core/steps.py) it
runs unchanged; the clip's norm is then :func:`global_norm` over the
data group, passed to ``step``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    step: Callable[..., Tuple[Any, Any]]
    name: str


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (the same keys in each)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_leaves(tree):
    """Leaves in sorted-key order (the order jax flattens a dict in)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _count(params) -> torch.Tensor:
    """A zero int32 step count on the params' device."""
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def sgd(lr: float, momentum: float = 0.0, nesterov: bool = False
        ) -> Optimizer:
    def init(params):
        count = _count(params)
        if momentum == 0.0:
            return {"count": count}
        return {"mu": tree_map(torch.zeros_like, params), "count": count}

    def step(params, grads, state, lr_scale=1.0):
        eta = lr * lr_scale
        if momentum == 0.0:
            new_p = tree_map(lambda p, g: p - eta * g, params, grads)
            return new_p, {"count": state["count"] + 1}
        mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
        upd = (tree_map(lambda m, g: momentum * m + g, mu, grads)
               if nesterov else mu)
        new_p = tree_map(lambda p, u: p - eta * u, params, upd)
        return new_p, {"mu": mu, "count": state["count"] + 1}

    return Optimizer(init, step, "sgd")


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0, grad_clip: Optional[float] = None
          ) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": _count(params)}

    def step(params, grads, state, lr_scale=1.0, norm=None):
        """``norm``: the gradients' global norm for the clip when the
        caller has it (a step sharded over data ranks sums its shards'
        squares over them: :func:`global_norm`); computed here
        otherwise."""
        scale = None
        if grad_clip is not None:
            gnorm = global_norm(grads) if norm is None else norm
            scale = torch.clamp(grad_clip / (gnorm + 1e-12), max=1.0)
        count = state["count"] + 1
        cf = count.to(torch.float32)
        c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                          device=cf.device), cf)
        c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                          device=cf.device), cf)
        eta = lr * lr_scale
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["m"]),
                              tree_leaves(state["v"])):
            g = (g * scale if scale is not None else g).float()
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g.square())
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            if weight_decay:
                u = u + weight_decay * p.float()
            p.copy_(p.float() - eta * u)
        return params, {"m": state["m"], "v": state["v"], "count": count}

    return Optimizer(init, step, "adamw")


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
         ) -> Optimizer:
    return adamw(lr, b1, b2, eps, weight_decay=0.0)


def global_norm(tree, group=None, sharded=None) -> torch.Tensor:
    """sqrt of the sum over leaves (sorted-key order) of each leaf's
    fp32 sum of squares.  With a process ``group``, the leaves that
    ``sharded`` (a same-structure tree of bools) marks are shards of
    leaves split over the group's ranks: their squares are summed here
    and over the ranks by one ``all_reduce``, and the other leaves, whole
    and equal on every rank, are counted once."""
    if group is None:
        total = None
        for leaf in tree_leaves(tree):
            sq = leaf.float().square().sum()
            total = sq if total is None else total + sq
        return torch.sqrt(total)
    parts = {True: [], False: []}
    for leaf, s in zip(tree_leaves(tree), tree_leaves(sharded)):
        parts[bool(s)].append(leaf.float().square().sum())
    dev = tree_leaves(tree)[0].device
    split = (torch.stack(parts[True]).sum() if parts[True]
             else torch.zeros((), dtype=torch.float32, device=dev))
    torch.distributed.all_reduce(split, group=group)
    whole = (torch.stack(parts[False]).sum() if parts[False]
             else torch.zeros((), dtype=torch.float32, device=dev))
    return torch.sqrt(split + whole)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable[[Any], torch.Tensor]:
    """step (int or int tensor) -> fp32 scalar tensor on the step's
    device.  Warmup counts from step + 1, so schedule(0) > 0."""
    def fn(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp((step + 1.0) / max(warmup, 1), max=1.0)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * warm * cos
    return fn
