"""Client-side local training (FedAT §4.2), batched over clients.

Each selected client k minimizes the proximal surrogate (Eq. 5):

    h_k(w_k) = F_k(w_k) + (lambda/2) ||w_k - w_global||^2

with a local Adam solver (paper hyperparameters: E epochs, batch 10).  The
port of ``repro/core/clients.py``: the K clients of a round train together
as one client-batched model (every param carries a leading K axis), the
written-out form of the reference's ``vmap``.  Gradients come from
autograd; the sum of the K independent per-client objectives has each
client's gradient as its own slice.

The per-epoch shuffles arrive as an explicit ``(K, E, cap)`` integer
tensor of permutations (the reference draws them with
``jax.random.permutation`` inside the step; the executor supplies them —
core/executor.py).

Spans (spans.py): ``client.update`` around the whole update, and in each
local step ``client.gather`` (the batch index), ``client.fwd`` (the loss
and the prox term), ``client.bwd`` (autograd) and ``client.opt`` (Adam).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch import spans

Params = Dict[str, torch.Tensor]


def make_client_update(model, local_epochs: int = 3, batch_size: int = 10,
                       lr: float = 1e-3, prox_lambda: float = 0.4
                       ) -> Callable:
    """Returns update(global_params, client_batch, perms).

    ``global_params``: the model the clients start from (dict, no client
    axis).  ``client_batch``: {"x": (K, cap, ...), "y": (K, cap),
    "mask": (K, cap)}.  ``perms``: (K, E, cap) int64 permutations of the
    sample slots, one per client and epoch.  Returns (client params
    stacked (K, ...), local loss of the last epoch (K,)).
    """

    def update(global_params: Params, batch: Dict[str, torch.Tensor],
               perms: torch.Tensor) -> Tuple[Params, torch.Tensor]:
        with spans.span("client.update"):
            return _update(global_params, batch, perms)

    def _update(global_params, batch, perms):
        K, cap = batch["y"].shape
        if perms.shape != (K, local_epochs, cap):
            raise ValueError(f"perms must be (K={K}, E={local_epochs}, "
                             f"cap={cap}), got {tuple(perms.shape)}")
        if cap < batch_size:
            raise ValueError(f"client sample cap {cap} < batch size "
                             f"{batch_size}")
        n_batches = cap // batch_size
        keys = sorted(global_params)
        g = {k: global_params[k].detach().unsqueeze(0).expand(
            (K,) + tuple(global_params[k].shape)) for k in keys}
        params = {k: g[k].clone() for k in keys}
        m = {k: torch.zeros_like(params[k]) for k in keys}
        v = {k: torch.zeros_like(params[k]) for k in keys}
        rows = torch.arange(K, device=perms.device)[:, None]
        cnt = 0
        ce_last = None
        for e in range(local_epochs):
            ces = []
            for i in range(n_batches):
                with spans.span("client.gather"):
                    idx = perms[:, e, i * batch_size:(i + 1) * batch_size]
                    xb = batch["x"][rows, idx]
                    yb = batch["y"][rows, idx]
                    mb = batch["mask"][rows, idx]
                with spans.span("client.fwd"), torch.enable_grad():
                    p = {k: params[k].requires_grad_(True) for k in keys}
                    ce = model.loss(p, xb, yb, mb)            # (K,)
                    obj = ce
                    if prox_lambda:
                        prox = sum(
                            (p[k] - g[k]).square().flatten(1).sum(dim=1)
                            for k in keys)
                        obj = ce + 0.5 * prox_lambda * prox
                with spans.span("client.bwd"), torch.enable_grad():
                    grads = torch.autograd.grad(obj.sum(),
                                                [p[k] for k in keys])
                ces.append(ce.detach())
                # Adam with the reference's constants and bias correction
                cnt += 1
                c1 = float(np.float32(1) - np.float32(0.9) ** np.float32(cnt))
                c2 = float(np.float32(1)
                           - np.float32(0.999) ** np.float32(cnt))
                with spans.span("client.opt"), torch.no_grad():
                    for k, gr in zip(keys, grads):
                        m[k] = 0.9 * m[k] + 0.1 * gr
                        v[k] = 0.999 * v[k] + 0.001 * gr.square()
                        params[k] = params[k].detach() - lr * (m[k] / c1) / (
                            torch.sqrt(v[k] / c2) + 1e-8)
            ce_last = torch.stack(ces).mean(dim=0)
        return {k: params[k].detach() for k in keys}, ce_last

    return update


def make_eval_fn(model, chunk: int = 1024) -> Callable:
    """Per-client test accuracy with one shared model: (params, x (C, N,
    ...), y, mask) -> (C,), the bound model's ``eval_metrics``.  Clients
    go through the model in groups of about ``chunk`` samples, so the
    im2col buffers stay bounded."""

    @torch.no_grad()
    def evaluate(params: Params, x, y, mask) -> torch.Tensor:
        C, N = y.shape
        step = max(1, chunk // max(N, 1))
        out = []
        for s in range(0, C, step):
            c = min(step, C - s)
            p = {k: v[None].expand((c,) + tuple(v.shape))
                 for k, v in params.items()}
            out.append(model.eval_metrics(p, x[s:s + c], y[s:s + c],
                                          mask[s:s + c]))
        return torch.cat(out)

    return evaluate
