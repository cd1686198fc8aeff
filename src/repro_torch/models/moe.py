"""Mixture-of-experts FFN (GShard/Switch-style dense dispatch).

The port of ``repro/models/moe.py``.  The reference's two sharding
modes (experts over the ``model`` axis, or each expert's d_ff over it)
choose the logical axes of the expert weights (:func:`moe_specs`); the
values are the same either way, and the annotations are layouts
(runtime/sharding.py).

Token-choice top-k routing with per-group capacity; dropped tokens fall
through on the residual path.  Groups are 256-token chunks of the sequence
(training, and a prefill padded to a multiple of 256), or one group of all
``B*S`` tokens for decode and short inputs, which must not drop a token.
Dispatch and combine are plain dense products (``torch.einsum``), as the
reference computes them outside any kernel.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import PSpec

GROUP = 256  # tokens per routing group (capacity granularity)

_ROUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def use_ep(cfg: ModelConfig, tp: int) -> bool:
    """Experts sharded over the model axis (only with tp > 1)."""
    return tp > 1 and cfg.moe.n_experts % tp == 0


def moe_specs(cfg: ModelConfig, tp: int, prefix_layers: Tuple[int, ...] = ()
              ) -> Dict[str, PSpec]:
    m, d = cfg.moe, cfg.d_model
    L = prefix_layers
    lax_ = tuple("layers" for _ in L)
    e_ax = ("experts", "fsdp", None) if use_ep(cfg, tp) else (None, "fsdp", "tp")
    eo_ax = ("experts", None, "fsdp") if use_ep(cfg, tp) else (None, "tp", "fsdp")
    sp = {
        "router": PSpec(L + (d, m.n_experts), lax_ + ("fsdp", None), init="small"),
        "w_gate": PSpec(L + (m.n_experts, d, m.expert_d_ff), lax_ + e_ax),
        "w_in": PSpec(L + (m.n_experts, d, m.expert_d_ff), lax_ + e_ax),
        "w_out": PSpec(L + (m.n_experts, m.expert_d_ff, d), lax_ + eo_ax),
    }
    if m.n_shared_experts:
        ff = m.n_shared_experts * (m.shared_d_ff or m.expert_d_ff)
        sp["ws_gate"] = PSpec(L + (d, ff), lax_ + ("fsdp", "tp"))
        sp["ws_in"] = PSpec(L + (d, ff), lax_ + ("fsdp", "tp"))
        sp["ws_out"] = PSpec(L + (ff, d), lax_ + ("tp", "fsdp"))
    return sp


def capacity(cfg: ModelConfig, G: int, dropless: bool = False) -> int:
    """Slots per expert in a group of G tokens (Python floats, as the
    reference computes it); a dropless group gives every expert G."""
    m = cfg.moe
    if dropless:
        return G
    return max(int(m.capacity_factor * m.top_k * G / m.n_experts), 1)


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest, descending, the lower index first
    among equal values.  A stable descending sort gives that order on any
    device; ``torch.topk`` promises no order for ties."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(cfg: ModelConfig, router_w: torch.Tensor, xg: torch.Tensor,
           dropless: bool = False):
    """xg: (..., G, d) -> combine (..., G, E, C) in ``route_dtype``,
    dispatch bools, aux losses (load balance + router z-loss)."""
    m = cfg.moe
    G = xg.shape[-2]
    cap = capacity(cfg, G, dropless)
    rdt = _ROUTE_DTYPES[m.route_dtype]

    logits = torch.einsum("...gd,de->...ge", xg.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = _top_k(probs, m.top_k)                  # (..., G, k)

    # the (..., G, E, C) combine tensor accumulated one k-slice at a time:
    # top-1 assignments win expert capacity over top-2, etc.
    lead = xg.shape[:-2]
    combine = torch.zeros(lead + (G, m.n_experts, cap), dtype=rdt,
                          device=xg.device)
    filled = torch.zeros(lead + (m.n_experts,), dtype=rdt, device=xg.device)
    oh_sum = torch.zeros(lead + (m.n_experts,), dtype=torch.float32,
                         device=xg.device)
    for kk in range(m.top_k):
        oh = F.one_hot(idx[..., kk], m.n_experts).to(rdt)        # (...,G,E)
        pos = torch.cumsum(oh, dim=-2) - 1.0 + filled[..., None, :]
        keep = (pos < cap) & (oh > 0)
        slot = torch.clamp((pos * oh).sum(-1), 0, cap - 1).long()
        slot_oh = F.one_hot(slot, cap).to(rdt)                   # (...,G,C)
        kept_gate = gate_vals[..., kk].to(rdt) * keep.sum(-1)    # (...,G)
        combine = combine + (oh * keep)[..., None] * \
            (kept_gate[..., None] * slot_oh)[..., None, :]
        filled = filled + oh.sum(dim=-2)
        oh_sum = oh_sum + oh.sum(dim=-2).float()
    dispatch = combine > 0

    # aux losses (Switch-style load balance + router z-loss)
    me = probs.mean(dim=tuple(range(probs.dim() - 1)))
    ce = oh_sum.mean(dim=tuple(range(oh_sum.dim() - 1))) / G * m.top_k
    aux = m.n_experts * torch.sum(me * ce) * m.aux_loss_coef
    zloss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2) * m.router_z_coef
    return combine, dispatch, aux + zloss


def group_tokens(x: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """x (B, S, d) -> (xg (n, g, G, d), dropless): 256-token groups along
    the sequence when it splits into them, else one dropless group of all
    B*S tokens (decode, short inputs)."""
    B, S, d = x.shape
    if S >= GROUP and S % GROUP == 0:
        return x.reshape(B, S // GROUP, GROUP, d), False
    return x.reshape(1, 1, B * S, d), True


def moe_ffn(cfg: ModelConfig, p, x: torch.Tensor, tp: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss)."""
    B, S, d = x.shape
    xg, dropless = group_tokens(x)
    combine, dispatch, aux = _route(cfg, p["router"], xg, dropless)
    combine = combine.to(x.dtype)

    # dispatch: (n, g, G, E, C) x tokens (n, g, G, d) -> (n, g, E, C, d)
    xe = torch.einsum("ngtec,ngtd->ngecd", dispatch.to(x.dtype), xg)
    h = torch.einsum("ngecd,edf->ngecf", xe, p["w_gate"])
    u = torch.einsum("ngecd,edf->ngecf", xe, p["w_in"])
    h = F.silu(h) * u
    ye = torch.einsum("ngecf,efd->ngecd", h, p["w_out"])
    y = torch.einsum("ngtec,ngecd->ngtd", combine, ye).reshape(B, S, d)

    if cfg.moe.n_shared_experts:
        g = torch.matmul(x, p["ws_gate"])
        u2 = torch.matmul(x, p["ws_in"])
        y = y + torch.matmul(F.silu(g) * u2, p["ws_out"])
    return y, aux
