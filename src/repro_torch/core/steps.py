"""Train steps, single-pod and multi-pod (FedAT pods-as-tiers).

The port of ``repro/core/steps.py``.  Datacenter-scale mapping of the
paper: a *tier* is a pod (the ``pod`` axis of a mesh, launch/mesh.py),
intra-tier synchronous training is a data-parallel step over the
``data`` ranks, and the cross-tier asynchronous update is a per-pod model
replica mixed every ``sync_every`` steps by Eq. 3 weights computed from
the per-tier update counts, its payload quantized per last-dim row
(int8/int16, or two int4 nibbles a byte) on the wire.

* :func:`make_single_pod_step`: a forward and backward of ``lm.loss_fn``
  per microbatch with the gradients summed in fp32 and divided by the
  microbatch count, the cosine schedule, and AdamW with global-norm
  clipping.  On a mesh of D ranks each rank takes B/D rows of the global
  batch and the gradients are averaged over the ranks before AdamW; with
  no mesh or one rank it is the one-device step, unchanged.
* :func:`make_fedat_step`: each rank holds the state of its pod slot
  (a leading pod dim of 1), runs the per-pod update, and at a sync step
  quantizes each leaf per row (:func:`quantize_rows`, the reference's
  ``_mix_leaf``), exchanges the int payloads and scales over the pod
  group (one broadcast of each from every pod: the bytes of an
  all-gather), dequantizes and mixes them by
  ``aggregation.cross_tier_weights(counts)`` (Eq. 3), so the pods hold
  equal params after it.  The per-row quantize is not a Pallas kernel in
  the reference, so plain torch ops compute it.

The state is laid out as the reference's ``state_shardings`` say
(``StepFns`` carries them on a mesh): with D > 1 data ranks, every leaf
whose layout has an ``fsdp`` dimension (the reference's ``"fsdp":
"data"``) -- params, AdamW ``m``/``v`` and the fp32 gradient sum -- is
held as this rank's 1/D shard (ZeRO-3, runtime/sharding.py ``FSDP``).
The forward gathers one layer's shards at a time (``lm.anchor_params``),
the backward reduce-scatters their gradients, AdamW updates the shards
in place, and the clip's global norm sums the shards' squares over the
data group; leaves with no ``fsdp`` dimension are kept whole and
averaged by an ``all_reduce``.  At a multi-pod sync each rank quantizes
and exchanges its own shard, a split row's scale from the row's amax
over the data group.  The state is updated in place (``optim.adamw``),
so a model of billions of parameters keeps one copy of its params and
moments on the card.  No mesh, or one data rank, is the one-device step:
every leaf whole, no collective.

It is the same for every family: ``lm.loss_fn`` dispatches (the
recurrent families' scans carry their own backward).

The fault plane's server-side update gate (:class:`UpdateGate`,
:func:`poison_updates`, :func:`gate_updates`) runs as plain torch ops on
the K-stacked client dict, with no host read, inside the executor's gated
rounds.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import aggregation
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import common, lm
from repro_torch.optim import adamw, cosine_schedule, global_norm
from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.runtime import sharding as shd


def opt_axes_like(param_axes):
    """AdamW m/v shard exactly like their params (ZeRO: fsdp dims)."""
    return {"m": param_axes, "v": param_axes, "count": ()}


@dataclasses.dataclass(frozen=True)
class StepFns:
    train_step: Callable
    init_state: Callable
    state_shardings: Any
    batch_shardings: Any


def _loss_and_grads(cfg: ModelConfig, params, batch, tp: int,
                    microbatch: int, mesh=None
                    ) -> Tuple[torch.Tensor, Dict[str, Any],
                               Dict[str, torch.Tensor]]:
    """(mean loss, grads tree, mean loss metrics: ``ce_loss`` and
    ``aux_loss``).  With ``microbatch`` k > 1 the batch is split into k
    slices along its leading dim; their fp32 gradients are summed and
    divided by k, and so are their losses.  On a ``mesh`` with data ranks
    the params are this rank's shards, gathered where the model reads
    them (``lm.anchor_params`` under the mesh), and a sharded leaf's
    gradient comes back as this rank's shard of the sum over the data
    ranks (the gather's backward), so the fp32 sum is held at shard
    size."""
    flat = common.flatten_tree(params)
    names = list(flat)

    def value_and_grad(b):
        leaves = [flat[n].detach().requires_grad_(True) for n in names]
        with torch.enable_grad():
            with shd.use_mesh(mesh):
                p = lm.anchor_params(
                    cfg, common.unflatten_tree(dict(zip(names, leaves))), tp)
            loss, metrics = lm.loss_fn(cfg, p, b, tp)
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


def _to_device(batch, device: torch.device, rows: slice = slice(None)
               ) -> Dict[str, torch.Tensor]:
    """Rows ``rows`` of every leaf (numpy or tensor) on ``device``."""
    return {k: (torch.from_numpy(np.asarray(v)) if not isinstance(
        v, torch.Tensor) else v)[rows].to(device) for k, v in batch.items()}


def _rank_rows(n: int, index: int, ranks: int) -> slice:
    if n % ranks:
        raise ValueError(f"a batch of {n} rows does not split over "
                         f"{ranks} data ranks")
    k = n // ranks
    return slice(index * k, (index + 1) * k)


def _data_parallel(mesh, axes: Tuple[str, ...]):
    """(ranks, this rank's index, group) of the data-parallel line over
    ``axes`` of ``mesh`` (1, 0, None without one)."""
    if mesh is None:
        return 1, 0, None
    mesh.require_runnable("a train step")
    live = [a for a in axes if mesh.shape.get(a, 1) > 1]
    if not live:
        return 1, 0, None
    if len(live) == 1:
        group, ranks = mesh.group(live[0])
        return len(ranks), mesh.coord(live[0]), group
    return mesh.size, mesh.rank, None     # every rank: the world group


def _mean_over(tensors: List[torch.Tensor], ranks: int, group) -> None:
    """In place: each tensor summed over ``group`` and divided by
    ``ranks`` (nothing for one rank)."""
    if ranks == 1:
        return
    for t in tensors:
        dist.all_reduce(t, group=group)
        t.div_(ranks)


def _split_leaves(cfg: ModelConfig, tp: int, mesh,
                  fsdp: Optional[shd.FSDP]):
    """A tree of bools over the params: True where the leaf is held as an
    FSDP shard (its layout splits it over ``data``)."""
    axes = lm.param_axes(cfg, tp)
    if fsdp is None:
        return tree_map(lambda a: False, axes)
    return tree_map(lambda a: shd.split_dim(shd.logical_sharding(
        a, mesh)) is not None, axes)


def _mean_grads(grads, split, ranks: int, group, pods: int = 1,
                pod_group=None) -> None:
    """In place: the gradients averaged over the ``ranks`` data-parallel
    ranks.  A shard's gradient already holds the sum over the data ranks
    (the gather's reduce-scatter), summed over ``pod_group`` too when the
    step's rows span pods; a whole leaf's is all-reduced (``group``)."""
    whole, shards = [], []
    for g, s in zip(tree_leaves(grads), tree_leaves(split)):
        (shards if s else whole).append(g)
    _mean_over(whole, ranks, group)
    for g in shards:
        if pods > 1:
            dist.all_reduce(g, group=pod_group)
        g.div_(ranks)


def _state_layouts(cfg: ModelConfig, tp: int, mesh, pod_axis: bool):
    """The state's resolved layouts on ``mesh`` (None without one), as
    the reference's ``state_shardings``: params and AdamW m/v by their
    logical axes (behind a leading ``pod`` under ``pod_axis``), and the
    inputs' by ``lm.input_axes``."""
    if mesh is None:
        return None, None
    axes = lm.param_axes(cfg, tp)
    p_sh = tree_map(lambda a: shd.logical_sharding(a, mesh), axes)
    in_axes = lm.input_axes(cfg, None_shape(cfg))
    if not pod_axis:
        return ({"params": p_sh, "opt": {"m": p_sh, "v": p_sh,
                                         "count": None}, "step": None},
                {k: shd.logical_sharding(a, mesh)
                 for k, a in in_axes.items()})
    p_sh = tree_map(lambda a: ("pod",) + tuple(a), p_sh)
    return ({"params": p_sh, "opt": {"m": p_sh, "v": p_sh,
                                     "count": ("pod",)},
             "step": ("pod",), "counts": ()},
            {k: ("pod", "data") + (None,) * (len(a) - 1)
             for k, a in in_axes.items()})


def _sync_metrics(loss, parts, ranks: int, group):
    """The loss and its parts averaged over the data ranks (equal on
    every rank after)."""
    if ranks == 1:
        return loss, parts
    keys = sorted(parts)
    buf = torch.stack([loss.float()] + [parts[k].float() for k in keys])
    _mean_over([buf], ranks, group)
    return buf[0], {k: buf[i + 1] for i, k in enumerate(keys)}


def make_single_pod_step(cfg: ModelConfig, tcfg: TrainConfig,
                         mesh: Any = None, param_dtype=torch.float32,
                         device: DeviceLike = None) -> StepFns:
    """``init_state(seed)`` draws the params on ``device`` (None = the
    card) from a generator seeded with ``seed``; ``train_step(state,
    batch)`` -> (state, {"loss", "grad_norm", "lr_scale", "ce_loss",
    "aux_loss"}), the state updated in place (the reference's metrics,
    plus the loss's two parts).  ``batch`` is the global batch; on a mesh
    of D data ranks (the ``pod`` and ``data`` axes) each rank trains its
    B/D rows and the gradients are averaged over the ranks before AdamW.
    With ``data`` > 1 the state is sharded over it (module docstring):
    ``init_state`` keeps this rank's shard of each leaf as it draws it,
    and ``StepFns.state_shardings`` holds the layouts.  No mesh, or a
    one-rank mesh, is the one-device step with no collective."""
    ranks, index, group = _data_parallel(mesh, ("pod", "data"))
    pods, _, pod_group = _data_parallel(mesh, ("pod",))
    tp = 1
    dev = resolve_device(device)
    fsdp = shd.FSDP.over(mesh)
    split = _split_leaves(cfg, tp, mesh, fsdp)
    opt = adamw(tcfg.lr, tcfg.betas[0], tcfg.betas[1], tcfg.eps,
                tcfg.weight_decay, grad_clip=tcfg.grad_clip)
    sched = cosine_schedule(1.0, tcfg.warmup_steps, tcfg.total_steps)
    state_sh, batch_sh = _state_layouts(cfg, tp, mesh, pod_axis=False)

    def init_state(seed: int):
        params = lm.init_params(cfg, seed, tp, param_dtype, device=dev,
                                mesh=mesh if fsdp else None)
        return {"params": params, "opt": opt.init(params),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    def train_step(state, batch):
        n = len(next(iter(batch.values())))
        batch = _to_device(batch, dev, _rank_rows(n, index, ranks)
                           if ranks > 1 else slice(None))
        params = state["params"]
        loss, grads, parts = _loss_and_grads(cfg, params, batch, tp,
                                             cfg.microbatch, mesh)
        _mean_grads(grads, split, ranks, group, pods, pod_group)
        loss, parts = _sync_metrics(loss, parts, ranks, group)
        lr_scale = sched(state["step"])
        grad_norm = global_norm(grads, fsdp and fsdp.group, split)
        new_params, new_opt = opt.step(params, grads, state["opt"],
                                       lr_scale, norm=grad_norm)
        metrics = {"loss": loss, "grad_norm": grad_norm,
                   "lr_scale": lr_scale, **parts}
        return ({"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1}, metrics)

    return StepFns(train_step, init_state, state_sh, batch_sh)


def None_shape(cfg):  # minimal train-kind shape token for input_axes
    from repro_torch.configs.shapes import ShapeConfig
    return ShapeConfig("train", 1, 1, "train")


# ---------------------------------------------------------------------------
# multi-pod FedAT step (pods as tiers)
# ---------------------------------------------------------------------------

def quantize_rows(x: torch.Tensor, bits: int,
                  amax: Optional[torch.Tensor] = None):
    """One pod's leaf -> (payload, row scales) on the wire, as the
    reference's ``_mix_leaf`` forms them: scales ``max|row| / qmax``
    (floored at 1e-30) per last-dim row, codes ``round(x / scale)``
    clipped to +-qmax.  ``bits`` 16/8 give int16/int8 codes; 4 with an
    even last dim packs two nibbles (code + 8) a byte, high nibble first;
    4 with an odd last dim gives int8 codes of qmax 7; 0 sends fp32 and
    no scale (None).  ``amax`` (the rows' max |x|, keepdim) stands in for
    ``x``'s own when ``x`` is a shard of longer rows
    (:func:`quantize_shards`)."""
    xf = x.to(torch.float32)
    if not bits:
        return xf, None
    qmax = 7.0 if bits == 4 else float((1 << (min(bits, 16) - 1)) - 1)
    if amax is None:
        amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax / qmax, 1e-30)
    q = torch.clamp(torch.round(xf / scale), -qmax, qmax)
    if bits == 4 and x.shape[-1] % 2 == 0:
        pairs = (q + 8.0).reshape(*q.shape[:-1], q.shape[-1] // 2, 2)
        return (pairs[..., 0] * 16 + pairs[..., 1]).to(torch.uint8), scale
    return q.to(torch.int8 if bits <= 8 else torch.int16), scale


def dequantize_rows(payload: torch.Tensor, scale: Optional[torch.Tensor],
                    shape: Tuple[int, ...]) -> torch.Tensor:
    """Inverse of :func:`quantize_rows` (any leading dims), fp32."""
    if scale is None:
        return payload.to(torch.float32)
    if payload.dtype == torch.uint8:
        hi = torch.div(payload, 16, rounding_mode="floor").float() - 8.0
        lo = torch.remainder(payload, 16).float() - 8.0
        q = torch.stack([hi, lo], dim=-1).reshape(
            *payload.shape[:-1], shape[-1])
        return q * scale
    return payload.to(torch.float32) * scale


def quantize_shards(shards: List[torch.Tensor], bits: int,
                    split_last: List[bool], group=None):
    """:func:`quantize_rows` of each of a rank's leaves.  Where a leaf's
    last dimension is split over the ranks of ``group`` (FSDP over
    ``data``), its rows' amax is the max over the ranks (one
    ``all_reduce`` MAX for every such leaf), so its codes and scales are
    bitwise those of the whole rows."""
    amax: List[Optional[torch.Tensor]] = [None] * len(shards)
    idx = [i for i, s in enumerate(split_last) if s]
    if bits and group is not None and idx:
        local = [shards[i].to(torch.float32).abs().amax(dim=-1, keepdim=True)
                 for i in idx]
        buf = torch.cat([a.reshape(-1) for a in local])
        dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=group)
        off = 0
        for i, a in zip(idx, local):
            amax[i] = buf[off:off + a.numel()].view(a.shape)
            off += a.numel()
    return [quantize_rows(x, bits, a) for x, a in zip(shards, amax)]


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def exchange_pods(payloads: List[torch.Tensor], scales: List[torch.Tensor],
                  n_pods: int, group, ranks: List[int]):
    """Every pod's payloads and scales on every rank of the pod group:
    one byte buffer of this pod's payloads and one fp32 buffer of its
    scales, and ``n_pods`` broadcasts of each into (P, ...) buffers (the
    bytes of an all-gather; gloo takes CUDA tensors in broadcast, not in
    all_gather).  Returns the two gathered buffers; one pod gathers
    nothing."""
    mine = torch.cat([_as_bytes(p) for p in payloads])
    sc = (torch.cat([s.reshape(-1) for s in scales]) if scales else
          torch.zeros(0, dtype=torch.float32, device=mine.device))
    if n_pods == 1:
        return mine[None], sc[None]
    me = dist.get_rank()
    out = []
    for buf in (mine, sc):
        full = torch.empty((n_pods,) + tuple(buf.shape), dtype=buf.dtype,
                           device=buf.device)
        for p, src in enumerate(ranks):
            if src == me:
                full[p].copy_(buf)
            dist.broadcast(full[p], src=src, group=group)
        out.append(full)
    return out[0], out[1]


def make_fedat_step(cfg: ModelConfig, tcfg: TrainConfig, mesh,
                    param_dtype=torch.float32,
                    device: DeviceLike = None) -> StepFns:
    """Multi-pod train step: per-pod update + compressed cross-tier mix.

    ``mesh`` needs a ``pod`` axis.  Each rank's state holds its pod slot
    (a leading pod dim of 1): ``params``, AdamW ``m``/``v``/``count`` and
    ``step``, plus the (n_pods,) update ``counts`` every rank keeps
    whole; with ``data`` > 1 the params and moments are this rank's FSDP
    shards of its pod's (module docstring).  ``train_step(state, batch)``
    takes the batch pre-split ``(n_pods, B/n_pods, ...)``
    (:func:`split_batch_for_pods`); the rank trains its pod's rows
    (B/n_pods/D of them on each of D data ranks, gradients averaged over
    those), and every ``tcfg.fedat_sync_every`` steps mixes the pods at
    ``tcfg.fedat_compress_bits`` (Eq. 3), each rank its own shard.
    Returns (state, {"loss" (mean over pods), "ce_loss", "aux_loss",
    "synced", "payload_bytes": this rank's bytes on the wire at a sync,
    payload and scales, else 0})."""
    if mesh is None or "pod" not in mesh.shape:
        raise ValueError("make_fedat_step needs a multi-pod mesh (a 'pod' "
                         "axis)")
    mesh.require_runnable("a train step")
    n_pods = mesh.shape["pod"]
    pod = mesh.coord("pod")
    pod_group, pod_ranks = (mesh.group("pod") if n_pods > 1
                            else (None, [mesh.rank]))
    d_ranks, d_index, d_group = _data_parallel(mesh, ("data",))
    tp = 1
    dev = resolve_device(device)
    fsdp = shd.FSDP.over(mesh)
    split = _split_leaves(cfg, tp, mesh, fsdp)
    # a leaf whose last dimension is split: its rows span the data ranks
    split_last = [shd.split_dim(shd.logical_sharding(a, mesh)) == len(a) - 1
                  if fsdp else False for a in tree_leaves(
                      lm.param_axes(cfg, tp))]
    opt = adamw(tcfg.lr, tcfg.betas[0], tcfg.betas[1], tcfg.eps,
                tcfg.weight_decay, grad_clip=tcfg.grad_clip)
    sched = cosine_schedule(1.0, tcfg.warmup_steps, tcfg.total_steps)
    bits = int(tcfg.fedat_compress_bits)
    state_sh, batch_sh = _state_layouts(cfg, tp, mesh, pod_axis=True)

    def init_state(seed: int):
        params = lm.init_params(cfg, seed, tp, param_dtype, device=dev,
                                mesh=mesh if fsdp else None)
        stacked = tree_map(lambda a: a.unsqueeze(0), params)
        zeros = lambda a: torch.zeros_like(a, dtype=torch.float32)  # noqa
        return {"params": stacked,
                "opt": {"m": tree_map(zeros, stacked),
                        "v": tree_map(zeros, stacked),
                        "count": torch.zeros(1, dtype=torch.int32,
                                             device=dev)},
                "step": torch.zeros(1, dtype=torch.int32, device=dev),
                "counts": torch.zeros(n_pods, dtype=torch.float32,
                                      device=dev)}

    def mix(params, weights) -> int:
        """Eq. 3 over the pods' dequantized payloads, written into this
        rank's params (its shards) in place; returns the bytes this rank
        sent."""
        leaves = tree_leaves(params)
        wire = quantize_shards([x[0] for x in leaves], bits, split_last,
                               fsdp and fsdp.group)
        payloads = [p for p, _ in wire]
        scales = [s for _, s in wire if s is not None]
        full, full_sc = exchange_pods(payloads, scales, n_pods, pod_group,
                                      pod_ranks)
        off = soff = 0
        for x, (p, s) in zip(leaves, wire):
            nb = p.numel() * p.element_size()
            pay = full[:, off:off + nb].contiguous().view(p.dtype).reshape(
                (n_pods,) + tuple(p.shape))
            off += nb
            sc = None
            if s is not None:
                sc = full_sc[:, soff:soff + s.numel()].reshape(
                    (n_pods,) + tuple(s.shape))
                soff += s.numel()
            vals = dequantize_rows(pay, sc, tuple(x.shape[1:]))
            mixed = torch.einsum("p,p...->...", weights, vals)
            x.copy_(mixed[None].to(x.dtype))
        return full.shape[1] + 4 * full_sc.shape[1]

    def train_step(state, batch):
        n = len(next(iter(batch.values()))[pod])
        local = {k: v[pod] for k, v in batch.items()}
        local = _to_device(local, dev, _rank_rows(n, d_index, d_ranks)
                           if d_ranks > 1 else slice(None))
        params = tree_map(lambda a: a[0], state["params"])
        opt_state = {"m": tree_map(lambda a: a[0], state["opt"]["m"]),
                     "v": tree_map(lambda a: a[0], state["opt"]["v"]),
                     "count": state["opt"]["count"][0]}
        loss, grads, parts = _loss_and_grads(cfg, params, local, tp,
                                             cfg.microbatch, mesh)
        _mean_grads(grads, split, d_ranks, d_group)
        norm = (global_norm(grads, fsdp.group, split)
                if fsdp and tcfg.grad_clip is not None else None)
        _, new_opt = opt.step(params, grads, opt_state,
                              sched(state["step"][0]), norm=norm)
        del grads
        state["opt"]["count"][0] = new_opt["count"]
        loss, parts = _sync_metrics(loss, parts, d_ranks, d_group)
        step = state["step"] + 1
        counts = state["counts"] + 1.0
        synced = int(step[0]) % tcfg.fedat_sync_every == 0
        sent = 0
        if synced:
            sent = mix(state["params"],
                       aggregation.cross_tier_weights(counts).to(dev))
        loss, parts = _sync_metrics(loss, parts, n_pods, pod_group)
        metrics = {"loss": loss, **parts, "synced": float(synced),
                   "payload_bytes": float(sent)}
        return ({"params": state["params"], "opt": state["opt"],
                 "step": step, "counts": counts}, metrics)

    return StepFns(train_step, init_state, state_sh, batch_sh)


def split_batch_for_pods(batch, n_pods: int):
    """(B, ...) -> (n_pods, B/n_pods, ...) on every leaf (numpy arrays or
    tensors, ``meta`` ones included)."""
    def split(x):
        return x.reshape((n_pods, x.shape[0] // n_pods) + tuple(x.shape[1:]))
    return {k: split(v) for k, v in batch.items()}


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
