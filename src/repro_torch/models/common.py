"""Shared model building blocks: param specs, init, norms, RoPE, SwiGLU.

The port of ``repro/models/common.py``.  Parameters are plain nested dicts
of tensors with the reference's keys, shapes and layouts (``(in, out)``
dense weights, layers stacked on a leading axis).  Every model module
declares a same-structure tree of :class:`PSpec`; :func:`init_from_specs`
materializes it directly on the target device, :func:`shapes_from_specs`
on the ``meta`` device (shapes only), and :func:`shardings_from_specs`
resolves its logical axes to layouts on a mesh.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class PSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | small
    scale: Optional[float] = None  # override fan-in scaling


def is_pspec(x) -> bool:
    return isinstance(x, PSpec)


def iter_specs(specs: Dict[str, Any], prefix: Tuple[str, ...] = ()
               ) -> Iterator[Tuple[Tuple[str, ...], PSpec]]:
    """(path, spec) for every leaf, in sorted-key order (the order jax's
    tree flattening gives a dict)."""
    for k in sorted(specs):
        v = specs[k]
        if is_pspec(v):
            yield prefix + (k,), v
        else:
            yield from iter_specs(v, prefix + (k,))


def init_std(spec: PSpec) -> float:
    """The reference's init scale: 1/sqrt(fan_in) (fan_in = shape[-2] for
    matrices), ``scale`` when given, 0.02 for ``small``."""
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else max(spec.shape[-1], 1)
    std = spec.scale if spec.scale is not None else 1.0 / math.sqrt(fan_in)
    return 0.02 if spec.init == "small" else std


def init_from_specs(specs: Dict[str, Any], generator: torch.Generator,
                    device: DeviceLike = None, dtype=torch.float32,
                    mesh=None):
    """Materialize a param tree from a spec tree on ``device``.

    Each leaf is drawn in place where it will live (``normal_`` on the
    device, from ``generator``, which must be a generator of that device),
    so a model of tens of GiB is never staged on the host nor held twice.
    With a ``mesh``, each leaf is cut to this rank's block of its layout
    as soon as it is drawn (runtime/sharding.py ``local_shard``; the
    draws are the same on every rank, in the same order), so a rank holds
    its shards and at most one whole leaf at a time.  The draws come from
    another generator than the reference's ``jax.random`` keys, so values
    differ; tests convert the reference's params instead
    (models/convert.py).
    """
    from repro_torch.runtime import sharding as shd
    dev = resolve_device(device)
    out: Dict[str, Any] = {}
    for path, spec in iter_specs(specs):
        if spec.init == "zeros":
            t = torch.zeros(spec.shape, dtype=dtype, device=dev)
        elif spec.init == "ones":
            t = torch.ones(spec.shape, dtype=dtype, device=dev)
        else:
            t = torch.empty(spec.shape, dtype=torch.float32, device=dev)
            t.normal_(0.0, init_std(spec), generator=generator)
            if dtype != torch.float32:
                t = t.to(dtype)
        if mesh is not None:
            t = shd.local_shard(t, shd.logical_sharding(spec.axes, mesh),
                                mesh)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


def _map_specs(fn, specs):
    if is_pspec(specs):
        return fn(specs)
    return {k: _map_specs(fn, v) for k, v in specs.items()}


def axes_from_specs(specs):
    """The spec tree's logical axes, one tuple a leaf."""
    return _map_specs(lambda s: s.axes, specs)


def shapes_from_specs(specs, dtype=torch.float32):
    """The spec tree as tensors on the ``meta`` device: shapes and dtypes,
    no storage (the reference's ``ShapeDtypeStruct`` stand-ins)."""
    return _map_specs(lambda s: torch.empty(s.shape, dtype=dtype,
                                            device="meta"), specs)


def shardings_from_specs(specs, mesh=None):
    """Each leaf's resolved layout under ``mesh`` (runtime/sharding.py;
    None without a mesh)."""
    from repro_torch.runtime import sharding as shd
    return _map_specs(lambda s: shd.logical_sharding(s.axes, mesh), specs)


def param_bytes(specs: Dict[str, Any], bytes_per_el: int = 2) -> int:
    """Bytes of a spec tree's params at ``bytes_per_el`` bytes each."""
    return sum(math.prod(s.shape) for _, s in iter_specs(specs)) * \
        bytes_per_el


def flatten_tree(tree: Dict[str, Any], sep: str = "/",
                 prefix: str = "") -> Dict[str, Any]:
    """Nested dicts -> one flat dict keyed by the paths joined with
    ``sep``.  ``/`` sorts below every character of a key, so the flat
    keys' sorted order is the nested tree's sorted-key order (the order
    jax flattens it in)."""
    out: Dict[str, Any] = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flatten_tree(v, sep, f"{prefix}{k}{sep}"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def unflatten_tree(flat: Dict[str, Any], sep: str = "/") -> Dict[str, Any]:
    """Inverse of :func:`flatten_tree`."""
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split(sep)
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def index_tree(tree, i: int):
    """Entry ``i`` of every leaf of a stacked tree of dicts and NamedTuples
    (views, no copies: writing a leaf writes the stacked tensor)."""
    if isinstance(tree, dict):
        return {k: index_tree(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(index_tree(t, i) for t in tree))
    return tree[i]


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    """fp32 inside, cast back to ``x``'s dtype (common.py:76-80)."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * gamma.float()).to(dt)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    expo = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), expo)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S).

    Rotate-half (the two halves of the head dim are the pair), angles in
    fp32, as the reference does."""
    dt = x.dtype
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # (hd/2,)
    ang = positions[..., None].float() * freqs                # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_in: torch.Tensor,
           w_out: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """act(x @ w_gate) * (x @ w_in) @ w_out.  ``act="gelu"`` (the vlm
    family's FFN) is the tanh approximation, ``jax.nn.gelu``'s default,
    which the reference uses; the erf form differs by about 1e-3."""
    g = torch.matmul(x, w_gate)
    h = torch.matmul(x, w_in)
    g = F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")
    return torch.matmul(g * h, w_out)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          vocab_size: Optional[int] = None) -> torch.Tensor:
    """Mean CE over masked positions; padded vocab entries (past
    ``vocab_size``) are excluded by a large-negative bias.

    logits: (..., V_padded); labels int (...,)."""
    logits = logits.float()
    if vocab_size is not None and vocab_size < logits.shape[-1]:
        bias = torch.zeros(logits.shape[-1], dtype=torch.float32,
                           device=logits.device)
        bias[vocab_size:] = -1e9
        logits = logits + bias
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()
