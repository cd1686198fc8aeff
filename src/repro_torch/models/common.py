"""Shared model building blocks: param specs, init, norms, RoPE, SwiGLU.

The port of ``repro/models/common.py``.  Parameters are plain nested dicts
of tensors with the reference's keys, shapes and layouts (``(in, out)``
dense weights, layers stacked on a leading axis).  Every model module
declares a same-structure tree of :class:`PSpec`; :func:`init_from_specs`
materializes it directly on the target device.
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
                    device: DeviceLike = None, dtype=torch.float32):
    """Materialize a param tree from a spec tree on ``device``.

    Each leaf is drawn in place where it will live (``normal_`` on the
    device, from ``generator``, which must be a generator of that device),
    so a model of tens of GiB is never staged on the host nor held twice.
    The draws come from another generator than the reference's
    ``jax.random`` keys, so values differ; tests convert the reference's
    params instead (models/convert.py).
    """
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
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


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
           w_out: torch.Tensor) -> torch.Tensor:
    """silu(x @ w_gate) * (x @ w_in) @ w_out (the reference's gelu variant
    belongs to the vlm family, not ported yet)."""
    g = torch.matmul(x, w_gate)
    h = torch.matmul(x, w_in)
    return torch.matmul(F.silu(g) * h, w_out)
