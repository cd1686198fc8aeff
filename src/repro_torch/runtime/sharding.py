"""Logical-axis sharding layer (MaxText-style), as layouts.

The port of ``repro/runtime/sharding.py``.  Model code annotates
parameters with *logical* axis names; a rule table maps them to physical
mesh axes.  The reference hands the resolved ``PartitionSpec`` to GSPMD;
the port runs one device a rank and keeps every tensor whole on each rank
(FSDP over ``data``, ``shard_tiers``, ``anchor_params``), so a resolved
spec here is a *layout*: a tuple with one entry per dimension (None, an
axis name, or a tuple of names), the reference's ``PartitionSpec`` as a
tuple.  The dry-run (launch/dryrun.py) divides shapes by it to count a
device's bytes, and :func:`shard` returns its input unchanged.  The two
places where the reference's program needs values to cross ranks are
explicit collectives: the client-sharded round's sum over ``data``
(core/executor.py) and the multi-pod step's exchange over ``pod``
(core/steps.py).

Physical mesh axes (see :mod:`repro_torch.launch.mesh`):
  * ``pod``   — FedAT tier axis (multi-pod mesh only)
  * ``data``  — intra-tier data parallelism + FSDP weight sharding,
                and the per-round *client* axis of the round step
  * ``model`` — tensor parallelism (heads / mlp / vocab / experts)
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

Axis = Union[str, Tuple[str, ...], None]
Spec = Tuple[Axis, ...]

# Logical-name -> physical mesh axis (or tuple of axes).
DEFAULT_RULES: Dict[str, Axis] = {
    # federated round execution (core/executor.py / core/simulation.py)
    "clients": "data",          # per-round client fan-out + resident stacks
    "tiers": "pod",             # tier-model stack leading dim (optional)
    # activations
    "batch": ("pod", "data"),   # global batch over pods (tiers) x data
    "seq": None,                # activation sequence dim: replicated
    "embed": None,              # activation d_model dim: replicated
    # parameters
    "fsdp": "data",             # ZeRO-3 weight dim (usually the in-feature dim)
    "tp": "model",              # tensor-parallel dim (heads*hd / d_ff / vocab)
    "experts": "model",         # expert parallelism (deepseek-style EP)
    "layers": None,             # stacked-layer leading dim
    "none": None,
    # caches
    "kv_seq": "model",          # seq-sharded KV cache (non-divisible kv heads)
    "kv_heads": "model",        # head-sharded KV cache
    "cache_batch": ("pod", "data"),
}

_local = threading.local()


def current_mesh():
    return getattr(_local, "mesh", None)


def current_rules() -> Dict[str, Axis]:
    return getattr(_local, "rules", DEFAULT_RULES)


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[Dict[str, Axis]] = None):
    """Install ``mesh`` (+ optional rule overrides) as the ambient mesh."""
    prev = (current_mesh(), current_rules())
    _local.mesh = mesh
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    _local.rules = merged
    try:
        yield
    finally:
        _local.mesh, _local.rules = prev


def _resolve(axes: Sequence[Optional[str]], mesh,
             rules: Dict[str, Axis]) -> Spec:
    """Logical axes -> one physical entry per dimension (the reference's
    ``PartitionSpec`` entries): axes the mesh lacks are dropped, a
    physical axis is used at most once, and a 1-tuple unwraps."""
    phys = []
    used: set = set()
    for name in axes:
        if name is None:
            phys.append(None)
            continue
        ax = rules.get(name)
        if ax is None:
            phys.append(None)
            continue
        if isinstance(ax, tuple):
            ax = tuple(a for a in ax if a in mesh.shape and a not in used)
            ax = ax[0] if len(ax) == 1 else (ax if ax else None)
        elif ax not in mesh.shape or ax in used:
            ax = None
        if ax is not None:
            used.update(ax if isinstance(ax, tuple) else (ax,))
        phys.append(ax)
    return tuple(phys)


def logical_sharding(axes: Sequence[Optional[str]],
                     mesh=None) -> Optional[Spec]:
    """The resolved spec of logical ``axes`` under the current (or given)
    mesh, None without a mesh."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return None
    return _resolve(axes, mesh, current_rules())


def shard(x, *axes: Optional[str]):
    """The reference's sharding constraint by logical axes: a layout,
    which a rank holding the whole tensor satisfies, so ``x`` unchanged."""
    return x


def tree_shardings(axes_tree, mesh=None):
    """Map a tree (nested dicts / tuples of named fields) of logical-axes
    tuples to resolved specs (or None without a mesh)."""
    mesh = mesh or current_mesh()

    def is_axes(t) -> bool:
        return isinstance(t, tuple) and not hasattr(t, "_fields") and all(
            a is None or isinstance(a, str) for a in t)

    def walk(t):
        if is_axes(t):
            return None if mesh is None else logical_sharding(t, mesh)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if hasattr(t, "_fields"):
            return type(t)(*(walk(v) for v in t))
        return type(t)(walk(v) for v in t)
    return walk(axes_tree)


def shard_factors(spec: Optional[Spec], mesh) -> Tuple[int, ...]:
    """Per-dimension number of shards of a resolved spec on ``mesh``."""
    def size(ax):
        if ax is None:
            return 1
        if isinstance(ax, tuple):
            return math.prod(mesh.shape[a] for a in ax)
        return mesh.shape[ax]
    return tuple(size(a) for a in (spec or ()))


def device_bytes(shape: Sequence[int], itemsize: int,
                 spec: Optional[Spec], mesh) -> int:
    """Bytes one device holds of a leaf of ``shape`` laid out by ``spec``
    on ``mesh``: each sharded dimension split into equal shards (the last
    one padded, as GSPMD pads an uneven split)."""
    f = shard_factors(spec, mesh) if spec is not None else ()
    f = f + (1,) * (len(shape) - len(f))
    return math.prod(-(-d // k) for d, k in zip(shape, f)) * itemsize


def mesh_axis_size(name: str) -> int:
    """Size of a physical mesh axis under the thread-local current mesh
    (1 if absent).  Mesh-carrying objects (``SimEnv``, ``RoundExecutor``)
    size axes from their own mesh instead."""
    mesh = current_mesh()
    if mesh is None or name not in mesh.shape:
        return 1
    return mesh.shape[name]


def tp_size() -> int:
    """Tensor-parallel degree implied by the current mesh ('model' axis)."""
    return mesh_axis_size("model")
