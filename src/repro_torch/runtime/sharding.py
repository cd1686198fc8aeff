"""Logical-axis sharding layer (MaxText-style): layouts, and FSDP over
``data``.

The port of ``repro/runtime/sharding.py``.  Model code annotates
parameters with *logical* axis names; a rule table maps them to physical
mesh axes.  The reference hands the resolved ``PartitionSpec`` to GSPMD;
the port runs one device a rank, so a resolved spec here is a *layout*: a
tuple with one entry per dimension (None, an axis name, or a tuple of
names), the reference's ``PartitionSpec`` as a tuple.  The dry-run
(launch/dryrun.py) divides shapes by it to count a device's bytes.

What a layout splits over ``data`` (the reference's ``"fsdp": "data"``)
is held split: :func:`local_shard` cuts a whole tensor to this rank's
block, as the reference's ``addressable_shards`` hold it, and the
trainer (core/steps.py) keeps its params and AdamW moments so, each rank
1/D of every leaf with an ``fsdp`` dimension (ZeRO-3).  :class:`FSDP`
holds the data group and its two collectives, each over one flat buffer
for a group of leaves: the all-gather that makes a layer's shards whole
(:func:`gather`, an autograd function) and, in its backward, the
reduce-scatter that sums their gradients over the ranks.  Activations
stay the identity under :func:`shard`: a rank's batch rows are already
its own.  The other places where the reference's program needs values to
cross ranks are explicit collectives too: the client-sharded round's sum
over ``data`` (core/executor.py) and the multi-pod step's exchange over
``pod`` (core/steps.py).

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
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

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
    """The reference's sharding constraint by logical axes, on an
    activation: a rank's rows are already its own, so ``x`` unchanged
    (parameters are held split by the trainer: :func:`local_shard`)."""
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
    on ``mesh``: each sharded dimension split into equal shards (rounded
    up, as GSPMD pads an uneven split of a temporary).  A state leaf is
    never split unevenly: jax refuses such an array sharding and
    :func:`local_shard` raises as it does, so for a trainer's params and
    moments this is exactly what each rank holds."""
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


# ---------------------------------------------------------------------------
# FSDP (ZeRO-3) over ``data``
# ---------------------------------------------------------------------------

def split_dim(spec: Optional[Spec], axis: str = "data") -> Optional[int]:
    """The dimension a resolved layout splits over mesh ``axis`` alone
    (None when it splits none: a leaf kept whole on each of its ranks)."""
    for i, ax in enumerate(spec or ()):
        if ax == axis:
            return i
    return None


def local_shard(x: torch.Tensor, spec: Optional[Spec], mesh
                ) -> torch.Tensor:
    """This rank's block of the whole tensor ``x`` laid out by ``spec`` on
    ``mesh``, as the reference's ``addressable_shards`` hold it: each
    dimension split into equal blocks over the mesh axes its entry names
    (row-major over a tuple), this rank's coordinates picking the block.
    A fresh contiguous tensor when anything is cut, ``x`` itself when the
    layout splits nothing on this mesh.  A split that does not divide the
    dimension raises a ValueError, as jax refuses such an array
    sharding."""
    cut = False
    for dim, ax in enumerate(spec or ()):
        if ax is None:
            continue
        names = ax if isinstance(ax, tuple) else (ax,)
        k = math.prod(mesh.shape[a] for a in names)
        if k == 1:
            continue
        if x.shape[dim] % k:
            raise ValueError(
                f"layout {spec} splits dimension {dim} of a "
                f"{tuple(x.shape)} leaf {k} ways over {names}, which does "
                f"not divide {x.shape[dim]}; the reference refuses an "
                f"uneven sharding of an array too")
        idx = 0
        for a in names:
            idx = idx * mesh.shape[a] + mesh.coord(a)
        n = x.shape[dim] // k
        x = x.narrow(dim, idx * n, n)
        cut = True
    return x.clone() if cut else x


def shard_tree(tree, specs, mesh):
    """:func:`local_shard` over a tree of dicts and its same-structure
    tree of layouts (a leaf with layout None kept as it is)."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    return local_shard(tree, specs, mesh)


#: one FSDP a mesh (``FSDP.over``), so its counters see every gather
_FSDP: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


class FSDP:
    """ZeRO-3 over the ``data`` ranks of a runnable mesh: this rank's
    index, the group, and the two collectives of a sharded train step,
    each over one flat buffer for a group of leaves (one layer's, say)
    rather than one collective a leaf.

    The collectives follow the mesh's backend (launch/mesh.py
    ``default_backend``): under ``nccl`` ``all_gather_into_tensor`` and
    ``reduce_scatter_tensor``; under ``gloo`` (the CPU, ranks sharing one
    card), which takes CUDA tensors in ``broadcast`` and ``all_reduce``
    only, the all-gather is D broadcasts into a (D, n) buffer and the
    reduce-scatter an ``all_reduce`` of it and this rank's row.

    ``stats`` counts the collectives and their bytes (a rank's buffer);
    ``peak_live_bytes`` is the most bytes of gathered leaves alive at
    once, seen at each gather."""

    def __init__(self, mesh):
        mesh.require_runnable("a sharded train step")
        self.mesh = mesh
        self.group, self.ranks = mesh.group("data")
        self.size = len(self.ranks)
        self.index = mesh.coord("data")
        self.nccl = mesh.backend == "nccl"
        self.reset_stats()

    @classmethod
    def over(cls, mesh) -> Optional["FSDP"]:
        """The FSDP of ``mesh``'s data axis, one a mesh; None without a
        mesh or with one data rank (a step then holds every leaf
        whole)."""
        if mesh is None or mesh.shape.get("data", 1) == 1:
            return None
        if mesh not in _FSDP:
            _FSDP[mesh] = cls(mesh)
        return _FSDP[mesh]

    def reset_stats(self) -> None:
        self.stats = {"gathers": 0, "reduce_scatters": 0,
                      "gather_bytes": 0, "reduce_scatter_bytes": 0}
        self.peak_live_bytes = 0
        self._live: List[Tuple[Any, int]] = []

    def wrap(self, tree, specs):
        """``tree`` (this rank's shards) with each leaf its layout splits
        over ``data`` wrapped as a :class:`Sharded`, the others as they
        are."""
        if isinstance(tree, dict):
            return {k: self.wrap(v, specs[k]) for k, v in tree.items()}
        dim = split_dim(specs)
        return tree if dim is None else Sharded(tree, dim, self)

    # -- the collectives ---------------------------------------------------
    def all_gather(self, shards: Sequence[torch.Tensor],
                   dims: Sequence[int]) -> List[torch.Tensor]:
        """Whole leaves from every rank's shards, leaf j split along
        ``dims[j]``: one collective for the group."""
        D = self.size
        dtype = shards[0].dtype
        if any(s.dtype != dtype for s in shards):
            raise ValueError("an FSDP gather takes leaves of one dtype, got "
                             f"{sorted({str(s.dtype) for s in shards})}")
        flat = torch.cat([s.reshape(-1) for s in shards])
        buf = torch.empty((D, flat.numel()), dtype=dtype, device=flat.device)
        if self.nccl:
            dist.all_gather_into_tensor(buf.view(-1), flat, group=self.group)
        else:
            for p, src in enumerate(self.ranks):
                if p == self.index:
                    buf[p].copy_(flat)
                dist.broadcast(buf[p], src=src, group=self.group)
        del flat
        out, off = [], 0
        for s, d in zip(shards, dims):
            n = s.numel()
            shape = list(s.shape)
            shape[d] *= D
            blocks = buf[:, off:off + n].reshape((D,) + tuple(s.shape))
            out.append(blocks.movedim(0, d).reshape(shape))
            off += n
        self.stats["gathers"] += 1
        self.stats["gather_bytes"] += buf.numel() * buf.element_size()
        return out

    def reduce_scatter(self, grads: Sequence[torch.Tensor],
                       dims: Sequence[int],
                       like: Sequence[Tuple[torch.Size, torch.dtype]]
                       ) -> List[torch.Tensor]:
        """This rank's shards of the whole gradients ``grads`` summed over
        the ranks (in fp32), each in the (shape, dtype) of its entry of
        ``like``: one collective for the group."""
        D = self.size
        parts = []
        for g, d in zip(grads, dims):
            shape = tuple(g.shape)
            g = g.to(torch.float32).reshape(
                shape[:d] + (D, shape[d] // D) + shape[d + 1:])
            parts.append(g.movedim(d, 0).reshape(D, -1))
        buf = torch.cat(parts, dim=1)
        del parts
        if self.nccl:
            row = torch.empty(buf.shape[1], dtype=buf.dtype,
                              device=buf.device)
            dist.reduce_scatter_tensor(row, buf.view(-1), group=self.group)
        else:
            dist.all_reduce(buf, group=self.group)
            row = buf[self.index].clone()
        self.stats["reduce_scatters"] += 1
        self.stats["reduce_scatter_bytes"] += buf.numel() * buf.element_size()
        del buf
        out, off = [], 0
        for shape, dtype in like:
            n = math.prod(shape)
            out.append(row[off:off + n].view(shape).to(dtype))
            off += n
        return out

    def _note_live(self, tensors: Sequence[torch.Tensor]) -> None:
        self._live = [(r, n) for r, n in self._live if r() is not None]
        self._live += [(weakref.ref(t), t.numel() * t.element_size())
                       for t in tensors]
        self.peak_live_bytes = max(self.peak_live_bytes,
                                   sum(n for _, n in self._live))

    def gather_tree(self, tree, specs, keep=None):
        """``tree`` (this rank's shards, laid out by ``specs``) with every
        leaf whole, gathered leaf by leaf (a collective each, so no rank
        holds more than one whole leaf beyond what ``keep`` keeps), in
        the sorted-key order of the tree; ``keep`` maps each whole leaf
        as soon as it is gathered (to the host, say)."""
        keep = keep or (lambda t: t)
        if isinstance(tree, dict):
            return {k: self.gather_tree(tree[k], specs[k], keep)
                    for k in sorted(tree)}
        dim = split_dim(specs)
        return keep(tree if dim is None else
                    self.all_gather([tree.detach()], [dim])[0])


class _Gather(torch.autograd.Function):
    """Forward: the all-gather of a group of shards into whole leaves.
    Backward: the reduce-scatter of their gradients (an unused output's
    gradient a zero, so every rank issues the same collectives).  It
    keeps no tensor, only the layout, so a checkpointed block's recompute
    gathers again."""

    @staticmethod
    def forward(ctx, fsdp: FSDP, dims: Tuple[int, ...], *shards):
        ctx.fsdp, ctx.dims = fsdp, dims
        ctx.like = [(s.shape, s.dtype) for s in shards]
        return tuple(fsdp.all_gather(shards, dims))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(ctx.fsdp.reduce_scatter(
            grads, ctx.dims, ctx.like))


class Sharded:
    """A leaf as this rank's shard, split along ``dim`` over ``fsdp``'s
    data ranks: what the model code meets in a sharded train step
    (``lm.anchor_params``), made whole by :func:`gather`.  Indexing takes
    entry ``i`` of a stacked leaf's leading dim, so ``index_tree`` (the
    layer loops' ``take``) gives one layer's shards."""

    __slots__ = ("shard", "dim", "fsdp")

    def __init__(self, shard: torch.Tensor, dim: int, fsdp: FSDP):
        self.shard, self.dim, self.fsdp = shard, dim, fsdp

    def __getitem__(self, i):
        if self.dim == 0:
            raise ValueError("a Sharded leaf is indexed along its split "
                             "dimension")
        return Sharded(self.shard[i], self.dim - 1, self.fsdp)


def _collect(tree, found: List["Sharded"]) -> None:
    if isinstance(tree, Sharded):
        found.append(tree)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _collect(tree[k], found)


def _rebuild(tree, whole):
    if isinstance(tree, Sharded):
        return next(whole)
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], whole) for k in sorted(tree)}
    return tree


def gather(tree):
    """``tree`` (a tensor, a :class:`Sharded` or nested dicts of them) with
    every :class:`Sharded` leaf whole: one all-gather over the data ranks
    for all of them, whose backward reduce-scatters their gradients
    summed over the ranks.  Without a :class:`Sharded` leaf (no mesh, one
    data rank, serving) ``tree`` itself, and no collective."""
    found: List[Sharded] = []
    _collect(tree, found)
    if not found:
        return tree
    fsdp = found[0].fsdp
    whole = _Gather.apply(fsdp, tuple(s.dim for s in found),
                          *(s.shard for s in found))
    fsdp._note_live(whole)
    # module-level helpers, not closures: a recursive closure is a
    # reference cycle that would keep the whole leaves alive until the
    # collector runs
    return _rebuild(tree, iter(whole))
