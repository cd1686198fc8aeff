"""Device meshes over the ranks of a ``torch.distributed`` process group,
and the named-mesh registry.

The port of ``repro/launch/mesh.py``.  A mesh is a set of named axes
(``pod``/``data``/``model``, see :mod:`repro_torch.runtime.sharding`)
laid row-major over the ranks of the default process group, one device a
rank; the world size plays the part of the reference's device count.
Every rank runs the same host program, and the device work meets at the
collectives the steps call over an axis's group (:meth:`Mesh.group`).

* :func:`make_host_mesh` — a mesh over however many ranks were launched
  (``python -m torch.distributed.run --nproc-per-node N ...``): one rank
  without a process group, so a plain run is ``(data=1, model=1)``.
* :func:`make_production_mesh` — the datacenter shapes ``(data=16,
  model=16)`` and ``(pod=2, data=16, model=16)`` as shapes only: the
  dry-run (launch/dryrun.py) reads them, no step runs on them.

The collective backend is an explicit argument (:func:`default_backend`
states the rule the launchers use: ``nccl`` for ranks on distinct cards,
``gloo`` on the CPU and for ranks that share one card); it is never
chosen by catching a failure.  A mesh of more than one rank without an
initialised process group raises.

The string grammar of :func:`resolve_mesh` / :func:`parse_mesh_name` is
what :class:`~repro_torch.api.spec.MeshSpec` serializes to — ``None``
(single device, no mesh), ``"host"``, ``"host:<n_pods>"``,
``"production"``, ``"production:2"``.
"""
from __future__ import annotations

import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

#: the environment variable that carries ``init_process_group``'s
#: ``init_method`` (default ``env://``: MASTER_ADDR/MASTER_PORT, as
#: torch.distributed.run sets them)
INIT_ENV = "REPRO_TORCH_DIST_INIT"


# ---------------------------------------------------------------------------
# the process group
# ---------------------------------------------------------------------------

def world_size() -> int:
    """Ranks of the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_writer() -> bool:
    """True on the rank that writes files (snapshots, checkpoints,
    reports): rank 0, or the only process."""
    return rank() == 0


def default_backend(device: torch.device, local_ranks: int) -> str:
    """``gloo`` on the CPU and when the host's ranks outnumber its cards
    (they then share one), ``nccl`` when each rank has a card of its
    own."""
    if device.type != "cuda" or torch.cuda.device_count() < local_ranks:
        return "gloo"
    return "nccl"


def init_from_env(device: torch.device,
                  backend: Optional[str] = None) -> torch.device:
    """Join the process group the launcher described in the environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``; the
    address in :data:`INIT_ENV` or ``MASTER_ADDR``/``MASTER_PORT``) when
    ``WORLD_SIZE`` > 1, and return this rank's device: ``cuda:LOCAL_RANK``
    under nccl, ``device`` itself otherwise.  A no-op for one rank."""
    n = int(os.environ.get("WORLD_SIZE", "1"))
    if n <= 1:
        return device
    local = int(os.environ.get("LOCAL_RANK", "0"))
    backend = backend or default_backend(
        device, int(os.environ.get("LOCAL_WORLD_SIZE", str(n))))
    if backend == "nccl":
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=os.environ.get(INIT_ENV, "env://"),
            rank=int(os.environ["RANK"]), world_size=n)
    return device


def shutdown() -> None:
    """Leave the process group (if any) and forget its meshes."""
    _MESHES.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def run_ranks(argv: Sequence[str], world: int, *, timeout: float,
              env: Optional[Dict[str, str]] = None,
              store_dir: Optional[str] = None) -> List[Tuple[int, str, str]]:
    """Start ``world`` processes of ``python argv...`` as the ranks of one
    process group (a ``file://`` store in a fresh directory, so parallel
    launches never share an address) and wait for all of them; returns
    each rank's (exit code, stdout, stderr).  Past ``timeout`` seconds
    every rank still running is killed, and its code is -9."""
    store_dir = store_dir or tempfile.mkdtemp(prefix="repro_torch_ranks_")
    store = os.path.join(store_dir, "store")
    base = dict(os.environ, **(env or {}))
    base.update({"WORLD_SIZE": str(world), "LOCAL_WORLD_SIZE": str(world),
                 INIT_ENV: f"file://{store}"})
    procs = []
    for r in range(world):
        procs.append(subprocess.Popen(
            [sys.executable, *argv], env=dict(base, RANK=str(r),
                                              LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    deadline = time.monotonic() + timeout
    out = []
    try:
        for p in procs:
            try:
                o, e = p.communicate(
                    timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                o, e = p.communicate()
                e = f"{e}\nkilled after {timeout} s"
            out.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

class Mesh:
    """Named axes over the ranks of the default process group, row-major
    (the last axis fastest): ``shape`` maps each axis name to its size.

    A runnable mesh (``runnable=True``) spans exactly the world and holds
    this rank's coordinates and, for each axis of size > 1, the group of
    the ranks that differ from this one on that axis only.  A shape-only
    mesh (the production shapes) has neither; :meth:`require_runnable`
    raises on it."""

    def __init__(self, shape: Tuple[int, ...], axes: Tuple[str, ...], *,
                 backend: Optional[str] = None, runnable: bool = True):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} differ "
                             f"in length")
        self.shape: Dict[str, int] = dict(zip(axes, (int(s) for s in shape)))
        self.axis_names = tuple(axes)
        self.size = math.prod(self.shape.values())
        self.runnable = runnable
        self.backend = backend
        self._groups: Dict[str, Tuple[object, List[int]]] = {}
        self.rank = 0
        self.coords: Dict[str, int] = dict.fromkeys(axes, 0)
        if not runnable:
            return
        n = world_size()
        if self.size != n:
            hint = ("" if dist.is_initialized() else
                    "; no process group is initialised, so this process is "
                    "one rank: launch the ranks with python -m "
                    "torch.distributed.run --nproc-per-node N")
            raise ValueError(f"mesh {self.shape} needs {self.size} ranks, "
                             f"but the world has {n}{hint}")
        if self.shape.get("model", 1) > 1:
            raise ValueError(
                f"mesh {self.shape}: a model axis > 1 (tensor parallelism "
                f"across ranks) is not run; the reference's runnable meshes "
                f"have model=1, and a model axis appears only in the "
                f"dry-run's production meshes (launch/dryrun.py)")
        self.rank = rank()
        self.coords = self._unravel(self.rank)
        if self.size > 1:
            self.backend = backend or dist.get_backend()
            for ax in self.axis_names:
                if self.shape[ax] > 1:
                    self._make_groups(ax)

    def _unravel(self, r: int) -> Dict[str, int]:
        out = {}
        for ax in reversed(self.axis_names):
            out[ax] = r % self.shape[ax]
            r //= self.shape[ax]
        return {ax: out[ax] for ax in self.axis_names}

    def _ravel(self, coords: Dict[str, int]) -> int:
        r = 0
        for ax in self.axis_names:
            r = r * self.shape[ax] + coords[ax]
        return r

    def _make_groups(self, axis: str) -> None:
        """Every rank creates every group of ``axis`` in the same order
        (``new_group`` is collective over the world)."""
        others = [a for a in self.axis_names if a != axis]
        lines = {}
        for r in range(self.size):
            c = self._unravel(r)
            lines.setdefault(tuple(c[a] for a in others), []).append(r)
        for key in sorted(lines):
            ranks = lines[key]
            if len(ranks) == self.size and \
                    self.backend == dist.get_backend():
                group = dist.group.WORLD
            else:
                group = dist.new_group(ranks, backend=self.backend)
            if self.rank in ranks:
                self._groups[axis] = (group, ranks)

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 if the mesh lacks it)."""
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        """(process group, global ranks in axis order) of this rank's line
        along ``axis``; only for an axis of size > 1."""
        self.require_runnable(f"a collective over {axis!r}")
        return self._groups[axis]

    def require_runnable(self, what: str) -> None:
        if not self.runnable:
            raise ValueError(
                f"the {self.shape} mesh is shape-only (the dry-run reads "
                f"its shardings); it cannot run {what}: launch N ranks "
                f"and use a 'host' mesh")

    def __repr__(self) -> str:
        kind = "" if self.runnable else ", shape-only"
        return f"Mesh({self.shape}{kind})"


_MESHES: Dict[tuple, Mesh] = {}


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              backend: Optional[str] = None) -> Mesh:
    """A runnable mesh over the world (cached per shape, axes, backend and
    process group: its groups are made once)."""
    pg = id(dist.group.WORLD) if dist.is_initialized() else None
    key = (tuple(shape), tuple(axes), backend, pg)
    if key not in _MESHES:
        _MESHES[key] = Mesh(tuple(shape), tuple(axes), backend=backend)
    return _MESHES[key]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The 256/512-device datacenter mesh, shape only.

    ``multi_pod=False``: one pod, ``(data=16, model=16)``.
    ``multi_pod=True``: two pods, ``(pod=2, data=16, model=16)``; the
    ``pod`` axis is the FedAT tier axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, runnable=False)


def make_host_mesh(n_pods: int = 1, backend: Optional[str] = None) -> Mesh:
    """A mesh over however many ranks were launched.

    With ``n_pods == 1`` (or a world not divisible by ``n_pods``) the
    shape is ``(data=world, model=1)``; otherwise ``(pod=n_pods,
    data=world/n_pods, model=1)``.  The indivisible fallback is for direct
    callers (``launch/train.py --multi-pod`` on one rank); the declarative
    path (:func:`resolve_mesh`) rejects it instead."""
    n = world_size()
    if n_pods > 1 and n % n_pods == 0:
        return make_mesh((n_pods, n // n_pods, 1), ("pod", "data", "model"),
                         backend)
    return make_mesh((n, 1), ("data", "model"), backend)


# ---------------------------------------------------------------------------
# named meshes (the MeshSpec grammar)
# ---------------------------------------------------------------------------

MESH_KINDS = ("single", "host", "production")

#: data-axis sizes known without building the mesh (None = depends on the
#: runtime world size); MeshSpec uses this for static pad validation.
STATIC_DATA_AXIS = {"single": 1, "production": 16}


def parse_mesh_name(name: Optional[str]) -> Tuple[str, int]:
    """``None``/``"single"`` -> ("single", 1); ``"host[:p]"`` /
    ``"production[:p]"`` -> (kind, n_pods).  Raises ValueError with the
    accepted grammar on anything else."""
    if name is None or name == "single":
        return "single", 1
    kind, _, arg = str(name).partition(":")
    if kind not in ("host", "production"):
        raise ValueError(
            f"unknown mesh {name!r}; expected one of {MESH_KINDS} "
            f"(optionally 'host:<n_pods>' / 'production:2')")
    try:
        n_pods = int(arg) if arg else 1
    except ValueError:
        raise ValueError(f"bad n_pods in mesh name {name!r} "
                         f"(expected e.g. 'host:2')")
    if n_pods < 1:
        raise ValueError(f"mesh n_pods must be >= 1, got {n_pods}")
    if kind == "production" and n_pods > 2:
        raise ValueError(
            f"production mesh has 1 or 2 pods, got n_pods={n_pods}")
    return kind, n_pods


def resolve_mesh(name: Optional[str]) -> Optional[Mesh]:
    """Materialize a named mesh (``None`` for the single-device
    default).  This may create process groups, so callers (``SimEnv``)
    resolve at environment build time, never at import time."""
    kind, n_pods = parse_mesh_name(name)
    if kind == "single":
        return None
    if kind == "host":
        n = world_size()
        if n_pods > 1 and n % n_pods:
            raise ValueError(
                f"mesh {name!r} needs a world size divisible by "
                f"n_pods={n_pods}, but {n} rank(s) were launched; launch a "
                f"multiple of {n_pods} with python -m torch.distributed.run "
                f"--nproc-per-node N")
        return make_host_mesh(n_pods)
    return make_production_mesh(multi_pod=n_pods > 1)
