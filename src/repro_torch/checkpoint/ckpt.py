"""Checkpointing: atomic, versioned, async, integrity-checked, keep-last-k.

The port of ``repro/checkpoint/ckpt.py``, with its on-disk layout:

    <dir>/step_<N:010d>/shard_0.npz + manifest.json

  * A state is a tree of nested dicts whose leaves are tensors (or numpy
    arrays, or Python numbers).  Leaves are flattened in the reference's
    order (dict keys sorted, depth first) and named by their path in its
    ``keystr`` form (``['opt']['m']['embed']``); the npz holds them as
    ``a0 .. an``.  The same state written by either package therefore
    gives the same manifest ``paths``, ``shapes``, ``dtypes`` and
    ``hash``; ``treedef`` is each package's own token.
  * Writes go to ``step_<N>.tmp``, the payload and the manifest are
    fsync'd, then the tmp directory, then it is renamed into place and
    the parent directory fsync'd: a crash mid-save never corrupts the
    latest checkpoint.
  * ``save`` copies the state to the host on the calling thread, then a
    background thread writes it; ``wait()`` joins, and a failed write
    raises from the next ``save()`` or ``wait()``.
  * ``restore`` verifies the content hash and falls back to the previous
    checkpoint on corruption; each leaf lands on the device and in the
    dtype of the matching leaf of ``like``.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_flatten(tree[k], f"{prefix}[{k!r}]"))
        return out
    return [(prefix, tree)]


def _unflatten(like, leaves: List[Any]):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)
    return build(like)


def _treedef_token(tree) -> str:
    """The tree's structure: nested keys, ``*`` for each leaf."""
    def shape(node):
        if isinstance(node, dict):
            return {k: shape(node[k]) for k in sorted(node)}
        return "*"
    return json.dumps(shape(tree), sort_keys=True)


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _digest(leaves) -> str:
    digest = hashlib.sha256()
    for leaf in leaves:
        digest.update(np.ascontiguousarray(leaf).tobytes())
    return digest.hexdigest()


#: the spec-provenance sidecar written next to param / engine-state
#: checkpoints; binds the directory's contents to exactly one spec hash
SIDECAR = "spec.json"


def write_sidecar(directory: str, payload: Dict[str, Any]) -> str:
    """Atomically write the spec sidecar (tmp + rename, like the
    checkpoint itself); returns the sidecar path."""
    sidecar = os.path.join(directory, SIDECAR)
    tmp = sidecar + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2)
    os.replace(tmp, sidecar)
    return sidecar


def read_sidecar(directory: str) -> Dict[str, Any]:
    """The sidecar document, or FileNotFoundError when the directory was
    never checkpointed into."""
    sidecar = os.path.join(directory, SIDECAR)
    if not os.path.exists(sidecar):
        raise FileNotFoundError(
            f"no {SIDECAR} in checkpoint dir {directory!r}")
    with open(sidecar) as f:
        return json.load(f)


def _fsync_path(path: str) -> None:
    """fsync a file or directory by path (a directory's fsync commits the
    rename itself)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 process_index: int = 0):
        self.dir = directory
        self.keep = keep
        self.pidx = process_index
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def save(self, step: int, state: Any, blocking: bool = False) -> None:
        """Snapshot to the host, then write (in the background unless
        ``blocking``).  Joins any in-flight write first, so an error of
        the previous save surfaces here."""
        self.wait()
        flat = [(p, _to_host(leaf)) for p, leaf in _flatten(state)]
        token = _treedef_token(state)

        def work():
            try:
                self._write(step, flat, token)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        if blocking:
            work()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def _write(self, step: int, flat, token: str) -> None:
        final = os.path.join(self.dir, f"step_{step:010d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        shard = os.path.join(tmp, f"shard_{self.pidx}.npz")
        np.savez(shard, **{f"a{i}": leaf for i, (_, leaf) in enumerate(flat)})
        manifest = {
            "step": step,
            "paths": [p for p, _ in flat],
            "shapes": [list(np.shape(leaf)) for _, leaf in flat],
            "dtypes": [str(leaf.dtype) for _, leaf in flat],
            "treedef": token,
            "hash": _digest(leaf for _, leaf in flat),
            "n_processes": 1,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            f.write(json.dumps(manifest))
            f.flush()
            os.fsync(f.fileno())
        # durability: payload -> tmp dir entries -> rename -> parent dir
        _fsync_path(shard)
        _fsync_path(tmp)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync_path(self.dir)
        self._gc(current=step)

    def _gc(self, current: Optional[int] = None) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            if s == current:
                continue  # never collect the step this writer just renamed
            path = os.path.join(self.dir, f"step_{s:010d}")
            if os.path.exists(path + ".tmp"):
                continue  # another writer is mid-flight on this step
            shutil.rmtree(path, ignore_errors=True)

    def _raise_if_failed(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    # ------------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None
                ) -> Tuple[Any, int]:
        """Restore into the structure of ``like``; verifies integrity and
        falls back to older checkpoints on corruption."""
        self.wait()
        candidates = [step] if step is not None else self.all_steps()[::-1]
        for s in candidates:
            try:
                return self._load(like, s), s
            except Exception:
                continue
        raise FileNotFoundError(f"no restorable checkpoint in {self.dir}")

    def _load(self, like, step: int):
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        paths = [p for p, _ in _flatten(like)]
        if paths != manifest["paths"]:
            raise ValueError(f"checkpoint step {step} holds another tree")
        with np.load(os.path.join(path, f"shard_{self.pidx}.npz")) as data:
            leaves = [data[f"a{i}"] for i in range(len(paths))]
        if _digest(leaves) != manifest["hash"]:
            raise IOError(f"checkpoint step {step} failed integrity check")
        placed = []
        for (_, ref), leaf in zip(_flatten(like), leaves):
            if isinstance(ref, torch.Tensor):
                leaf = torch.from_numpy(leaf).to(ref.device, ref.dtype)
            placed.append(leaf)
        return _unflatten(like, placed)
