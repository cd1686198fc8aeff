"""Faithful Encoded Polyline Algorithm codec (FedAT §4.3).

The port of ``repro/compress/polyline.py``: numpy-vectorized Google
polyline encoding of flattened model weights — round to ``precision``
decimals, delta-encode, zig-zag, 5-bit chunks with a continuation bit,
ASCII ``chr(chunk + 63)``.  It is a host-side wire format; the link's
in-graph lossy step is the plain rounding in compress/transport.py.

A "tree" here is the port's params dict (leaves in sorted-key order, the
order ``jax.tree.leaves`` gives for a dict), a list/tuple of arrays, or a
single array; leaves may be tensors or numpy arrays.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch


def tree_flatten(tree: Any) -> Tuple[List[Any], Tuple]:
    """(leaves, treedef) for a dict (sorted keys), list/tuple, or leaf."""
    if isinstance(tree, Mapping):
        keys = sorted(tree)
        return [tree[k] for k in keys], ("dict", tuple(keys))
    if isinstance(tree, (list, tuple)):
        return list(tree), ("list", len(tree))
    return [tree], ("leaf",)


def tree_unflatten(treedef: Tuple, leaves: List[Any]) -> Any:
    if treedef[0] == "dict":
        return dict(zip(treedef[1], leaves))
    if treedef[0] == "list":
        return list(leaves)
    return leaves[0]


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


def to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def encode_values(values: np.ndarray, precision: int = 4) -> str:
    """Polyline-encode a 1-D float array (vectorized)."""
    factor = 10 ** precision
    ints = np.round(np.asarray(values, np.float64) * factor).astype(np.int64)
    if ints.size == 0:
        return ""
    deltas = np.diff(ints, prepend=np.int64(0))
    v = (deltas << 1) ^ (deltas >> 63)              # zig-zag, branchless

    # chunks emitted per value = #significant 5-bit groups (at least 1)
    width = max(1, -(-int(v.max()).bit_length() // 5))
    chunks = np.empty((len(v), width), np.uint8)
    valid = np.empty((len(v), width), bool)          # chunk j emitted?
    valid[:, 0] = True
    for j in range(width):
        chunks[:, j] = (v >> (5 * j)) & 0x1F
        if j:
            np.greater_equal(v, np.int64(1) << (5 * j), out=valid[:, j])
    cont = np.zeros_like(valid)                      # continuation bit
    cont[:, :-1] = valid[:, 1:]
    sym = (chunks | (cont.view(np.uint8) << 5)) + 63
    return sym[valid].tobytes().decode("ascii")


def decode_values(encoded: str, precision: int = 4) -> np.ndarray:
    """Inverse of :func:`encode_values` (vectorized)."""
    factor = 10 ** precision
    if not encoded:
        return np.zeros(0, np.float32)
    b = np.frombuffer(encoded.encode("ascii"), np.uint8).astype(np.int64) - 63
    ends = (b & 0x20) == 0                     # last chunk of each value
    gid = np.concatenate([[0], np.cumsum(ends[:-1])])
    starts = np.concatenate([[0], np.nonzero(ends)[0][:-1] + 1])
    pos = np.arange(len(b)) - starts[gid]

    res = np.zeros(int(ends.sum()), np.uint64)
    np.add.at(res, gid,
              (b & 0x1F).astype(np.uint64) << (pos.astype(np.uint64)
                                               * np.uint64(5)))
    res = res.astype(np.int64)
    delta = np.where(res & 1, ~(res >> 1), res >> 1)
    return (np.cumsum(delta) / factor).astype(np.float32)


def encode_values_ref(values: np.ndarray, precision: int = 4) -> str:
    """Scalar reference of :func:`encode_values`: one value at a time, as
    the algorithm is written down (the equivalence oracle)."""
    factor = 10 ** precision
    ints = np.round(np.asarray(values, np.float64) * factor).astype(np.int64)
    deltas = np.diff(ints, prepend=np.int64(0))
    out: List[str] = []
    for d in deltas:
        v = int(d) << 1
        if d < 0:
            v = ~v
        while v >= 0x20:
            out.append(chr((0x20 | (v & 0x1F)) + 63))
            v >>= 5
        out.append(chr(v + 63))
    return "".join(out)


def decode_values_ref(encoded: str, precision: int = 4) -> np.ndarray:
    """Scalar reference of :func:`decode_values`."""
    factor = 10 ** precision
    vals: List[float] = []
    acc = 0
    idx = 0
    n = len(encoded)
    while idx < n:
        shift = 0
        result = 0
        while True:
            b = ord(encoded[idx]) - 63
            idx += 1
            result |= (b & 0x1F) << shift
            shift += 5
            if b < 0x20:
                break
        delta = ~(result >> 1) if (result & 1) else (result >> 1)
        acc += delta
        vals.append(acc / factor)
    return np.asarray(vals, np.float32)


def marshal(params: Any, precision: int = 4) -> Dict[str, Any]:
    """Tree -> {payloads: [str], shapes, dtypes, treedef}. Lossy."""
    leaves, treedef = tree_flatten(params)
    payloads, shapes, dtypes = [], [], []
    for leaf in leaves:
        arr = to_numpy(leaf)
        payloads.append(encode_values(arr.reshape(-1), precision))
        shapes.append(arr.shape)
        dtypes.append(str(arr.dtype))
    return {"payloads": payloads, "shapes": shapes, "dtypes": dtypes,
            "treedef": treedef, "precision": precision}


def unmarshal(msg: Dict[str, Any]) -> Any:
    leaves = []
    for payload, shape, dtype in zip(msg["payloads"], msg["shapes"],
                                     msg["dtypes"]):
        arr = decode_values(payload, msg["precision"])
        leaves.append(arr.reshape(shape).astype(dtype))
    return tree_unflatten(msg["treedef"], leaves)


def payload_bytes(msg: Dict[str, Any]) -> int:
    """Wire size: ASCII payloads + 8 bytes of dims metadata per leaf."""
    return sum(len(p) for p in msg["payloads"]) + 8 * len(msg["shapes"])


def _nbytes(leaf: Any) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return np.asarray(leaf).nbytes


def raw_bytes(params: Any) -> int:
    return sum(_nbytes(l) for l in tree_leaves(params))


def roundtrip_error(params: Any, precision: int = 4) -> float:
    """Max absolute error of a marshal/unmarshal roundtrip over all leaves."""
    rt = unmarshal(marshal(params, precision))
    return max(float(np.max(np.abs(to_numpy(a) - to_numpy(b))))
               for a, b in zip(tree_leaves(params), tree_leaves(rt)))
