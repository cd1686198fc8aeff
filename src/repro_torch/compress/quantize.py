"""Blockwise fixed-point quantization: the wire format of the quantize
link codecs (the port of ``repro/compress/quantize.py``).

  * split the flat weight vector into blocks of 256,
  * per-block scale s = max|x| / qmax  (qmax = 127 for int8, 32767 for int16),
  * q = round(x / s) stored as int8/int16, s as f32 (1/256 overhead).

This module builds the marshalled message and its byte count (plain torch,
eager division as the reference's eager marshal uses).  The in-graph lossy
roundtrip of the link runs the fused CUDA kernel instead
(kernels/polyline_codec.py ``roundtrip_blocks`` via compress/transport.py).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.compress.polyline import tree_flatten, tree_unflatten

BLOCK = 256


class Compressed(NamedTuple):
    q: torch.Tensor        # (n_blocks, BLOCK) int8/int16 (zero-padded tail)
    scale: torch.Tensor    # (n_blocks,) f32
    size: int              # original flat length


def _qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def compress(x: Any, bits: int = 8) -> Compressed:
    dtype = torch.int8 if bits <= 8 else torch.int16
    flat = torch.as_tensor(x).reshape(-1).to(torch.float32)
    n = flat.shape[0]
    nb = -(-n // BLOCK)
    blocks = F.pad(flat, (0, nb * BLOCK - n)).reshape(nb, BLOCK)
    qmax = _qmax(bits)
    scale = blocks.abs().amax(dim=1) / qmax if nb else blocks.new_zeros(0)
    scale = torch.clamp_min(scale, 1e-30)
    q = torch.clamp(torch.round(blocks / scale[:, None]), -qmax, qmax)
    return Compressed(q=q.to(dtype), scale=scale, size=n)


def decompress(c: Compressed, shape: Tuple[int, ...],
               dtype=torch.float32) -> torch.Tensor:
    flat = (c.q.to(torch.float32) * c.scale[:, None]).reshape(-1)[:c.size]
    return flat.reshape(shape).to(dtype)


def wire_bytes(c: Compressed) -> int:
    return int(c.q.numel() * c.q.element_size() + c.scale.numel() * 4)


def compress_tree(tree: Any, bits: int = 8):
    leaves, treedef = tree_flatten(tree)
    leaves = [torch.as_tensor(l) for l in leaves]
    return {"comps": [compress(l, bits) for l in leaves],
            "shapes": [tuple(l.shape) for l in leaves],
            "dtypes": [l.dtype for l in leaves], "treedef": treedef}


def decompress_tree(msg) -> Any:
    leaves = [decompress(c, s, d) for c, s, d in
              zip(msg["comps"], msg["shapes"], msg["dtypes"])]
    return tree_unflatten(msg["treedef"], leaves)


def tree_wire_bytes(msg) -> int:
    return sum(wire_bytes(c) for c in msg["comps"]) + 8 * len(msg["shapes"])
