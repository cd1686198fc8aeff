"""Public wrappers around the port's kernels: shape massaging only.

The counterpart of ``repro/kernels/ops.py`` for the codec.  The reference
flattens each leaf and zero-pads it to a multiple of 8 x 256 (a TPU tiling
artefact); the CUDA kernel masks the ragged tail itself, so here a leaf is
only flattened and the blocks are the same 256-value blocks from offset 0.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.kernels import polyline_codec as codec


def compress(x: torch.Tensor, bits: int = 8):
    """x: any shape -> (q (ceil(n/256), 256) int, scale (ceil(n/256), 1))."""
    flat = x.reshape(-1).to(torch.float32).contiguous()
    return codec.compress_blocks(flat, bits)


def decompress(q: torch.Tensor, scale: torch.Tensor,
               shape: Tuple[int, ...]) -> torch.Tensor:
    """Inverse of :func:`compress` for a leaf of ``shape`` (float32)."""
    n = math.prod(shape)
    return codec.decompress_blocks(q, scale, n).reshape(shape)
