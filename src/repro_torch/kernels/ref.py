"""Plain PyTorch versions of the port's kernels.

The CPU path of every kernel wrapper, and the yardstick the CUDA kernels
are held against on the card (chip_smoke.py).  Each repeats its kernel's
arithmetic exactly, so the comparison is bitwise.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK = 256


def qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def code_dtype(bits: int) -> torch.dtype:
    return torch.int8 if bits <= 8 else torch.int16


def compress_blocks(x: torch.Tensor, bits: int = 8):
    """x: flat (n,) float32 -> (q (ceil(n/256), 256) int8|int16,
    scale (ceil(n/256), 1) float32); the ragged tail reads as zeros.

    ``scale = max(max|x| * fl32(1/qmax), 1e-30)`` is the reciprocal-multiply
    form XLA compiles ``max|x| / qmax`` into under jit; ``x / scale`` is a
    true division and ``torch.round`` rounds half to even, as jnp.round does.
    """
    n = x.numel()
    nb = -(-n // BLOCK)
    blocks = F.pad(x, (0, nb * BLOCK - n)).reshape(nb, BLOCK)
    q_max = qmax(bits)
    one = torch.ones((), dtype=torch.float32, device=x.device)
    inv = one / float(q_max)            # correctly rounded f32 reciprocal
    floor = torch.full((), 1e-30, dtype=torch.float32, device=x.device)
    # torch.maximum propagates NaN, as jnp.maximum does
    scale = torch.maximum(blocks.abs().amax(dim=1, keepdim=True) * inv, floor)
    q = torch.clamp(torch.round(blocks / scale), -q_max, q_max)
    return q.to(code_dtype(bits)), scale


def decompress_blocks(q: torch.Tensor, scale: torch.Tensor, n: int
                      ) -> torch.Tensor:
    """Inverse of :func:`compress_blocks`: the first ``n`` values of
    ``float(q) * scale``, flat."""
    return (q.to(torch.float32) * scale).reshape(-1)[:n]
