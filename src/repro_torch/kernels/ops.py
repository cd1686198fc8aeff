"""Public wrappers around the port's kernels: shape massaging only.

The counterpart of ``repro/kernels/ops.py``.  Codec: the reference flattens
each leaf and zero-pads it to a multiple of 8 x 256 (a TPU tiling
artefact); the CUDA kernel masks the ragged tail itself, so here a leaf is
only flattened and the blocks are the same 256-value blocks from offset 0.
Attention: the kernel takes the (B, S, H, hd) / (B, T, KV, hd) layout and
the GQA grouping by index, so :func:`flash_attention` (the kernel's own
wrapper, re-exported) needs no repeat, transpose or padding; its CPU path
and ``attention(impl="blocked")`` are one function, :func:`blocked_attention`
(kernels/ref.py).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import polyline_codec as codec
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
from repro_torch.kernels.ref import blocked_attention  # noqa: F401


def compress(x: torch.Tensor, bits: int = 8):
    """x: any shape -> (q (ceil(n/256), 256) int, scale (ceil(n/256), 1))."""
    flat = x.reshape(-1).to(torch.float32).contiguous()
    return codec.compress_blocks(flat, bits)


def decompress(q: torch.Tensor, scale: torch.Tensor,
               shape: Tuple[int, ...]) -> torch.Tensor:
    """Inverse of :func:`compress` for a leaf of ``shape`` (float32)."""
    n = math.prod(shape)
    return codec.decompress_blocks(q, scale, n).reshape(shape)


# --- attention ---------------------------------------------------------------

ATTENTION_IMPLS = ("auto", "kernel", "blocked")


def default_attention_impl(x: torch.Tensor) -> str:
    """What ``attention(impl="auto")`` resolves to for tensors like ``x``:
    the CUDA kernel on the card, the blocked torch path on the CPU."""
    return "kernel" if x.device.type == "cuda" else "blocked"


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: Optional[int] = None,
              impl: str = "auto", block: int = 64, prefix_len: int = 0
              ) -> torch.Tensor:
    """One entry point for fast attention: q (B, S, H, hd); k/v
    (B, T, KV, hd) with H % KV == 0.  ``impl`` is ``auto``
    (:func:`default_attention_impl`) | ``kernel`` | ``blocked``."""
    if impl not in ATTENTION_IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; expected one of "
                         f"{ATTENTION_IMPLS}")
    if impl == "auto":
        impl = default_attention_impl(q)
    if impl == "kernel":
        if prefix_len:
            raise NotImplementedError(
                "prefix-LM masks need impl='blocked' (the flash kernel "
                "only knows causal/window masks)")
        return flash_attention(q, k, v, causal=causal, window=window)
    return blocked_attention(q, k, v, causal=causal, window=window,
                             block=block, prefix_len=prefix_len)
