"""Public wrappers around the port's kernels: shape massaging only.

The counterpart of ``repro/kernels/ops.py``.  Codec: the reference flattens
each leaf and zero-pads it to a multiple of 8 x 256 (a TPU tiling
artefact); the CUDA kernel masks the ragged tail itself, so here a leaf is
only flattened and the blocks are the same 256-value blocks from offset 0.
:func:`compress` / :func:`decompress` keep the reference's per-leaf pair
and its int payload; the links' lossy step does not come through here but
calls the fused ``polyline_codec.roundtrip_blocks`` once over all leaves.
Attention: the kernel takes the (B, S, H, hd) / (B, T, KV, hd) layout and
the GQA grouping by index, so :func:`flash_attention` (the kernel's own
wrapper, re-exported) needs no repeat, transpose or padding; its CPU path
and ``attention(impl="blocked")`` are one function, :func:`blocked_attention`
(kernels/ref.py).  ``attention(impl="kernel")`` on operands that need a
gradient goes through ``flash_attention.FlashAttention`` (the forward with
its log-sum-exp, and the backward kernel); without one (serving, under
``no_grad``) it calls the forward alone.  Chunk scans: the kernels take
the model's (B, S, H, N) layout with a state in and out
(kernels/rwkv6_scan.py, kernels/ssd.py), in chunks of their own
(``KERNEL_CHUNK``, 32 tokens);
:func:`wkv6` and :func:`ssd` keep the reference's flattened (BH, S, .)
contract on top of them from a zero state (wkv6 as one batch row of BH
heads, read through strides; ssd as BH batch rows of one head, since B
and C come per row), and need no padding: the kernels mask the ragged
last chunk, and their CPU path pads it.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import polyline_codec as codec
from repro_torch.kernels import rwkv6_scan
from repro_torch.kernels import ssd as ssd_mod
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
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return fa.FlashAttention.apply(q, k, v, causal, window)
        return flash_attention(q, k, v, causal=causal, window=window)
    return blocked_attention(q, k, v, causal=causal, window=window,
                             block=block, prefix_len=prefix_len)


# --- wkv6 ---------------------------------------------------------------------

def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor, chunk: int = 64
         ) -> torch.Tensor:
    """r/k/v/logw: (BH, S, N); u: (BH, N) -> y (BH, S, N), from a zero
    state.  ``chunk`` is the CPU path's chunk; the kernel takes its own
    (``rwkv6_scan.KERNEL_CHUNK``), which gives the same function."""
    BH, S, N = r.shape
    state = torch.zeros((1, BH, N, N), dtype=torch.float32, device=r.device)
    heads = lambda a: a.transpose(0, 1)[None]   # noqa: E731  (1, S, BH, N)
    y = rwkv6_scan.wkv6(heads(r), heads(k), heads(v), heads(logw), u, state,
                        chunk=chunk)
    return y[0].transpose(0, 1)


# --- ssd ----------------------------------------------------------------------

def ssd(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
        da: torch.Tensor, chunk: int = 64) -> torch.Tensor:
    """x: (BH, S, P); Bm/Cm: (BH, S, N); da: (BH, S, 1) -> y (BH, S, P),
    from a zero state.  ``chunk`` is the CPU path's chunk; the kernel takes
    its own (``ssd.KERNEL_CHUNK``), which gives the same function."""
    BH, S, P = x.shape
    h = torch.zeros((BH, 1, P, Bm.shape[-1]), dtype=torch.float32,
                    device=x.device)
    y = ssd_mod.ssd_scan(x[:, :, None], Bm, Cm, da, h, chunk=chunk)
    return y[:, :, 0]
