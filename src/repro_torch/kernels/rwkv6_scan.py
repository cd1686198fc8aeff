"""Wrapper of the WKV6 chunk-scan kernel (csrc/wkv6.cu).

    wkv6(r, k, v, logw (B, S, H, N), u (H, N), state (B, H, N, N) f32)
        -> y (B, S, H, N)

The port of ``repro/kernels/rwkv6_scan.py`` with a state in and out: the
RWKV-6 WKV recurrence from ``state``, whose final value is written back
into ``state`` in place.  This one entry serves both callers: the model's
chunk scan (``models/rwkv6.py`` ``_wkv_chunked``: (B, S, H, N) projections
read in place) and ``ops.wkv6`` (the reference's (BH, S, N) contract,
viewed through strides as B = 1 with BH heads and a zero state).  y comes
out in r's dtype; arithmetic is f32.

A tensor on the CPU takes the plain version (kernels/ref.py
``wkv6_chunked`` at ``chunk``); a CUDA tensor launches the kernel, which
takes its own chunk of 32 tokens whatever ``chunk`` says (the function is
the same), or raises, with no fallback.  The kernel holds each head's
state in the registers of one CTA of four warps, builds the chunk's
attention matrix with tensor-core products below its diagonal 8-token
blocks and pairwise exps only inside them, and runs every product on the
tensor cores in 3xTF32, so fp32 inputs keep fp32 accuracy
(csrc/wkv6.cu says how).  CUDA launches are counted
(:func:`launch_counts`); :func:`ctas_per_sm` reports the kernel's
occupancy.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ref

MAX_HEAD_SIZE = 64
#: the kernel's own chunk (csrc/chunk_scan.cuh kChunk)
KERNEL_CHUNK = 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_vp, _ci, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LIB = kbuild.Library(
    "wkv6", "wkv6_error_string",
    {"wkv6_fwd": [_vp] * 7 + [_ci] * 5 + [_ll] * 12 + [_vp],
     "wkv6_ctas_per_sm": [_ci]},
    kernels=("wkv6",))
launch_counts = _LIB.launch_counts
reset_launch_counts = _LIB.reset_launch_counts


def ctas_per_sm(dtype: torch.dtype) -> int:
    """CTAs of the kernel for ``dtype`` inputs that fit on one SM of the
    current card (one CTA per (batch, head)); builds the kernel, launches
    nothing."""
    return _LIB.query("wkv6_ctas_per_sm", _DTYPES[dtype])


def _check_operands(r, k, v, logw, u, state) -> None:
    if r.dim() != 4 or not (r.shape == k.shape == v.shape == logw.shape):
        raise ValueError(f"wkv6 takes r, k, v, logw of one shape (B, S, H, "
                         f"N), got {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(logw.shape)}")
    B, S, H, N = r.shape
    if tuple(u.shape) != (H, N):
        raise ValueError(f"wkv6: u must be (H, N) = {(H, N)}, got "
                         f"{tuple(u.shape)}")
    if tuple(state.shape) != (B, H, N, N) or state.dtype != torch.float32:
        raise ValueError(f"wkv6: state must be float32 {(B, H, N, N)}, got "
                         f"{state.dtype} {tuple(state.shape)}")
    if not (r.dtype == k.dtype == v.dtype) or r.dtype not in _DTYPES:
        raise ValueError(f"wkv6 takes float32 or bfloat16 r, k, v of one "
                         f"dtype, got {r.dtype}, {k.dtype}, {v.dtype}")
    if not logw.is_floating_point() or not u.is_floating_point():
        raise ValueError(f"wkv6: logw and u must be floating point, got "
                         f"{logw.dtype}, {u.dtype}")
    devs = {t.device for t in (r, k, v, logw, u, state)}
    if len(devs) != 1 or r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"wkv6: every operand must be on one cpu or cuda "
                         f"device, got {sorted(map(str, devs))}")
    if min(B, S, H, N) < 1:
        raise ValueError(f"wkv6: empty operands {tuple(r.shape)}")


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
         chunk: int = KERNEL_CHUNK) -> torch.Tensor:
    """WKV6 over r/k/v/logw (B, S, H, N) from ``state`` (B, H, N, N) f32,
    which ends holding the final state; returns y (B, S, H, N) in r's
    dtype; ``u`` is (H, N), the bonus of each head."""
    _check_operands(r, k, v, logw, u, state)
    if r.device.type == "cpu":
        y, new = ref.wkv6_chunked(r, k, v, logw, u, state, chunk)
        state.copy_(new)
        return y.to(r.dtype)
    B, S, H, N = r.shape
    if N > MAX_HEAD_SIZE:
        raise ValueError(f"wkv6 supports head size <= {MAX_HEAD_SIZE}, got "
                         f"{N}")
    if any(t.stride(-1) != 1 for t in (r, k, v)):
        raise ValueError("wkv6: the last dim of r, k and v must have "
                         "stride 1")
    if not state.is_contiguous():
        raise ValueError("wkv6: state must be contiguous (it is written in "
                         "place)")
    lw = logw.float()
    if lw.stride(-1) != 1:
        lw = lw.contiguous()
    uu = u.float().contiguous()
    y = torch.empty((B, S, H, N), dtype=r.dtype, device=r.device)
    with torch.cuda.device(r.device):
        _LIB.launch(
            "wkv6", "wkv6_fwd",
            r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
            uu.data_ptr(), y.data_ptr(), state.data_ptr(),
            _DTYPES[r.dtype], B, S, H, N,
            r.stride(0), r.stride(1), r.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            lw.stride(0), lw.stride(1), lw.stride(2),
            torch.cuda.current_stream().cuda_stream)
    return y
