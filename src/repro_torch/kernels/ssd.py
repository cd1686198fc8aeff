"""Wrapper of the Mamba2 SSD chunk-scan kernel (csrc/ssd.cu).

    ssd_scan(x (B, S, H, P), Bm/Cm (B, S, N), da (B, S, H),
             h (B, H, P, N) f32) -> y (B, S, H, P)

The port of ``repro/kernels/ssd.py`` with a state in and out: the SSD
recurrence from ``h``, whose final value is written back into ``h`` in
place.  ``x`` has dt folded in, ``da`` is the log decay (<= 0), and B and
C have no head axis (``n_groups = 1``): the kernel reads one row of each
for all the heads of a batch row, never H copies.  This one entry serves
both callers: the model's chunk scan (``models/mamba2.py``
``_ssd_chunked``) and ``ops.ssd`` (the reference's (BH, S, P) contract,
viewed as BH batch rows of one head with a zero state).  y comes out in
x's dtype; arithmetic is f32.

A tensor on the CPU takes the plain version (kernels/ref.py
``ssd_chunked`` at ``chunk``); a CUDA tensor launches the kernel, which
takes its own chunk of 32 tokens whatever ``chunk`` says (the function is
the same), or raises, with no fallback.  The kernel holds each head's
state in the registers of one CTA of four warps and runs every product of
a chunk on the tensor cores in 3xTF32, so fp32 inputs keep fp32 accuracy
(csrc/ssd.cu says how).  CUDA launches are counted (:func:`launch_counts`);
:func:`ctas_per_sm` reports the kernel's occupancy.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ref

MAX_DIM = 64
#: the kernel's own chunk (csrc/chunk_scan.cuh kChunk)
KERNEL_CHUNK = 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_vp, _ci, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LIB = kbuild.Library(
    "ssd", "ssd_error_string",
    {"ssd_fwd": [_vp] * 6 + [_ci] * 6 + [_ll] * 10 + [_vp],
     "ssd_ctas_per_sm": [_ci]},
    kernels=("ssd",))
launch_counts = _LIB.launch_counts
reset_launch_counts = _LIB.reset_launch_counts


def ctas_per_sm(dtype: torch.dtype) -> int:
    """CTAs of the kernel for ``dtype`` inputs that fit on one SM of the
    current card (one CTA per (batch, head)); builds the kernel, launches
    nothing."""
    return _LIB.query("ssd_ctas_per_sm", _DTYPES[dtype])


def _check_operands(x, Bm, Cm, da, h) -> None:
    if x.dim() != 4 or Bm.dim() != 3 or Bm.shape != Cm.shape:
        raise ValueError(f"ssd_scan takes x (B, S, H, P) and Bm/Cm (B, S, "
                         f"N), got {tuple(x.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}")
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if tuple(Bm.shape[:2]) != (B, S) or tuple(da.shape) != (B, S, H):
        raise ValueError(f"ssd_scan: Bm/Cm {tuple(Bm.shape)} and da "
                         f"{tuple(da.shape)} do not match x {tuple(x.shape)} "
                         f"(need (B, S, N) and (B, S, H))")
    if tuple(h.shape) != (B, H, P, N) or h.dtype != torch.float32:
        raise ValueError(f"ssd_scan: h must be float32 {(B, H, P, N)}, got "
                         f"{h.dtype} {tuple(h.shape)}")
    if not (x.dtype == Bm.dtype == Cm.dtype) or x.dtype not in _DTYPES:
        raise ValueError(f"ssd_scan takes float32 or bfloat16 x, Bm, Cm of "
                         f"one dtype, got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if not da.is_floating_point():
        raise ValueError(f"ssd_scan: da must be floating point, got "
                         f"{da.dtype}")
    devs = {t.device for t in (x, Bm, Cm, da, h)}
    if len(devs) != 1 or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan: every operand must be on one cpu or "
                         f"cuda device, got {sorted(map(str, devs))}")
    if min(B, S, H, P, N) < 1:
        raise ValueError(f"ssd_scan: empty operands {tuple(x.shape)}, "
                         f"{tuple(Bm.shape)}")


def ssd_scan(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
             da: torch.Tensor, h: torch.Tensor,
             chunk: int = KERNEL_CHUNK) -> torch.Tensor:
    """SSD over x (B, S, H, P), Bm/Cm (B, S, N), da (B, S, H) from ``h``
    (B, H, P, N) f32, which ends holding the final state; returns y
    (B, S, H, P) in x's dtype."""
    _check_operands(x, Bm, Cm, da, h)
    if x.device.type == "cpu":
        y, new = ref.ssd_chunked(x, Bm, Cm, da, h, chunk)
        h.copy_(new)
        return y.to(x.dtype)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if P > MAX_DIM or N > MAX_DIM:
        raise ValueError(f"ssd_scan supports head_dim and d_state <= "
                         f"{MAX_DIM}, got {P} and {N}")
    if any(t.stride(-1) != 1 for t in (x, Bm, Cm)):
        raise ValueError("ssd_scan: the last dim of x, Bm and Cm must have "
                         "stride 1")
    if not h.is_contiguous():
        raise ValueError("ssd_scan: h must be contiguous (it is written in "
                         "place)")
    d = da.float()
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        _LIB.launch(
            "ssd", "ssd_fwd",
            x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), d.data_ptr(),
            y.data_ptr(), h.data_ptr(), _DTYPES[x.dtype], B, S, H, P, N,
            x.stride(0), x.stride(1), x.stride(2),
            Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
            d.stride(0), d.stride(1), d.stride(2),
            torch.cuda.current_stream().cuda_stream)
    return y
