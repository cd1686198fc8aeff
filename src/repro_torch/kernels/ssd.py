"""Wrappers of the Mamba2 SSD chunk-scan kernel (csrc/ssd.cu) and of its
backward (csrc/ssd_bwd.cu).

    ssd_scan(x (B, S, H, P), Bm/Cm (B, S, N), da (B, S, H),
             h (B, H, P, N) f32) -> y (B, S, H, P)
    ssd_backward(x, Bm, Cm, da, h0, dy[, dh]) -> (dx, dBm, dCm, dda, dh0)
    SSDScan.apply(x, Bm, Cm, da, h0[, chunk]) -> (y, final state)

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

Training goes through :class:`SSDScan`, which writes no caller's buffer:
its forward takes the state in as an input and returns the final state,
and on the card it asks the forward kernel for the state at the start of
each of its chunks, which the backward kernel reads (fp32 only, as
training is); the backward writes dB and dC per head and this module
sums them over the heads.  On the CPU its backward is
``ref.ssd_chunked_backward``.
"""
from __future__ import annotations

import ctypes

import torch

from typing import Optional

from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ref

MAX_DIM = 64
#: the kernel's own chunk (csrc/chunk_scan.cuh kChunk)
KERNEL_CHUNK = 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_vp, _ci, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LIB = kbuild.Library(
    "ssd", "ssd_error_string",
    {"ssd_fwd": [_vp] * 7 + [_ci] * 6 + [_ll] * 10 + [_vp],
     "ssd_ctas_per_sm": [_ci]},
    kernels=("ssd",))
_BWD = kbuild.Library(
    "ssd_bwd", "ssd_bwd_error_string",
    {"ssd_bwd": [_vp] * 12 + [_ci] * 5 + [_vp]}, kernels=("ssd_bwd",))


def launch_counts():
    return {**_LIB.launch_counts(), **_BWD.launch_counts()}


def reset_launch_counts() -> None:
    _LIB.reset_launch_counts()
    _BWD.reset_launch_counts()


def n_chunks(S: int) -> int:
    """The kernels' chunks over S tokens (the chunk-state count)."""
    return -(-S // KERNEL_CHUNK)


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
             chunk: int = KERNEL_CHUNK,
             chunk_states: Optional[torch.Tensor] = None) -> torch.Tensor:
    """SSD over x (B, S, H, P), Bm/Cm (B, S, N), da (B, S, H) from ``h``
    (B, H, P, N) f32, which ends holding the final state; returns y
    (B, S, H, P) in x's dtype.  ``chunk_states``, a contiguous f32 (B, H,
    n_chunks(S), P, N) CUDA tensor, also receives the state at the start
    of each of the kernel's chunks (for :func:`ssd_backward`)."""
    _check_operands(x, Bm, Cm, da, h)
    if chunk_states is not None:
        B, S, H, P = x.shape
        want = (B, H, n_chunks(S), P, Bm.shape[-1])
        if (chunk_states.device != x.device or x.device.type != "cuda"
                or tuple(chunk_states.shape) != want
                or chunk_states.dtype != torch.float32
                or not chunk_states.is_contiguous()):
            raise ValueError(
                f"ssd_scan: chunk_states must be a contiguous float32 CUDA "
                f"tensor {want} beside CUDA operands, got "
                f"{chunk_states.dtype} {tuple(chunk_states.shape)} on "
                f"{chunk_states.device}")
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
            y.data_ptr(), h.data_ptr(),
            None if chunk_states is None else chunk_states.data_ptr(),
            _DTYPES[x.dtype], B, S, H, P, N,
            x.stride(0), x.stride(1), x.stride(2),
            Bm.stride(0), Bm.stride(1), Cm.stride(0), Cm.stride(1),
            d.stride(0), d.stride(1), d.stride(2),
            torch.cuda.current_stream().cuda_stream)
    return y


def ssd_backward(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                 da: torch.Tensor, h0: torch.Tensor, dy: torch.Tensor,
                 dh: Optional[torch.Tensor] = None,
                 chunk_states: Optional[torch.Tensor] = None,
                 chunk: int = KERNEL_CHUNK):
    """The gradient of :func:`ssd_scan` from ``h0``, given dy (B, S, H, P)
    and the final state's ``dh`` (None = 0): (dx (B, S, H, P), dBm, dCm
    (B, S, N), dda (B, S, H), dh0 (B, H, P, N)), f32.  A CPU tensor takes
    ``ref.ssd_chunked_backward`` at ``chunk``; a CUDA one launches the
    backward kernel (fp32 only), which reads ``chunk_states``, the
    forward's (:func:`ssd_scan`), in place of ``h0``, and writes dB and dC
    per head, summed here over the heads."""
    _check_operands(x, Bm, Cm, da, h0)
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if tuple(dy.shape) != (B, S, H, P) or dy.device != x.device or (
            dh is not None and (tuple(dh.shape) != (B, H, P, N)
                                or dh.device != x.device)):
        raise ValueError(f"ssd_backward: dy must be {(B, S, H, P)} and dh "
                         f"{(B, H, P, N)} on {x.device}, got "
                         f"{tuple(dy.shape)} and "
                         f"{None if dh is None else tuple(dh.shape)}")
    if x.device.type == "cpu":
        return ref.ssd_chunked_backward(x, Bm, Cm, da, h0, dy, dh, chunk)
    if any(t.dtype != torch.float32 for t in (x, Bm, Cm, da, dy)):
        raise ValueError(
            f"ssd_backward: the backward kernel is fp32 only (training is "
            f"fp32), got x {x.dtype}, Bm {Bm.dtype}, Cm {Cm.dtype}, da "
            f"{da.dtype}, dy {dy.dtype}")
    if P > MAX_DIM or N > MAX_DIM:
        raise ValueError(f"ssd_backward supports head_dim and d_state <= "
                         f"{MAX_DIM}, got {P} and {N}")
    want = (B, H, n_chunks(S), P, N)
    if chunk_states is None or tuple(chunk_states.shape) != want or \
            chunk_states.dtype != torch.float32 or \
            chunk_states.device != x.device:
        raise ValueError(
            f"ssd_backward on the card reads the forward's chunk states: "
            f"pass chunk_states, the float32 {want} tensor that "
            f"ssd_scan(..., chunk_states=) filled")
    x, Bm, Cm, da, dy = (t.contiguous() for t in (x, Bm, Cm, da, dy))
    cs = chunk_states.contiguous()
    dhc = None if dh is None else dh.float().contiguous()
    dx = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    dBh, dCh = (torch.empty((B, S, H, N), dtype=torch.float32,
                            device=x.device) for _ in range(2))
    dda = torch.empty((B, S, H), dtype=torch.float32, device=x.device)
    dh0 = torch.empty((B, H, P, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _BWD.launch(
            "ssd_bwd", "ssd_bwd",
            x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), da.data_ptr(),
            cs.data_ptr(), dy.data_ptr(),
            None if dhc is None else dhc.data_ptr(), dx.data_ptr(),
            dBh.data_ptr(), dCh.data_ptr(), dda.data_ptr(), dh0.data_ptr(),
            B, S, H, P, N, torch.cuda.current_stream().cuda_stream)
    return dx, dBh.sum(2), dCh.sum(2), dda, dh0


class SSDScan(torch.autograd.Function):
    """Differentiable :func:`ssd_scan`: ``SSDScan.apply(x, Bm, Cm, da, h0,
    chunk=32)`` -> (y, final state), writing no buffer of the caller's
    (``h0`` is read, the final state is a new tensor).  On the card the
    forward kernel also writes its chunk states when a gradient is
    needed, and the backward kernel reads them; on the CPU both are the
    plain versions at ``chunk``."""

    @staticmethod
    def forward(ctx, x, Bm, Cm, da, h0, chunk: int = KERNEL_CHUNK):
        ctx.set_materialize_grads(False)
        h = h0.detach().float().clone()
        B, S, H, P = x.shape
        states = None
        if x.device.type == "cuda" and any(ctx.needs_input_grad[:5]):
            states = torch.empty((B, H, n_chunks(S), P, Bm.shape[-1]),
                                 dtype=torch.float32, device=x.device)
        y = ssd_scan(x, Bm, Cm, da, h, chunk=chunk, chunk_states=states)
        ctx.save_for_backward(x, Bm, Cm, da, h0, states)
        ctx.chunk = chunk
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, Bm, Cm, da, h0, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        grads = ssd_backward(x, Bm, Cm, da, h0, dy.float(), dh,
                             chunk_states=states, chunk=ctx.chunk)
        return (*(g.to(t.dtype) for g, t in zip(
            grads, (x, Bm, Cm, da, h0))), None)
