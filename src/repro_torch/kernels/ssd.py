"""Wrappers of the Mamba2 SSD chunk-scan kernel (csrc/ssd.cu) and of its
backward (csrc/ssd_bwd.cu).

    ssd_scan(x (B, S, H, P), Bm/Cm (B, S, N), da (B, S, H),
             h (B, H, P, N) f32) -> y (B, S, H, P)
    ssd_backward(x, Bm, Cm, da, h0, dy[, dh]) -> (dx, dBm, dCm, dda, dh0)
    ssd_backward_dstates(Cm, da, dy[, dh]) -> (dstates, dh0)       (pass 1)
    ssd_backward_chunks(x, Bm, Cm, da, states, dstates, dy)
        -> (dx, dB, dC per head, dda)                               (pass 2)
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
each of its chunks, which the backward reads (fp32 only, as training is).
The backward kernel runs in two passes: :func:`ssd_backward_dstates`
scans the chunks in reverse carrying only the state's gradient and
writes it after every chunk into a scratch tensor, and
:func:`ssd_backward_chunks` takes every chunk on its own from its start
state and that gradient, writing dB and dC per head; :func:`ssd_backward`
runs both and sums dB and dC over the heads, in a fixed order.  On the
CPU each is its plain version in ``kernels/ref.py`` (``ssd_chunk_dstates``,
``ssd_chunk_grads``, ``ssd_chunked_backward``).
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
    {"ssd_bwd_dstate": [_vp] * 6 + [_ci] * 5 + [_vp],
     "ssd_bwd": [_vp] * 11 + [_ci] * 5 + [_vp],
     "ssd_bwd_attr": [_ci, _ci]},
    kernels=("ssd_bwd_dstate", "ssd_bwd"))


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


def bwd_attrs(which: int) -> dict:
    """What the backward's pass 1 (``which`` = 1, a CTA per (batch, head,
    16 rows of the state)) or pass 2 (2, a CTA per (batch, head, chunk))
    takes on the current card: {"ctas_per_sm", "registers", "smem_bytes"
    (a CTA's, static and dynamic), "threads" (a CTA's)}; builds the
    kernels, launches nothing."""
    return {key: _BWD.query("ssd_bwd_attr", which, what)
            for what, key in enumerate(("ctas_per_sm", "registers",
                                        "smem_bytes", "threads"))}


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


def ssd_backward_dstates(Cm: torch.Tensor, da: torch.Tensor,
                         dy: torch.Tensor,
                         dh: Optional[torch.Tensor] = None):
    """Pass 1 of :func:`ssd_backward`: (dstates (B, H, n_chunks, P, N), the
    gradient of the state after each chunk, whose last entry is ``dh``
    (None = 0); dh0 (B, H, P, N)), f32, from Cm (B, S, N), da (B, S, H)
    and dy (B, S, H, P), at the kernel's chunk of 32.  A CPU tensor takes
    ``ref.ssd_chunk_dstates``; a CUDA one launches ``ssd_bwd_dstate``."""
    B, S, H, P = dy.shape
    N = Cm.shape[-1]
    if tuple(Cm.shape) != (B, S, N) or tuple(da.shape) != (B, S, H) or (
            dh is not None and tuple(dh.shape) != (B, H, P, N)) or len(
            {t.device for t in (Cm, da, dy)}) != 1:
        raise ValueError(f"ssd_backward_dstates: Cm {tuple(Cm.shape)}, da "
                         f"{tuple(da.shape)}, dh do not match dy "
                         f"{tuple(dy.shape)} on one device")
    if dy.device.type == "cpu":
        return ref.ssd_chunk_dstates(Cm, da, dy, dh, KERNEL_CHUNK)
    Cm, da, dy = kbuild.bwd_operands(
        "ssd_backward_dstates", (Cm, da, dy), {"head_dim": P, "d_state": N},
        MAX_DIM)
    dhc = None if dh is None else dh.float().contiguous()
    dstates = torch.empty((B, H, n_chunks(S), P, N), dtype=torch.float32,
                          device=dy.device)
    dh0 = torch.empty((B, H, P, N), dtype=torch.float32, device=dy.device)
    with torch.cuda.device(dy.device):
        _BWD.launch(
            "ssd_bwd_dstate", "ssd_bwd_dstate",
            Cm.data_ptr(), da.data_ptr(), dy.data_ptr(),
            None if dhc is None else dhc.data_ptr(), dstates.data_ptr(),
            dh0.data_ptr(), B, S, H, P, N,
            torch.cuda.current_stream().cuda_stream)
    return dstates, dh0


def ssd_backward_chunks(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                        da: torch.Tensor, chunk_states: torch.Tensor,
                        dstates: torch.Tensor, dy: torch.Tensor):
    """Pass 2 of :func:`ssd_backward`: every chunk's gradients from its
    start state (``chunk_states``, the forward's) and the gradient after it
    (``dstates``, pass 1's), both (B, H, n_chunks, P, N): (dx (B, S, H, P),
    dB, dC (B, S, H, N), each head's part, dda (B, S, H)), f32, at the
    kernel's chunk of 32.  A CPU tensor takes ``ref.ssd_chunk_grads``; a
    CUDA one launches ``ssd_bwd``."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if x.shape != dy.shape or Bm.shape != Cm.shape or \
            tuple(Bm.shape) != (B, S, N) or tuple(da.shape) != (B, S, H) or \
            len({t.device for t in (x, Bm, Cm, da, dy)}) != 1:
        raise ValueError(f"ssd_backward_chunks: x, dy must be (B, S, H, P), "
                         f"Bm, Cm (B, S, N) and da (B, S, H) on one device, "
                         f"got {tuple(x.shape)}, {tuple(dy.shape)}, "
                         f"{tuple(Bm.shape)}, {tuple(Cm.shape)}, "
                         f"{tuple(da.shape)}")
    if x.device.type == "cpu":
        return ref.ssd_chunk_grads(x, Bm, Cm, da, chunk_states, dstates, dy,
                                   KERNEL_CHUNK)
    want = (B, H, n_chunks(S), P, N)
    kbuild.check_states(
        "ssd_backward_chunks", chunk_states, want, x.device,
        "the forward's chunk states (ssd_scan(..., chunk_states=))")
    kbuild.check_states(
        "ssd_backward_chunks", dstates, want, x.device,
        "pass 1's state gradients (ssd_backward_dstates)")
    x, Bm, Cm, da, dy, cs, ds = kbuild.bwd_operands(
        "ssd_backward_chunks", (x, Bm, Cm, da, dy, chunk_states, dstates),
        {"head_dim": P, "d_state": N}, MAX_DIM)
    dx = torch.empty((B, S, H, P), dtype=torch.float32, device=x.device)
    dBh, dCh = (torch.empty((B, S, H, N), dtype=torch.float32,
                            device=x.device) for _ in range(2))
    dda = torch.empty((B, S, H), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _BWD.launch(
            "ssd_bwd", "ssd_bwd",
            x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), da.data_ptr(),
            cs.data_ptr(), ds.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dBh.data_ptr(), dCh.data_ptr(), dda.data_ptr(),
            B, S, H, P, N, torch.cuda.current_stream().cuda_stream)
    return dx, dBh, dCh, dda


def ssd_backward(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                 da: torch.Tensor, h0: torch.Tensor, dy: torch.Tensor,
                 dh: Optional[torch.Tensor] = None,
                 chunk_states: Optional[torch.Tensor] = None,
                 chunk: int = KERNEL_CHUNK):
    """The gradient of :func:`ssd_scan` from ``h0``, given dy (B, S, H, P)
    and the final state's ``dh`` (None = 0): (dx (B, S, H, P), dBm, dCm
    (B, S, N), dda (B, S, H), dh0 (B, H, P, N)), f32.  A CPU tensor takes
    ``ref.ssd_chunked_backward`` at ``chunk``; a CUDA one launches the
    backward's two passes (fp32 only), which read ``chunk_states``, the
    forward's (:func:`ssd_scan`), in place of ``h0``, and sums pass 2's
    per-head dB and dC over the heads."""
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
    kbuild.check_states(
        "ssd_backward", chunk_states, (B, H, n_chunks(S), P, N), x.device,
        "the forward's chunk states (ssd_scan(..., chunk_states=))")
    x, Bm, Cm, da, dy = kbuild.bwd_operands(
        "ssd_backward", (x, Bm, Cm, da, dy), {"head_dim": P, "d_state": N},
        MAX_DIM)
    dstates, dh0 = ssd_backward_dstates(Cm, da, dy, dh)
    dx, dBh, dCh, dda = ssd_backward_chunks(x, Bm, Cm, da, chunk_states,
                                            dstates, dy)
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
