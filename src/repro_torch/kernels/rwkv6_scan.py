"""Wrappers of the WKV6 chunk-scan kernel (csrc/wkv6.cu) and of its
backward (csrc/wkv6_bwd.cu).

    wkv6(r, k, v, logw (B, S, H, N), u (H, N), state (B, H, N, N) f32)
        -> y (B, S, H, N)
    wkv6_backward(r, k, v, logw, u, state0, dy[, dstate])
        -> (dr, dk, dv, dlogw, du, dstate0)
    wkv6_backward_dstates(r, logw, dy[, dstate]) -> (dstates, dstate0)
                                                                  (pass 1)
    wkv6_backward_chunks(r, k, v, logw, u, states, dstates, dy)
        -> (dr, dk, dv, dlogw, du per chunk)                      (pass 2)
    WKV6.apply(r, k, v, logw, u, state0[, chunk]) -> (y, final state)

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

Training goes through :class:`WKV6`, which writes no caller's buffer: its
forward takes the state in as an input and returns the final state, and
on the card it asks the forward kernel for the state at the start of
each of its chunks, which the backward reads (fp32 only, as training
is).  The backward kernel runs in two passes: :func:`wkv6_backward_dstates`
scans the chunks in reverse carrying only the state's gradient and writes
it after every chunk into a scratch tensor, and
:func:`wkv6_backward_chunks` takes every chunk on its own from its start
state and that gradient, writing du per chunk; :func:`wkv6_backward` runs
both and sums du over the batch and the chunks, in a fixed order.  On the
CPU each is its plain version in ``kernels/ref.py``
(``wkv6_chunk_dstates``, ``wkv6_chunk_grads``, ``wkv6_chunked_backward``).
"""
from __future__ import annotations

import ctypes

import torch

from typing import Optional

from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ref

MAX_HEAD_SIZE = 64
#: the kernel's own chunk (csrc/chunk_scan.cuh kChunk)
KERNEL_CHUNK = 32
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_vp, _ci, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LIB = kbuild.Library(
    "wkv6", "wkv6_error_string",
    {"wkv6_fwd": [_vp] * 8 + [_ci] * 5 + [_ll] * 12 + [_vp],
     "wkv6_ctas_per_sm": [_ci]},
    kernels=("wkv6",))
_BWD = kbuild.Library(
    "wkv6_bwd", "wkv6_bwd_error_string",
    {"wkv6_bwd_dstate": [_vp] * 6 + [_ci] * 4 + [_vp],
     "wkv6_bwd": [_vp] * 13 + [_ci] * 4 + [_vp],
     "wkv6_bwd_attr": [_ci, _ci]},
    kernels=("wkv6_bwd_dstate", "wkv6_bwd"))


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
    return _LIB.query("wkv6_ctas_per_sm", _DTYPES[dtype])


def bwd_attrs(which: int) -> dict:
    """What the backward's pass 1 (``which`` = 1, a CTA per (batch, head,
    16 rows of the state)) or pass 2 (2, a CTA per (batch, head, chunk))
    takes on the current card: {"ctas_per_sm", "registers", "smem_bytes"
    (a CTA's, static and dynamic), "threads" (a CTA's)}; builds the
    kernels, launches nothing."""
    return {key: _BWD.query("wkv6_bwd_attr", which, what)
            for what, key in enumerate(("ctas_per_sm", "registers",
                                        "smem_bytes", "threads"))}


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
    if len(devs) != 1 or r.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"wkv6: every operand must be on one cpu, cuda or "
                         f"meta device, got {sorted(map(str, devs))}")
    if min(B, S, H, N) < 1:
        raise ValueError(f"wkv6: empty operands {tuple(r.shape)}")


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
         chunk: int = KERNEL_CHUNK,
         chunk_states: Optional[torch.Tensor] = None) -> torch.Tensor:
    """WKV6 over r/k/v/logw (B, S, H, N) from ``state`` (B, H, N, N) f32,
    which ends holding the final state; returns y (B, S, H, N) in r's
    dtype; ``u`` is (H, N), the bonus of each head.  ``chunk_states``, a
    contiguous f32 (B, H, n_chunks(S), N, N) CUDA tensor, also receives
    the state at the start of each of the kernel's chunks (for
    :func:`wkv6_backward`)."""
    _check_operands(r, k, v, logw, u, state)
    if chunk_states is not None:
        B, S, H, N = r.shape
        if (chunk_states.device != r.device or r.device.type != "cuda"
                or tuple(chunk_states.shape) != (B, H, n_chunks(S), N, N)
                or chunk_states.dtype != torch.float32
                or not chunk_states.is_contiguous()):
            raise ValueError(
                f"wkv6: chunk_states must be a contiguous float32 CUDA "
                f"tensor {(B, H, n_chunks(S), N, N)} beside CUDA operands, "
                f"got {chunk_states.dtype} {tuple(chunk_states.shape)} on "
                f"{chunk_states.device}")
    if r.device.type in ("cpu", "meta"):
        # the plain version (shapes only on meta: ref.py's meta ops)
        y, new = (torch.ops.repro_torch.wkv6(r, k, v, logw, u, state)
                  if r.device.type == "meta" else
                  ref.wkv6_chunked(r, k, v, logw, u, state, chunk))
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
            None if chunk_states is None else chunk_states.data_ptr(),
            _DTYPES[r.dtype], B, S, H, N,
            r.stride(0), r.stride(1), r.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            lw.stride(0), lw.stride(1), lw.stride(2),
            torch.cuda.current_stream().cuda_stream)
    return y


def wkv6_backward_dstates(r: torch.Tensor, logw: torch.Tensor,
                          dy: torch.Tensor,
                          dstate: Optional[torch.Tensor] = None):
    """Pass 1 of :func:`wkv6_backward`: (dstates (B, H, n_chunks, N, N),
    the gradient of the state after each chunk, whose last entry is
    ``dstate`` (None = 0); dstate0 (B, H, N, N)), f32, from r, logw and dy
    (B, S, H, N), at the kernel's chunk of 32.  A CPU tensor takes
    ``ref.wkv6_chunk_dstates``; a CUDA one launches
    ``wkv6_bwd_dstate``."""
    B, S, H, N = r.shape
    if tuple(logw.shape) != (B, S, H, N) or tuple(dy.shape) != (
            B, S, H, N) or (dstate is not None and tuple(dstate.shape) != (
                B, H, N, N)) or len({t.device for t in (r, logw, dy)}) != 1:
        raise ValueError(f"wkv6_backward_dstates: logw {tuple(logw.shape)}, "
                         f"dy {tuple(dy.shape)}, dstate do not match r "
                         f"{tuple(r.shape)} on one device")
    if r.device.type == "cpu":
        return ref.wkv6_chunk_dstates(r, logw, dy, dstate, KERNEL_CHUNK)
    r, lw, dy = kbuild.bwd_operands(
        "wkv6_backward_dstates", (r, logw, dy), {"head size": N},
        MAX_HEAD_SIZE)
    ds = None if dstate is None else dstate.float().contiguous()
    dstates = torch.empty((B, H, n_chunks(S), N, N), dtype=torch.float32,
                          device=r.device)
    ds0 = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        _BWD.launch(
            "wkv6_bwd_dstate", "wkv6_bwd_dstate",
            r.data_ptr(), lw.data_ptr(), dy.data_ptr(),
            None if ds is None else ds.data_ptr(), dstates.data_ptr(),
            ds0.data_ptr(), B, S, H, N,
            torch.cuda.current_stream().cuda_stream)
    return dstates, ds0


def wkv6_backward_chunks(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         logw: torch.Tensor, u: torch.Tensor,
                         chunk_states: torch.Tensor, dstates: torch.Tensor,
                         dy: torch.Tensor):
    """Pass 2 of :func:`wkv6_backward`: every chunk's gradients from its
    start state (``chunk_states``, the forward's) and the gradient after it
    (``dstates``, pass 1's), both (B, H, n_chunks, N, N): (dr, dk, dv,
    dlogw (B, S, H, N), du (B, H, n_chunks, N), each chunk's part), f32, at
    the kernel's chunk of 32.  A CPU tensor takes ``ref.wkv6_chunk_grads``;
    a CUDA one launches ``wkv6_bwd``."""
    B, S, H, N = r.shape
    if not (r.shape == k.shape == v.shape == logw.shape == dy.shape) or \
            tuple(u.shape) != (H, N) or \
            len({t.device for t in (r, k, v, logw, u, dy)}) != 1:
        raise ValueError(f"wkv6_backward_chunks: r, k, v, logw, dy must be "
                         f"one (B, S, H, N) shape and u (H, N) on one "
                         f"device, got {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(logw.shape)}, "
                         f"{tuple(dy.shape)}, {tuple(u.shape)}")
    if r.device.type == "cpu":
        return ref.wkv6_chunk_grads(r, k, v, logw, u, chunk_states, dstates,
                                    dy, KERNEL_CHUNK)
    want = (B, H, n_chunks(S), N, N)
    kbuild.check_states(
        "wkv6_backward_chunks", chunk_states, want, r.device,
        "the forward's chunk states (wkv6(..., chunk_states=))")
    kbuild.check_states(
        "wkv6_backward_chunks", dstates, want, r.device,
        "pass 1's state gradients (wkv6_backward_dstates)")
    r, k, v, lw, u, dy, cs, ds = kbuild.bwd_operands(
        "wkv6_backward_chunks",
        (r, k, v, logw, u, dy, chunk_states, dstates), {"head size": N},
        MAX_HEAD_SIZE)
    dr, dk, dv, dlw = (torch.empty((B, S, H, N), dtype=torch.float32,
                                   device=r.device) for _ in range(4))
    du = torch.empty((B, H, n_chunks(S), N), dtype=torch.float32,
                     device=r.device)
    with torch.cuda.device(r.device):
        _BWD.launch(
            "wkv6_bwd", "wkv6_bwd",
            r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
            u.data_ptr(), cs.data_ptr(), ds.data_ptr(), dy.data_ptr(),
            dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dlw.data_ptr(),
            du.data_ptr(), B, S, H, N,
            torch.cuda.current_stream().cuda_stream)
    return dr, dk, dv, dlw, du


def wkv6_backward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  logw: torch.Tensor, u: torch.Tensor, state0: torch.Tensor,
                  dy: torch.Tensor, dstate: Optional[torch.Tensor] = None,
                  chunk_states: Optional[torch.Tensor] = None,
                  chunk: int = KERNEL_CHUNK):
    """The gradient of :func:`wkv6` from ``state0``, given dy (B, S, H, N)
    and the final state's ``dstate`` (None = 0): (dr, dk, dv, dlogw (B, S,
    H, N), du (H, N), dstate0 (B, H, N, N)), f32.  A CPU tensor takes
    ``ref.wkv6_chunked_backward`` at ``chunk``; a CUDA one launches the
    backward's two passes (fp32 only), which read ``chunk_states``, the
    forward's (:func:`wkv6`), in place of ``state0``, and sums pass 2's
    du over the batch and the chunks."""
    _check_operands(r, k, v, logw, u, state0)
    B, S, H, N = r.shape
    if tuple(dy.shape) != (B, S, H, N) or dy.device != r.device or (
            dstate is not None and (tuple(dstate.shape) != (B, H, N, N)
                                    or dstate.device != r.device)):
        raise ValueError(f"wkv6_backward: dy must be {(B, S, H, N)} and "
                         f"dstate {(B, H, N, N)} on {r.device}, got "
                         f"{tuple(dy.shape)} and "
                         f"{None if dstate is None else tuple(dstate.shape)}")
    if r.device.type == "meta":
        return torch.ops.repro_torch.wkv6_backward(r, k, v, logw, u, state0,
                                                   dy, dstate)
    if r.device.type == "cpu":
        return ref.wkv6_chunked_backward(r, k, v, logw, u, state0, dy,
                                         dstate, chunk)
    kbuild.check_states(
        "wkv6_backward", chunk_states, (B, H, n_chunks(S), N, N), r.device,
        "the forward's chunk states (wkv6(..., chunk_states=))")
    r, k, v, lw, u, dy = kbuild.bwd_operands(
        "wkv6_backward", (r, k, v, logw, u, dy), {"head size": N},
        MAX_HEAD_SIZE)
    dstates, ds0 = wkv6_backward_dstates(r, lw, dy, dstate)
    dr, dk, dv, dlw, du = wkv6_backward_chunks(r, k, v, lw, u, chunk_states,
                                               dstates, dy)
    return dr, dk, dv, dlw, du.sum((0, 2)), ds0


class WKV6(torch.autograd.Function):
    """Differentiable :func:`wkv6`: ``WKV6.apply(r, k, v, logw, u, state0,
    chunk=32)`` -> (y, final state), writing no buffer of the caller's
    (``state0`` is read, the final state is a new tensor).  On the card
    the forward kernel also writes its chunk states when a gradient is
    needed, and the backward kernel reads them; on the CPU both are the
    plain versions at ``chunk``."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, state0, chunk: int = KERNEL_CHUNK):
        ctx.set_materialize_grads(False)
        state = state0.detach().float().clone()
        B, S, H, N = r.shape
        states = None
        if r.device.type == "cuda" and any(ctx.needs_input_grad[:6]):
            states = torch.empty((B, H, n_chunks(S), N, N),
                                 dtype=torch.float32, device=r.device)
        y = wkv6(r, k, v, logw, u, state, chunk=chunk, chunk_states=states)
        ctx.save_for_backward(r, k, v, logw, u, state0, states)
        ctx.chunk = chunk
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, logw, u, state0, states = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(r.shape, dtype=torch.float32, device=r.device)
        grads = wkv6_backward(r, k, v, logw, u, state0, dy.float(), dstate,
                              chunk_states=states, chunk=ctx.chunk)
        return (*(g.to(t.dtype) for g, t in zip(
            grads, (r, k, v, logw, u, state0))), None)


def flops(B: int, S: int, H: int, N: int, chunk: int = KERNEL_CHUNK) -> int:
    """The forward's products in the chunked form (a multiply-add counts
    2), per chunk and head: (r exp(cum_prev)) S and the state update (C
    N^2 multiply-adds each), the strictly-lower pairwise decayed products
    and their product with v (C(C-1)/2 N each), the bonus (2 C N)."""
    C, nc = chunk, -(-S // chunk)
    pairs = C * (C - 1) // 2
    return 2 * B * H * nc * (2 * C * N * N + 2 * pairs * N + 2 * C * N)


def bwd_flops(B: int, S: int, H: int, N: int,
              chunk: int = KERNEL_CHUNK) -> int:
    """The backward's products, per chunk and head: the four (C, N) x
    (N, N) products (v dS^T, dy S^T, kd dS, rd^T dy), the lower triangle
    of dy v^T and of A^T dy ((C(C-1)/2 + C) N each), and for the
    strictly-lower pairs A and the two pairwise sums of dr and dk."""
    C, nc = chunk, -(-S // chunk)
    pairs, vis = C * (C - 1) // 2, C * (C + 1) // 2
    return 2 * B * H * nc * (4 * C * N * N + 2 * vis * N + 3 * pairs * N)
