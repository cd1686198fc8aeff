"""Wrapper of the flash attention kernel (csrc/flash_attention.cu).

    flash_attention(q (B, S, H, hd), k/v (B, T, KV, hd)) -> (B, S, H, hd)

The port of ``repro/kernels/flash_attention.py`` together with the layout
work of ``repro/kernels/ops.py:flash_attention``: causal or sliding-window
softmax attention, GQA with query head ``h`` reading KV head ``h // G``
(``G = H // KV``, the kv-major grouping ``jnp.repeat(k, G, axis=2)``
gives), scale ``1/sqrt(hd)``, fp32 logits and accumulation on fp32 or
bf16 inputs, output in the input type.

Layout the kernel takes: q, k and v in the (B, S|T, heads, hd) layout with
any strides whose last one is 1 (so the (B, S, kv, G, hd) -> (B, S, H, hd)
reshape of a projection is read in place, and K/V are never repeated in
memory); the output is a new contiguous (B, S, H, hd) tensor.  hd is
padded inside the kernel, up to 128.  fp32 runs on the CUDA cores (FFMA);
bf16 runs on the tensor cores, its tiles loaded by TMA, which needs
16-byte-aligned data pointers and strides that are multiples of 8
elements in the batch, sequence and head dims (:func:`check_cuda_operands`
raises for any other bf16 operand).

Training: :class:`FlashAttention` is the autograd function over the
kernel.  Its forward asks the kernel for each row's log-sum-exp as well
(:func:`flash_attention` with ``return_lse``); its backward is the
hand-written backward kernel (csrc/flash_attention_bwd.cu, wrapped by
:func:`flash_attention_backward`), which recomputes P from q, k and the
log-sum-exp: bf16 on the tensor cores (wgmma, fed by TMA; a bf16 dO that
TMA cannot read is copied first, counted by :func:`layout_copy_counts`),
fp32 in 3xTF32 on ``mma.sync``.  The JAX package has no backward kernel
(off the TPU it differentiates ``repro/kernels/ops.py``
``blocked_attention``).

A tensor on the CPU takes the plain versions (kernels/ref.py
``blocked_attention`` and ``blocked_attention_backward``); a CUDA tensor
launches the kernels or raises, with no fallback.  CUDA launches are
counted: ``flash_attention`` per forward (:func:`launch_counts`),
``flash_attention_bwd`` per backward (one C call that launches its three
kernels; ``repro_torch.kernels.launch_counts`` gathers both).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ref

MAX_HEAD_DIM = 128
QUERY_TILE = 128   # query rows per CTA, both designs
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_vp, _ci, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LIB = kbuild.Library(
    "flash_attention", "flash_attention_error_string",
    {"flash_attention_fwd": [_vp] * 4 + [_ci] * 7 + [_ll] * 9
     + [_ci, _ci, ctypes.c_float, _vp, _vp]},
    kernels=("flash_attention",))
_BWD = kbuild.Library(
    "flash_attention_bwd", "flash_attention_bwd_error_string",
    {"flash_attention_bwd": [_vp] * 10 + [_ci] * 7 + [_ll] * 12
     + [_ci, _ci, ctypes.c_float, _ci, _vp],
     "flash_attention_bwd_ctas_per_sm": [_ci, _ci, _ci]},
    kernels=("flash_attention_bwd",))
launch_counts = _LIB.launch_counts
reset_launch_counts = _LIB.reset_launch_counts
#: rows a CTA of the backward's dK/dV and dQ kernels owns: keys of one KV
#: head (its two halves split the products), query rows of one head (one
#: 16- or 64-row block per warp or warpgroup); both stream 64-row tiles
BWD_TILES = {"dkdv": 64, "dq": 128}
#: the backward's kernels, as ``flash_attention_backward(only=...)`` names
#: them, and the bit of each in the C entry point's ``which``
BWD_KERNELS = {"delta": 1, "dkdv": 2, "dq": 4}
_BWD_ALL = 7
#: dO tensors the backward copied into a TMA-readable layout (bf16 only)
_COPIES = {"flash_attention_bwd_dout": 0}


def layout_copy_counts():
    """Operands the kernels' wrappers copied into a layout the kernel can
    read since the last reset (a layout step, not a launch)."""
    return dict(_COPIES)


def reset_layout_copy_counts() -> None:
    for k in _COPIES:
        _COPIES[k] = 0


def bwd_ctas_per_sm(dtype: torch.dtype, hd: int, which: str) -> int:
    """CTAs of the backward's ``"dkdv"`` or ``"dq"`` kernel for ``dtype``
    and head dim ``hd`` that fit on one SM of the current card; builds the
    kernel, launches nothing."""
    return _BWD.query("flash_attention_bwd_ctas_per_sm", _DTYPES[dtype],
                      hd, ("dkdv", "dq").index(which))


def bwd_grids(B: int, S: int, T: int, H: int, KV: int):
    """The launch grids of the backward's dK/dV and dQ kernels (both
    dtypes): one CTA per (batch, KV head, 64 keys) and per (batch, head,
    128 query rows)."""
    return {"dkdv": (B * KV, -(-T // BWD_TILES["dkdv"])),
            "dq": (B * H, -(-S // BWD_TILES["dq"]))}


def _check_operands(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention takes q (B, S, H, hd) and k/v "
                         f"(B, T, KV, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd
            or KV < 1 or H % KV):
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)} "
                         f"(need equal B and hd, and H % KV == 0)")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention takes float32 or bfloat16 q, k, v "
                         f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device) or q.device.type not in (
            "cpu", "cuda"):
        raise ValueError(f"flash_attention: q, k, v must be on one cpu or "
                         f"cuda device, got {q.device}, {k.device}, "
                         f"{v.device}")
    if min(B, S, T, H) < 1:
        raise ValueError(f"flash_attention: empty operands {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")


def tma_readable(x: torch.Tensor) -> bool:
    """Whether TMA can load tiles of the (B, S, heads, hd) tensor ``x``: a
    16-byte-aligned data pointer, unit stride in the last dim, and strides
    that are multiples of 8 elements (16 bf16 bytes) in the batch,
    sequence and head dims (a dim of size 1 is never stepped)."""
    return (x.data_ptr() % 16 == 0 and x.stride(-1) == 1
            and all(x.shape[d] == 1 or x.stride(d) % 8 == 0
                    for d in range(3)))


def dout_for_kernel(dout: torch.Tensor) -> torch.Tensor:
    """The backward's dO as its kernels read it: a bf16 ``dout`` that TMA
    cannot read (:func:`tma_readable`) is copied into rows padded to a
    multiple of 8 elements, and the copy counted in
    :func:`layout_copy_counts`; any other is returned as it is."""
    if dout.dtype != torch.bfloat16 or tma_readable(dout):
        return dout
    hd = dout.shape[-1]
    buf = torch.empty(*dout.shape[:-1], -(-hd // 8) * 8, dtype=dout.dtype,
                      device=dout.device)[..., :hd]
    buf.copy_(dout)
    _COPIES["flash_attention_bwd_dout"] += 1
    return buf


def check_cuda_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window: Optional[int] = None) -> None:
    """What the kernel takes beyond :func:`_check_operands`; raises
    ValueError naming the rule an operand breaks.  Reads shapes, strides,
    dtypes and data pointers only, so it runs on CPU tensors too."""
    B, S, H, hd = q.shape
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention supports head_dim <= "
                         f"{MAX_HEAD_DIM}, got {hd}")
    if -(-S // QUERY_TILE) > 65535:
        raise ValueError(f"flash_attention supports S <= "
                         f"{65535 * QUERY_TILE}, got {S}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention: the last dim of q, k and v must "
                         "have stride 1")
    if q.dtype != torch.bfloat16:
        return
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(
                f"flash_attention bf16 (TMA): {name}'s data pointer must be "
                f"16-byte aligned, got {x.data_ptr():#x}")
        if any(x.shape[d] > 1 and x.stride(d) % 8 for d in range(3)):
            raise ValueError(
                f"flash_attention bf16 (TMA): {name}'s strides in the batch, "
                f"sequence and head dims must be multiples of 8 elements (16 "
                f"bytes); got stride {x.stride()} for shape "
                f"{tuple(x.shape)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    return_lse: bool = False):
    """q: (B, S, H, hd); k/v: (B, T, KV, hd) with H % KV == 0 -> (B, S, H, hd).

    Keys at or past T are masked; with ``causal`` key t is visible to query
    s iff t <= s, with ``window`` iff s - t < window (positions count from
    0 on both sides).  ``return_lse`` also returns each row's float32
    log-sum-exp, (B, H, S), -inf for a row that sees no key.  No gradient:
    :class:`FlashAttention` is the differentiable form."""
    _check_operands(q, k, v)
    if q.device.type == "cpu":
        return ref.blocked_attention(q, k, v, causal=causal, window=window,
                                     return_lse=return_lse)
    check_cuda_operands(q, k, v, window)
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    with torch.cuda.device(q.device):
        _LIB.launch(
            "flash_attention", "flash_attention_fwd",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, S, T, H, KV, hd,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(causal), int(window or 0), 1.0 / (hd ** 0.5),
            None if lse is None else lse.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    return (out, lse) if return_lse else out


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, out: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor,
                             causal: bool = True,
                             window: Optional[int] = None, *,
                             only: Optional[str] = None):
    """(dq, dk, dv) of :func:`flash_attention` from its output ``out``
    (contiguous (B, S, H, hd)), its ``lse`` ((B, H, S) float32) and the
    output's gradient ``dout`` (any strides whose last one is 1), in the
    dtypes and shapes of q, k, v (new contiguous tensors).

    A bf16 ``dout`` that TMA cannot read (:func:`tma_readable`) is copied
    into one it can first, counted in :func:`layout_copy_counts`.
    ``only`` (CUDA only; one of :data:`BWD_KERNELS`) launches just that one
    of the three kernels, to time the parts of a call: it counts no
    launch, the outputs it does not write come back uninitialised, and
    "dkdv" and "dq" read D (of no call: a scratch) as they find it."""
    _check_operands(q, k, v)
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if (out.shape != q.shape or dout.shape != q.shape
            or lse.shape != (B, H, S) or out.dtype != q.dtype
            or dout.dtype != q.dtype or lse.dtype != torch.float32):
        raise ValueError(
            f"flash_attention_backward: out {tuple(out.shape)} {out.dtype}, "
            f"dout {tuple(dout.shape)} {dout.dtype} and lse "
            f"{tuple(lse.shape)} {lse.dtype} must be q's shape and dtype "
            f"and (B, H, S) float32 for q {tuple(q.shape)} {q.dtype}")
    if only is not None and (only not in BWD_KERNELS
                             or q.device.type != "cuda"):
        raise ValueError(f"flash_attention_backward: only must be one of "
                         f"{sorted(BWD_KERNELS)}, on CUDA tensors; got "
                         f"{only!r} on {q.device}")
    if q.device.type == "cpu":
        return ref.blocked_attention_backward(q, k, v, out, lse, dout,
                                              causal=causal, window=window)
    check_cuda_operands(q, k, v, window)   # what the forward took
    if (-(-S // BWD_TILES["dq"]) > 65535
            or -(-T // BWD_TILES["dkdv"]) > 65535):
        raise ValueError(f"flash_attention_backward supports S <= "
                         f"{65535 * BWD_TILES['dq']} and T <= "
                         f"{65535 * BWD_TILES['dkdv']}, got {S}, {T}")
    if (dout.stride(-1) != 1 or not out.is_contiguous()
            or not lse.is_contiguous()):
        raise ValueError("flash_attention_backward: the last dim of dout "
                         "must have stride 1, out and lse must be "
                         "contiguous")
    if not all(x.device == q.device for x in (out, lse, dout)):
        raise ValueError("flash_attention_backward: all operands must be on "
                         f"{q.device}")
    dout = dout_for_kernel(dout)
    dq = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, T, KV, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    call = (_BWD.launch if only is None else
            lambda _kernel, fn, *a: _BWD.call(fn, *a))
    with torch.cuda.device(q.device):
        call(
            "flash_attention_bwd", "flash_attention_bwd",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            _DTYPES[q.dtype], B, S, T, H, KV, hd,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            dout.stride(0), dout.stride(1), dout.stride(2),
            int(causal), int(window or 0), 1.0 / (hd ** 0.5),
            _BWD_ALL if only is None else BWD_KERNELS[only],
            torch.cuda.current_stream().cuda_stream)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable :func:`flash_attention`: the forward kernel with its
    log-sum-exp, and the backward kernel for (dq, dk, dv).  On CPU tensors
    both are the plain versions.  ``FlashAttention.apply(q, k, v, causal,
    window)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True,
                window: Optional[int] = None):
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, lse, dout, causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None
