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
padded inside the kernel, up to 128.

A tensor on the CPU takes the plain version (kernels/ref.py
``blocked_attention``, the same CPU path as ``ops.attention``); a CUDA
tensor launches the kernel or raises, with no fallback.  CUDA launches are counted (:func:`launch_counts`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ref

MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: CUDA launches since the last reset
_LAUNCHES: Dict[str, int] = {"flash_attention": 0}


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    _LAUNCHES["flash_attention"] = 0


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel library (csrc/flash_attention.cu), built at first use."""
    lib = kbuild.library("flash_attention")
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_fwd.argtypes = (
        [vp, vp, vp, vp] + [ci] * 7 + [ll] * 9
        + [ci, ci, ctypes.c_float, vp])
    lib.flash_attention_fwd.restype = ci
    lib.flash_attention_error_string.argtypes = [ci]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None
                    ) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, T, KV, hd) with H % KV == 0 -> (B, S, H, hd).

    Keys at or past T are masked; with ``causal`` key t is visible to query
    s iff t <= s, with ``window`` iff s - t < window (positions count from
    0 on both sides)."""
    _check_operands(q, k, v)
    if q.device.type == "cpu":
        return ref.blocked_attention(q, k, v, causal=causal, window=window)
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention supports head_dim <= "
                         f"{MAX_HEAD_DIM}, got {hd}")
    if B * H > 65535:
        raise ValueError(f"flash_attention supports B*H <= 65535, got "
                         f"{B * H}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention: the last dim of q, k and v must "
                         "have stride 1")
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = _lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, S, T, H, KV, hd,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(causal), int(window or 0), 1.0 / (hd ** 0.5),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = _lib().flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc} ({msg})")
    _LAUNCHES["flash_attention"] += 1
    return out

