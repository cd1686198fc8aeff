"""Wrappers of the blockwise quantize codec kernels (csrc/polyline_codec.cu).

compress_blocks:   x (n,) f32 -> q (ceil(n/256), 256) int8|int16,
                   scale (ceil(n/256), 1) f32
decompress_blocks: (q, scale, n) -> x (n,) f32

The port of ``repro/kernels/polyline_codec.py``.  A tensor on the CPU takes
the plain version (kernels/ref.py); a CUDA tensor launches the hand-written
Hopper kernel or raises, with no fallback.  Each wrapper counts its kernel
launches (``launch_counts``), so a run can show that its main path went
through the kernels.

The kernels are compiled at first use with ``nvcc`` (kernels/build.py).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ref

BLOCK = ref.BLOCK

_vp, _ci, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LIB = kbuild.Library(
    "polyline_codec", "codec_error_string",
    {"codec_compress": [_vp, _ll, _vp, _vp, _ci, _vp],
     "codec_decompress": [_vp, _vp, _ll, _vp, _ci, _vp]},
    kernels=("compress", "decompress"))
launch_counts = _LIB.launch_counts
reset_launch_counts = _LIB.reset_launch_counts


def _check_bits(bits: int) -> None:
    if not 2 <= bits <= 16:
        raise ValueError(f"codec supports 2..16 bits, got {bits}")


def _check_device(t: torch.Tensor, what: str) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: tensors must be on cpu or cuda, "
                         f"got {t.device}")


def compress_blocks(x: torch.Tensor, bits: int = 8):
    """x: flat contiguous float32 (n,) -> (q, scale); see module doc."""
    _check_bits(bits)
    _check_device(x, "compress_blocks")
    if x.dim() != 1 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"compress_blocks takes a flat contiguous float32 "
                         f"tensor, got shape {tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        return ref.compress_blocks(x, bits)
    n = x.numel()
    nb = -(-n // BLOCK)
    q = torch.empty((nb, BLOCK), dtype=ref.code_dtype(bits), device=x.device)
    scale = torch.empty((nb, 1), dtype=torch.float32, device=x.device)
    if nb:
        with torch.cuda.device(x.device):
            _LIB.launch(
                "compress", "codec_compress",
                x.data_ptr(), n, q.data_ptr(), scale.data_ptr(), bits,
                torch.cuda.current_stream().cuda_stream)
    return q, scale


def decompress_blocks(q: torch.Tensor, scale: torch.Tensor, n: int
                      ) -> torch.Tensor:
    """(q, scale) from :func:`compress_blocks` -> the first ``n`` values."""
    _check_device(q, "decompress_blocks")
    nb = q.shape[0]
    if (q.dim() != 2 or q.shape[1] != BLOCK
            or q.dtype not in (torch.int8, torch.int16)
            or scale.shape != (nb, 1) or scale.dtype != torch.float32
            or scale.device != q.device
            or not (q.is_contiguous() and scale.is_contiguous())
            or not 0 <= n <= nb * BLOCK or -(-n // BLOCK) != nb):
        raise ValueError(
            f"decompress_blocks: bad operands q {tuple(q.shape)} {q.dtype} "
            f"on {q.device}, scale {tuple(scale.shape)} {scale.dtype} on "
            f"{scale.device}, n={n}")
    if q.device.type == "cpu":
        return ref.decompress_blocks(q, scale, n)
    out = torch.empty((n,), dtype=torch.float32, device=q.device)
    if nb:
        bits = 8 if q.dtype == torch.int8 else 16
        with torch.cuda.device(q.device):
            _LIB.launch(
                "decompress", "codec_decompress",
                q.data_ptr(), scale.data_ptr(), n, out.data_ptr(), bits,
                torch.cuda.current_stream().cuda_stream)
    return out
