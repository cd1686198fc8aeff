"""Wrappers of the blockwise quantize codec kernels (csrc/polyline_codec.cu).

compress_blocks:   x (n,) f32 -> q (ceil(n/256), 256) int8|int16,
                   scale (ceil(n/256), 1) f32
decompress_blocks: (q, scale, n) -> x (n,) f32

The port of ``repro/kernels/polyline_codec.py``.  A tensor on the CPU takes
the plain version (kernels/ref.py); a CUDA tensor launches the hand-written
Hopper kernel or raises, with no fallback.  Each wrapper counts its kernel
launches (``launch_counts``), so a run can show that its main path went
through the kernels.

The kernels are compiled at first use with ``nvcc`` into
``build/repro_torch_kernels/`` at the repository root (a plain C interface
loaded with ``ctypes``), keyed by a hash of the source and flags.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels import ref

BLOCK = ref.BLOCK
SOURCE = Path(__file__).resolve().parent / "csrc" / "polyline_codec.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel name -> launches since the last reset (CUDA launches only)
_LAUNCHES: Dict[str, int] = {"compress": 0, "decompress": 0}
#: what the last build did: {"path", "seconds", "log"} (seconds 0 if cached)
BUILD_INFO: Dict[str, object] = {}


def launch_counts() -> Dict[str, int]:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    nvcc = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the codec "
                           "kernels are built from source at first use")
    return nvcc


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """Build (once per source/flags hash) and load the kernel library."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libpolyline_codec_{tag}.so"
    t0 = time.perf_counter()
    log = ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                               str(SOURCE)], capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, out)   # atomic: concurrent builders race safely
    BUILD_INFO.update(path=str(out), seconds=time.perf_counter() - t0,
                      log=log)
    lib = ctypes.CDLL(str(out))
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.codec_compress.argtypes = [vp, ll, vp, vp, ci, vp]
    lib.codec_compress.restype = ci
    lib.codec_decompress.argtypes = [vp, vp, ll, vp, ci, vp]
    lib.codec_decompress.restype = ci
    lib.codec_error_string.argtypes = [ci]
    lib.codec_error_string.restype = ctypes.c_char_p
    return lib


def build() -> Dict[str, object]:
    """Compile and load the kernels now (they are otherwise built at first
    launch); returns :data:`BUILD_INFO`."""
    _lib()
    return dict(BUILD_INFO)


def _check(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().codec_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


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
            rc = _lib().codec_compress(
                x.data_ptr(), n, q.data_ptr(), scale.data_ptr(), bits,
                torch.cuda.current_stream().cuda_stream)
        _check(rc, "compress")
        _LAUNCHES["compress"] += 1
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
            rc = _lib().codec_decompress(
                q.data_ptr(), scale.data_ptr(), n, out.data_ptr(), bits,
                torch.cuda.current_stream().cuda_stream)
        _check(rc, "decompress")
        _LAUNCHES["decompress"] += 1
    return out
