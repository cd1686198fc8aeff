"""Build and load the port's CUDA kernels: ``nvcc`` -> shared library ->
``ctypes``.

Each source under ``csrc/`` has a plain C interface and is compiled at
first use for ``sm_90a`` into ``build/repro_torch_kernels/`` at the
repository root (a git-ignored directory), under a name keyed by a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source or header is rebuilt and an unchanged one is loaded as it
is.  The output is renamed into place atomically, so
processes that build at once race safely.  :func:`build` compiles several
sources in parallel, one ``nvcc`` process each, all started together.

:class:`Library` is what a kernel wrapper holds: the library's C
functions bound at first call, the check of the CUDA error code each
returns, and the launch count of each kernel, which
:func:`launch_counts` gathers over every library.  :func:`bwd_operands`
and :func:`check_states` are the operand checks that the two chunk
scans' backward wrappers (kernels/rwkv6_scan.py, kernels/ssd.py) share
before they launch.  :func:`bound` is the least time the card could take
for a launch's bytes and products, at the H100's rates below; each
kernel module counts its own products (``flops``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: the card's rates: NVIDIA H100 SXM data sheet, dense (no sparsity)
HBM_BYTES_PER_S = 3.35e12      # device memory
FP32_OPS_PER_S = 67e12         # fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # bf16 tensor cores
TF32_OPS_PER_S = 495e12        # TF32 tensor cores

#: source stem -> what its build did: {"path", "seconds", "log"}
#: (seconds 0 and an empty log when an earlier build was reused)
BUILD_INFO: Dict[str, Dict[str, object]] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: the launch counts of every :class:`Library`
_COUNTS: List[Dict[str, int]] = []


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    nvcc = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels are built from source at first use")
    return nvcc


def _target(name: str) -> Path:
    # the shared headers are part of every source's key
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{tag}.so"


def build(*names: str) -> Dict[str, Dict[str, object]]:
    """Compile (where not yet built) and load ``csrc/<name>.cu`` for each
    name, all ``nvcc`` runs in parallel; returns their :data:`BUILD_INFO`."""
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        procs = {}
        t0 = time.perf_counter()
        for n in todo:
            out = _target(n)
            if out.exists():
                BUILD_INFO[n] = {"path": str(out), "seconds": 0.0, "log": ""}
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            procs[n] = (out, tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for n, (out, tmp, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{n}.cu ({proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)   # atomic: concurrent builds race safely
            BUILD_INFO[n] = {"path": str(out),
                             "seconds": time.perf_counter() - t0, "log": log}
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for n in todo:
            _LIBS[n] = ctypes.CDLL(BUILD_INFO[n]["path"])
    return {n: dict(BUILD_INFO[n]) for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first call."""
    if name not in _LIBS:
        build(name)
    return _LIBS[name]


def sources():
    """Stems of every CUDA source of the port."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


class Library:
    """``csrc/<name>.cu`` bound through ctypes at first call, and the CUDA
    launch counts of its kernels.

    ``functions`` maps each C entry point to its argument types; every one
    returns a CUDA error code (0 on success), which ``error_fn`` turns
    into its message.  ``kernels`` names the launch counters."""

    def __init__(self, name: str, error_fn: str,
                 functions: Dict[str, Sequence[type]],
                 kernels: Sequence[str]):
        self.name = name
        self._error_fn = error_fn
        self._functions = functions
        self._counts = dict.fromkeys(kernels, 0)
        _COUNTS.append(self._counts)
        self._lib = None

    def _bound(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = library(self.name)
            for fn, argtypes in self._functions.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, self._error_fn).argtypes = [ctypes.c_int]
            getattr(lib, self._error_fn).restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, kernel: str, fn: str, *args) -> None:
        """Call ``fn(*args)`` and count one launch of ``kernel``; raise
        RuntimeError, counting nothing, if it returns a CUDA error."""
        self.call(fn, *args, what=f"{kernel} kernel launch")
        self._counts[kernel] += 1

    def call(self, fn: str, *args, what: str = "") -> None:
        """Call ``fn(*args)``, counting no launch; raise RuntimeError if it
        returns a CUDA error."""
        lib = self._bound()
        rc = getattr(lib, fn)(*args)
        if rc != 0:
            msg = getattr(lib, self._error_fn)(rc).decode()
            raise RuntimeError(f"{what or fn} failed: CUDA error {rc} "
                               f"({msg})")

    def query(self, fn: str, *args) -> int:
        """Call ``fn(*args)``, a C function that launches nothing and
        returns an int (an occupancy, say); a negative value is a CUDA
        error, raised with its message."""
        lib = self._bound()
        rc = getattr(lib, fn)(*args)
        if rc < 0:
            msg = getattr(lib, self._error_fn)(-rc).decode()
            raise RuntimeError(f"{fn} failed: CUDA error {-rc} ({msg})")
        return rc

    def launch_counts(self) -> Dict[str, int]:
        return dict(self._counts)

    def reset_launch_counts(self) -> None:
        for k in self._counts:
            self._counts[k] = 0


def launch_counts() -> Dict[str, int]:
    """CUDA launches of every kernel since the last reset."""
    return {k: n for counts in _COUNTS for k, n in counts.items()}


def reset_launch_counts() -> None:
    for counts in _COUNTS:
        for k in counts:
            counts[k] = 0


def bwd_operands(name: str, ts, dims: Dict[str, int], limit: int):
    """``ts`` made contiguous for the backward kernels; raises unless every
    one is float32 and every size in ``dims`` ({what: size}) is at most
    ``limit``."""
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError(f"{name}: the backward kernels are fp32 only "
                         f"(training is fp32), got "
                         f"{[str(t.dtype) for t in ts]}")
    if max(dims.values()) > limit:
        raise ValueError(f"{name} supports {' and '.join(dims)} <= {limit}, "
                         f"got {' and '.join(map(str, dims.values()))}")
    return [t.contiguous() for t in ts]


def check_states(name: str, states, want, device, what: str) -> None:
    """Raises unless ``states`` is a float32 tensor of shape ``want`` on
    ``device``; ``what`` names the tensor the card reads there."""
    if states is None or tuple(states.shape) != want or \
            states.dtype != torch.float32 or states.device != device:
        got = None if states is None else (states.dtype,
                                             tuple(states.shape))
        raise ValueError(f"{name} on the card reads {what}: pass the float32 "
                         f"{want} tensor, got {got}")


def bound(nbytes: int, flops: int, dtype: str) -> dict:
    """The least time for moving ``nbytes`` and computing ``flops`` at the
    card's rate for ``dtype`` outside the tensor cores (fp32) or on them
    (bf16), and beside it ``tc_bound_ms``, the products on the tensor
    cores as the scan kernels and the flash backward run them: 3xTF32 (3x
    the operations at the TF32 rate) for fp32, the bf16 rate for bf16."""
    peak = FP32_OPS_PER_S if dtype == "float32" else BF16_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    t_tc = (3 * flops / TF32_OPS_PER_S if dtype == "float32"
            else flops / BF16_OPS_PER_S) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "tc_bound_ms": max(t_bytes, t_tc),
            "tc_bound_by": "bytes" if t_bytes >= t_tc else "operations",
            "bytes": nbytes, "flops": flops}
