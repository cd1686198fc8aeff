"""Build and load the port's CUDA kernels: ``nvcc`` -> shared library ->
``ctypes``.

Each source under ``csrc/`` has a plain C interface and is compiled at
first use for ``sm_90a`` into ``build/repro_torch_kernels/`` at the
repository root (a git-ignored directory), under a name keyed by a hash of
the source and the flags, so an edited source is rebuilt and an unchanged
one is loaded as it is.  The output is renamed into place atomically, so
processes that build at once race safely.  :func:`build` compiles several
sources in parallel, one ``nvcc`` process each, all started together.
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
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: source stem -> what its build did: {"path", "seconds", "log"}
#: (seconds 0 and an empty log when an earlier build was reused)
BUILD_INFO: Dict[str, Dict[str, object]] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    nvcc = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels are built from source at first use")
    return nvcc


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
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
