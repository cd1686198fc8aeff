"""Kernel layer of the port: hand-written Hopper kernels behind wrappers.

  * :func:`compress` / :func:`decompress` — the blockwise quantize codec
    (CUDA C++, ``csrc/polyline_codec.cu``); the quantize link codecs ride
    these (compress/transport.py).
  * :mod:`ref` — the plain PyTorch versions each kernel is held against.

Kernels are compiled at first launch, never at import.
"""
from repro_torch.kernels import ref  # noqa: F401
from repro_torch.kernels.ops import compress, decompress  # noqa: F401
from repro_torch.kernels.polyline_codec import (  # noqa: F401
    launch_counts, reset_launch_counts)
