"""Kernel layer of the port: hand-written Hopper kernels behind wrappers.

  * :func:`compress` / :func:`decompress` — the blockwise quantize codec
    (CUDA C++, ``csrc/polyline_codec.cu``); the quantize link codecs ride
    these (compress/transport.py).
  * :func:`attention` (and ``ops.flash_attention``) — causal /
    sliding-window GQA attention (CUDA C++, ``csrc/flash_attention.cu``,
    wrapped by the :mod:`flash_attention` module, which this package does
    not shadow with the function); the dense LM's full-sequence attention
    rides it (models/attention.py).
  * :func:`blocked_attention` — the streaming torch path: the CPU path of
    both names above, and the prefix-LM mask.
  * :mod:`ref` — the plain PyTorch versions each kernel is held against.

Kernels are compiled at first launch (kernels/build.py), never at import.
"""
from typing import Dict

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import polyline_codec as _codec
from repro_torch.kernels import ref  # noqa: F401
from repro_torch.kernels.ops import (  # noqa: F401
    attention, blocked_attention, compress, decompress,
    default_attention_impl)


def launch_counts() -> Dict[str, int]:
    """CUDA launches of every kernel since the last reset."""
    return {**_codec.launch_counts(), **_fa.launch_counts()}


def reset_launch_counts() -> None:
    _codec.reset_launch_counts()
    _fa.reset_launch_counts()
