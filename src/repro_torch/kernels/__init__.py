"""Kernel layer of the port: hand-written Hopper kernels behind wrappers.

  * :func:`compress` / :func:`decompress` — the blockwise quantize codec
    (CUDA C++, ``csrc/polyline_codec.cu``), the reference's pair with its
    int payload; ``polyline_codec.roundtrip_blocks`` fuses the two over
    every leaf of a link in one launch, and the quantize link codecs ride
    it (compress/transport.py).
  * :func:`attention` (and ``ops.flash_attention``) — causal /
    sliding-window GQA attention (CUDA C++, ``csrc/flash_attention.cu``,
    wrapped by the :mod:`flash_attention` module, which this package does
    not shadow with the function); the dense LM's full-sequence attention
    rides it (models/attention.py).  Its gradient is
    ``flash_attention.FlashAttention``, whose backward is a kernel of its
    own (``csrc/flash_attention_bwd.cu``).
  * :func:`blocked_attention` — the streaming torch path: the CPU path of
    both names above, and the prefix-LM mask.
  * ``ops.wkv6`` and :mod:`rwkv6_scan` — the RWKV-6 WKV chunk scan (CUDA
    C++, ``csrc/wkv6.cu``); rwkv6's prefill rides it (models/rwkv6.py).
    Its gradient is ``rwkv6_scan.WKV6``, whose backward is a kernel of
    its own (``csrc/wkv6_bwd.cu``); rwkv6's training rides it.
  * ``ops.ssd`` and :mod:`ssd` — the Mamba2 SSD chunk scan (CUDA C++,
    ``csrc/ssd.cu``); zamba2's mamba2 layers ride it (models/mamba2.py).
    Its gradient is ``ssd.SSDScan`` (backward ``csrc/ssd_bwd.cu``).
    Neither scan function is re-exported here: ``ssd`` names the module.
    Both backwards check their operands through ``build``.
  * :mod:`cnn_block` — the CNN's conv-block glue (CUDA C++,
    ``csrc/cnn_block.cu``): ``Im2col`` (the patches, and a gather-sum
    backward) and ``BiasReluPool`` (bias + ReLU + 2x2 max-pool, and its
    backward from a one-byte mask), the autograd Functions around each
    conv's product in models/cnn.py, bit for bit the composite ops.
  * :mod:`ref` — the plain PyTorch versions each kernel is held against.

Kernels are compiled at first launch (kernels/build.py), never at import.
"""
from repro_torch.kernels import cnn_block  # noqa: F401
from repro_torch.kernels import flash_attention  # noqa: F401
from repro_torch.kernels import polyline_codec  # noqa: F401
from repro_torch.kernels import ref  # noqa: F401
from repro_torch.kernels import rwkv6_scan  # noqa: F401
from repro_torch.kernels import ssd  # noqa: F401
from repro_torch.kernels.build import (  # noqa: F401
    launch_counts, reset_launch_counts)
from repro_torch.kernels.ops import (  # noqa: F401
    attention, blocked_attention, compress, decompress,
    default_attention_impl)
