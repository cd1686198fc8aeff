"""Wrappers of the blockwise quantize codec kernels (csrc/polyline_codec.cu).

compress_blocks:   x (n,) f32 -> q (ceil(n/256), 256) int8|int16,
                   scale (ceil(n/256), 1) f32
decompress_blocks: (q, scale, n) -> x (n,) f32
roundtrip_blocks:  [x_i (n_i,) f32] -> [decompress(compress(x_i))], every
                   leaf of a link in one launch (the lossy step of the
                   quantize link codecs, compress/transport.py)

The port of ``repro/kernels/polyline_codec.py``; the pair keeps the
reference's contract (and its int payload), the roundtrip fuses the two
for the link.  A tensor on the CPU takes the plain version (kernels/ref.py);
a CUDA tensor launches the hand-written Hopper kernel or raises, with no
fallback.  Each wrapper counts its kernel launches (``launch_counts``), so
a run can show that its main path went through the kernels.

The roundtrip passes its leaves to the kernel as a segment table in the
kernel parameters (:func:`segment_table`), at most :data:`MAX_SEGMENTS` a
launch, and writes every output into one buffer at offsets rounded up to
:data:`ALIGN` values, so each leaf's stores are 16-byte vectors.  It
neither synchronises nor reads device values on the host, so a CUDA graph
can capture it.

The kernels are compiled at first use with ``nvcc`` (kernels/build.py).
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence, Tuple

import torch

from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ref

BLOCK = ref.BLOCK
#: leaves in one roundtrip launch (csrc/polyline_codec.cu kMaxSegments)
MAX_SEGMENTS = 64
#: values each roundtrip output starts on a multiple of (256 bytes)
ALIGN = 64

_vp, _ci, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_pvp, _pll = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong)
_LIB = kbuild.Library(
    "polyline_codec", "codec_error_string",
    {"codec_compress": [_vp, _ll, _vp, _vp, _ci, _vp],
     "codec_decompress": [_vp, _vp, _ll, _vp, _ci, _vp],
     "codec_roundtrip": [_pvp, _pvp, _pll, _pll, _ci, _ll, _ci, _vp],
     "codec_roundtrip_ctas_per_sm": [],
     "codec_roundtrip_blocks_per_cta": [],
     "codec_empty": [_vp]},
    kernels=("compress", "decompress", "roundtrip"))
launch_counts = _LIB.launch_counts
reset_launch_counts = _LIB.reset_launch_counts


def _check_bits(bits: int) -> None:
    if not 2 <= bits <= 16:
        raise ValueError(f"codec supports 2..16 bits, got {bits}")


def _check_device(t: torch.Tensor, what: str) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: tensors must be on cpu or cuda, "
                         f"got {t.device}")


def _check_flat(x: torch.Tensor, what: str) -> None:
    _check_device(x, what)
    if x.dim() != 1 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{what} takes flat contiguous float32 tensors, "
                         f"got shape {tuple(x.shape)} {x.dtype}")


def compress_blocks(x: torch.Tensor, bits: int = 8):
    """x: flat contiguous float32 (n,) -> (q, scale); see module doc."""
    _check_bits(bits)
    _check_flat(x, "compress_blocks")
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


class Segment(NamedTuple):
    """One leaf of a roundtrip launch."""
    leaf: int          # index of the leaf in the call
    offset: int        # its first value in the output buffer
    n: int             # its values
    first_block: int   # its first codec block in the launch's grid


def segment_table(sizes: Sequence[int], max_segments: int = MAX_SEGMENTS
                  ) -> Tuple[List[List[Segment]], int]:
    """Plan a roundtrip over leaves of ``sizes`` values: (the launches,
    each a list of at most ``max_segments`` segments, and the output
    buffer's length).  Empty leaves get no segment; every output starts
    at a multiple of :data:`ALIGN` values."""
    launches: List[List[Segment]] = []
    offset = 0
    for i, n in enumerate(sizes):
        if n == 0:
            continue
        if not launches or len(launches[-1]) == max_segments:
            launches.append([])
            first = 0
        launches[-1].append(Segment(i, offset, n, first))
        first += -(-n // BLOCK)
        offset += -(-n // ALIGN) * ALIGN
    return launches, offset


def launch_blocks(launch: Sequence[Segment]) -> int:
    """Codec blocks (the kernel's warps) of one launch of
    :func:`segment_table`."""
    last = launch[-1]
    return last.first_block + -(-last.n // BLOCK)


def roundtrip_blocks(leaves: Sequence[torch.Tensor], bits: int = 8
                     ) -> List[torch.Tensor]:
    """decompress(compress(x)) of each flat contiguous float32 leaf, all on
    one device; see module doc.  CUDA outputs are views of one buffer."""
    _check_bits(bits)
    leaves = list(leaves)
    for x in leaves:
        _check_flat(x, "roundtrip_blocks")
    devices = {x.device for x in leaves}
    if len(devices) > 1:
        raise ValueError(f"roundtrip_blocks: leaves on several devices "
                         f"{sorted(map(str, devices))}")
    if not leaves:
        return []
    device = leaves[0].device
    if device.type == "cpu":
        return ref.roundtrip_blocks(leaves, bits)
    launches, total = segment_table([x.numel() for x in leaves])
    buf = torch.empty((total,), dtype=torch.float32, device=device)
    outs = [buf[:0]] * len(leaves)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for launch in launches:
            k = len(launch)
            xs = (ctypes.c_void_p * k)(
                *(leaves[s.leaf].data_ptr() for s in launch))
            os_ = (ctypes.c_void_p * k)(
                *(buf.data_ptr() + 4 * s.offset for s in launch))
            ns = (ctypes.c_longlong * k)(*(s.n for s in launch))
            firsts = (ctypes.c_longlong * k)(*(s.first_block for s in launch))
            _LIB.launch("roundtrip", "codec_roundtrip", xs, os_, ns, firsts,
                        k, launch_blocks(launch), bits, stream)
            for s in launch:
                outs[s.leaf] = buf[s.offset:s.offset + s.n]
    return outs


def roundtrip_ctas_per_sm() -> int:
    """CTAs of the roundtrip kernel that fit on one SM of the current card;
    builds the kernel, launches nothing."""
    return _LIB.query("codec_roundtrip_ctas_per_sm")


def roundtrip_grid(leaves: Sequence[torch.Tensor]) -> List[int]:
    """The CTAs of each roundtrip launch over ``leaves`` (builds the
    kernel, launches nothing)."""
    per_cta = _LIB.query("codec_roundtrip_blocks_per_cta")
    launches, _ = segment_table([x.numel() for x in leaves])
    return [-(-launch_blocks(l) // per_cta) for l in launches]


def empty_launch() -> None:
    """Launch an empty kernel on the current stream, uncounted: the launch
    floor ``chip_smoke.py`` times the roundtrip against."""
    _LIB.call("codec_empty",
                          torch.cuda.current_stream().cuda_stream)
