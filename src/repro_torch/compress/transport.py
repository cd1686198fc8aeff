"""Codec-agnostic transport layer for the FL links (the port of
``repro/compress/transport.py``).

One :class:`Codec` interface unifies the three faces every lossy link has:

  * ``lossy(params)``     — the quantize-dequantize step that models the
    link's effect on learning dynamics inside the round step;
  * ``marshal/unmarshal`` — the actual wire message (what would be sent);
  * ``payload_bytes``     — wire-size accounting for the byte metrics.

Registered codecs: ``none`` (identity, raw f32 accounting), ``polyline``
(``polyline:<p>``, the paper's §4.3 codec), ``quantize8``/``quantize16``
(blockwise fixed-point; the lossy step runs the fused CUDA roundtrip
kernel in kernels/csrc/polyline_codec.cu on the card, one launch a link,
and its plain version on the CPU).  ``measure_ratio`` estimates wire/raw bytes on a size-capped
parameter sample, exactly as the reference does, so byte ledgers agree.
"""
from __future__ import annotations

import abc
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.compress import polyline, quantize
from repro_torch.compress.polyline import to_numpy, tree_flatten, \
    tree_leaves, tree_unflatten

#: default element cap for sampled wire-ratio measurement (the reference's)
RATIO_SAMPLE_ELEMS = 65536


def _sample_tree(params: Any, max_elems: Optional[int]) -> List[np.ndarray]:
    """Per-leaf-proportional flat prefix sample of a tree."""
    leaves = [to_numpy(l).reshape(-1) for l in tree_leaves(params)]
    total = sum(l.size for l in leaves)
    if max_elems is None or total <= max_elems:
        return leaves
    frac = max_elems / total
    return [l[:max(1, int(l.size * frac))] for l in leaves]


def _map(fn: Callable[[torch.Tensor], torch.Tensor], params: Any) -> Any:
    leaves, treedef = tree_flatten(params)
    return tree_unflatten(treedef, [fn(l) for l in leaves])


class Codec(abc.ABC):
    """A lossy (or identity) link codec; see module docstring."""

    name: str = "codec"

    def lossy(self, params: Any) -> Any:
        """Encode->decode roundtrip (models the link's loss)."""
        return params

    @abc.abstractmethod
    def marshal(self, params: Any) -> Dict[str, Any]:
        """Tree -> wire message."""

    @abc.abstractmethod
    def unmarshal(self, msg: Dict[str, Any]) -> Any:
        """Wire message -> tree."""

    @abc.abstractmethod
    def payload_bytes(self, msg: Dict[str, Any]) -> int:
        """Wire size of a marshalled message."""

    def fixed_overhead_bytes(self, msg: Dict[str, Any]) -> int:
        """Per-leaf fixed wire costs (metadata) inside ``payload_bytes``."""
        return 0

    def measure_ratio(self, params: Any,
                      max_elems: Optional[int] = RATIO_SAMPLE_ELEMS) -> float:
        """Wire bytes / raw f32 bytes, measured on a capped sample (the
        per-value rate is extrapolated, per-leaf fixed costs added once)."""
        sample = _sample_tree(params, max_elems)
        msg = self.marshal(sample)
        overhead = self.fixed_overhead_bytes(msg)
        raw_sample = polyline.raw_bytes(sample)
        raw_full = polyline.raw_bytes(params)
        var_rate = (self.payload_bytes(msg) - overhead) / raw_sample
        return (var_rate * raw_full + overhead) / raw_full


class NoneCodec(Codec):
    """Uncompressed f32 links (the baselines' Table 2 setting)."""

    name = "none"

    def marshal(self, params):
        leaves, treedef = tree_flatten(params)
        return {"leaves": [to_numpy(l) for l in leaves], "treedef": treedef}

    def unmarshal(self, msg):
        return tree_unflatten(msg["treedef"], msg["leaves"])

    def payload_bytes(self, msg):
        return sum(l.nbytes for l in msg["leaves"])

    def measure_ratio(self, params, max_elems=RATIO_SAMPLE_ELEMS):
        return 1.0


class PolylineCodec(Codec):
    """The paper's reference compressor (compress/polyline.py)."""

    def __init__(self, precision: int = 4):
        self.precision = precision
        self.name = f"polyline:{precision}"

    def lossy(self, params):
        # round to `precision` decimals as multiply-by-reciprocal with f32
        # constants, the reference's exact form
        f = float(np.float32(10.0 ** self.precision))
        inv = float(np.float32(1.0 / (10.0 ** self.precision)))
        return _map(lambda x: torch.round(x * f) * inv, params)

    def marshal(self, params):
        return polyline.marshal(params, self.precision)

    def unmarshal(self, msg):
        return polyline.unmarshal(msg)

    def payload_bytes(self, msg):
        return polyline.payload_bytes(msg)

    def fixed_overhead_bytes(self, msg):
        return 8 * len(msg["shapes"])  # dims metadata per leaf


class QuantizeCodec(Codec):
    """Blockwise fixed-point quantization; the lossy step is one call of
    the fused roundtrip kernel over every leaf of the tree
    (``kernels/polyline_codec.py`` ``roundtrip_blocks``: one launch a link
    for up to 64 leaves), the wire message the plain eager
    compress/quantize.py, as in the reference.

    A leaf is blocked as a whole: on the uplink that is the stacked
    ``(K, ...)`` client tensor, so a 256-block may span two clients, as in
    the reference (its lossy step maps over the stacked client params).
    A leaf of another dtype goes through float32, as the reference's
    ``astype`` does, and comes back in its own dtype.
    """

    def __init__(self, bits: int = 8):
        if not 2 <= bits <= 16:
            raise ValueError(f"quantize codec supports 2..16 bits, got {bits}")
        self.bits = bits
        self.name = f"quantize{bits}"

    def lossy(self, params):
        from repro_torch.kernels.polyline_codec import roundtrip_blocks
        leaves, treedef = tree_flatten(params)
        outs = roundtrip_blocks(
            [x.reshape(-1).to(torch.float32).contiguous() for x in leaves],
            self.bits)
        return tree_unflatten(treedef, [
            o.reshape(x.shape).to(x.dtype) for o, x in zip(outs, leaves)])

    def marshal(self, params):
        return quantize.compress_tree(params, self.bits)

    def unmarshal(self, msg):
        return quantize.decompress_tree(msg)

    def payload_bytes(self, msg):
        return quantize.tree_wire_bytes(msg)

    def measure_ratio(self, params, max_elems=RATIO_SAMPLE_ELEMS):
        # exact and cheap: the wire size depends only on leaf sizes
        itemsize = 1 if self.bits <= 8 else 2
        sizes = [int(np.prod(tuple(l.shape))) for l in tree_leaves(params)]
        wire = sum(-(-n // quantize.BLOCK) * (quantize.BLOCK * itemsize + 4)
                   for n in sizes)
        wire += 8 * len(sizes)
        return wire / polyline.raw_bytes(params)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[..., Codec]] = {}


def register_codec(name: str, factory: Callable[..., Codec]) -> None:
    _REGISTRY[name] = factory


def registered_codecs() -> List[str]:
    return sorted(_REGISTRY)


register_codec("none", lambda: NoneCodec())
register_codec("polyline", lambda p=4: PolylineCodec(int(p)))
register_codec("quantize", lambda b=8: QuantizeCodec(int(b)))
register_codec("quantize8", lambda: QuantizeCodec(8))
register_codec("quantize16", lambda: QuantizeCodec(16))


def get_codec(spec: Union[str, Codec, None]) -> Codec:
    """Resolve ``'polyline'``, ``'polyline:6'``, ``'quantize8'``, a Codec
    instance, or None (identity) to a Codec."""
    if spec is None:
        return NoneCodec()
    if isinstance(spec, Codec):
        return spec
    name, _, arg = str(spec).partition(":")
    if name not in _REGISTRY:
        raise ValueError(f"unknown codec {spec!r}; "
                         f"registered: {sorted(_REGISTRY)}")
    if not arg:
        return _REGISTRY[name]()
    try:
        return _REGISTRY[name](arg)
    except (TypeError, ValueError) as e:
        raise ValueError(f"bad argument in codec spec {spec!r} "
                         f"(expected e.g. 'polyline:4', 'quantize:16'): {e}")


def cross_tier_bits(spec: Union[str, Codec]) -> int:
    """Int width of the cross-tier collective of the multi-pod trainer (a
    pure function of the codec spec; the collective itself is ROADMAP
    A16).  Only the quantize family carries an int payload; polyline is a
    host-side wire codec."""
    codec = get_codec(spec)
    if not isinstance(codec, QuantizeCodec):
        raise ValueError(
            f"codec {codec.name!r} cannot run inside the cross-tier "
            "collective; use quantize8/quantize16")
    return codec.bits
