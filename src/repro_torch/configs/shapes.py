"""Assigned input shapes.

Each LM architecture is exercised on up to four shapes:

=============  =========  ============  ====================================
shape id       seq_len    global_batch  step lowered
=============  =========  ============  ====================================
train_4k       4,096      256           ``train_step``
prefill_32k    32,768     32            ``serve_prefill``
decode_32k     32,768     128           ``serve_step`` (1 new token, KV cache)
long_500k      524,288    1             ``serve_step`` (sub-quadratic only)
=============  =========  ============  ====================================

``decode_*`` / ``long_*`` lower one-token decode against a cache of
``seq_len``; they are skipped for encoder-only models.  ``long_500k`` is
skipped for pure full-attention architectures (see DESIGN.md
§Arch-applicability).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """Whether (arch x shape) is a defined cell (DESIGN.md §Arch-applicability)."""
    if shape.kind == "decode" and not cfg.is_decoder:
        return False  # encoder-only: no autoregressive decode
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False  # pure full-attention: 500k decode cache unbounded
    return True


def smoke_shape(kind: str = "train") -> ShapeConfig:
    """Tiny shape for CPU smoke tests."""
    if kind == "train":
        return ShapeConfig("smoke_train", 128, 4, "train")
    if kind == "prefill":
        return ShapeConfig("smoke_prefill", 128, 2, "prefill")
    return ShapeConfig("smoke_decode", 128, 2, "decode")
