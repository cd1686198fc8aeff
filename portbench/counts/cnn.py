"""Model FLOPs of the paper's CNN (FedAT §6.1), from its shapes: SAME 3x3
convolutions with a 2x2 max-pool after each, then two dense layers.  A
multiply-add counts 2; biases, activations and pools are not counted.
Training counts 3 forwards (the forward and a backward of two)."""
from typing import Dict, List, Tuple

TRAIN_FACTOR = 3


def layers(cfg: Dict) -> List[Tuple[str, int, int, int]]:
    """(kind, positions, fan_in, fan_out) of each layer with weights."""
    hw, c = cfg["image_hw"], cfg["channels"]
    out = []
    for o in cfg["conv_channels"]:
        k = cfg["kernel"]
        out.append(("conv", hw * hw, k * k * c, o))
        hw, c = hw // 2, o
    flat = hw * hw * c
    out.append(("dense", 1, flat, cfg["dense"]))
    out.append(("dense", 1, cfg["dense"], cfg["n_classes"]))
    return out


def params(cfg: Dict) -> int:
    return sum(fi * fo + fo for _, _, fi, fo in layers(cfg))


def forward_flops(cfg: Dict) -> int:
    """One image's forward."""
    return sum(2 * pos * fi * fo for _, pos, fi, fo in layers(cfg))


def train_flops(cfg: Dict, samples: int) -> int:
    return TRAIN_FACTOR * forward_flops(cfg) * samples
