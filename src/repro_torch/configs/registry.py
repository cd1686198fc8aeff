"""Architecture registry: ``--arch <id>`` resolution for every entry point."""
from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, Dict, List

from repro_torch.configs.base import ModelConfig
from repro_torch.configs import (
    zamba2_2p7b,
    paligemma_3b,
    h2o_danube3_4b,
    qwen2_7b,
    minitron_8b,
    qwen1p5_110b,
    granite_moe_3b,
    deepseek_moe_16b,
    rwkv6_3b,
    hubert_xlarge,
    tiny_lm,
)

_MODULES = {
    "zamba2-2.7b": zamba2_2p7b,
    "paligemma-3b": paligemma_3b,
    "h2o-danube-3-4b": h2o_danube3_4b,
    "qwen2-7b": qwen2_7b,
    "minitron-8b": minitron_8b,
    "qwen1.5-110b": qwen1p5_110b,
    "granite-moe-3b-a800m": granite_moe_3b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "rwkv6-3b": rwkv6_3b,
    "hubert-xlarge": hubert_xlarge,
    # CPU-sized dense LM backing the federated ``tiny_lm`` model entry
    # (models/registry.py); also drivable directly: --arch tiny-lm
    "tiny-lm": tiny_lm,
    # long-sequence variant backing the ``tiny_lm_long`` federated entry
    # and the flash-vs-reference bench rows (benchmarks/run.py)
    "tiny-lm-long": SimpleNamespace(config=tiny_lm.long, smoke=tiny_lm.long),
}

ARCH_IDS: List[str] = list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return _MODULES[arch].config()


def get_smoke_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    return _MODULES[arch].smoke()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
