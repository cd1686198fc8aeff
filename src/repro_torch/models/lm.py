"""Unified LM facade: one API over the ported architectures.

The port of ``repro/models/lm.py``:

  * ``param_specs / init_params``
  * ``forward_train(cfg, params, batch, tp)``     (features, forward only)
  * ``serve_prefill(cfg, params, batch, tp, cache, last_pos=None)``
  * ``serve_step(cfg, params, tokens, pos, tp, cache)``
  * ``init_cache / cache_axes_tree``

Every call dispatches to transformer.py, which runs the dense family and
raises naming ROADMAP A17 for the others (moe, vlm, audio, and the ssm
and hybrid families of rwkv6.py / zamba2.py).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import common, transformer

TRANSFORMER_FAMILIES = ("dense", "moe", "vlm", "audio")


def param_specs(cfg: ModelConfig, tp: int) -> Dict[str, Any]:
    return transformer.param_specs(cfg, tp)


def init_params(cfg: ModelConfig, seed: int, tp: int = 1,
                dtype=torch.float32, device: DeviceLike = None):
    """Random params drawn on ``device`` from a generator of that device
    seeded with ``seed`` (never staged on the host)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return common.init_from_specs(param_specs(cfg, tp), gen, dev, dtype)


def forward_train(cfg: ModelConfig, p, batch, tp: int):
    return transformer.forward_train(cfg, p, batch, tp)


def serve_prefill(cfg: ModelConfig, p, batch, tp: int, cache,
                  last_pos=None):
    """``last_pos`` ((B,) int32) enables exact left-aligned padded prompt
    batches (attention families only, as in the reference)."""
    return transformer.serve_prefill(cfg, p, batch, tp, cache,
                                     last_pos=last_pos)


def serve_step(cfg: ModelConfig, p, tokens, pos, tp: int, cache):
    return transformer.serve_step(cfg, p, tokens, pos, tp, cache)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, tp: int,
               dtype=torch.bfloat16, device: DeviceLike = None):
    return transformer.init_cache(cfg, batch, max_len, tp, dtype,
                                  device=resolve_device(device))


def cache_axes_tree(cfg: ModelConfig, tp: int) -> attn.KVCache:
    """Logical axes of each cache leaf (the engine finds each leaf's batch
    axis as ``"cache_batch"``)."""
    transformer.check_family(cfg)
    kv_axes = (None,) + attn.cache_axes(cfg, tp)
    return attn.KVCache(k=kv_axes, v=kv_axes,
                        positions=(None, "cache_batch", kv_axes[2]))
