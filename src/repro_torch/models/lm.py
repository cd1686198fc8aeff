"""Unified LM facade: one API over the ported architectures.

The port of ``repro/models/lm.py``:

  * ``param_specs / init_params``
  * ``forward_train(cfg, params, batch, tp)``     (features)
  * ``loss_fn(cfg, params, batch, tp)``           (train shapes)
  * ``serve_prefill(cfg, params, batch, tp, cache, last_pos=None)``
  * ``serve_step(cfg, params, tokens, pos, tp, cache)``
  * ``init_cache / cache_axes_tree``

Families: dense/moe/vlm/audio -> transformer.py; ssm -> rwkv6.py;
hybrid -> zamba2.py, dispatched here as in the reference.  The recurrent
families serve forward only: ``forward_train`` and ``loss_fn`` raise for
them naming ROADMAP A17 (their training needs backward kernels of the
scans).  Caches and states are written in place and returned.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import common, mamba2, rwkv6, transformer, zamba2
from repro_torch.models.common import PSpec, index_tree, rms_norm

TRANSFORMER_FAMILIES = ("dense", "moe", "vlm", "audio")


def param_specs(cfg: ModelConfig, tp: int) -> Dict[str, Any]:
    if cfg.family in TRANSFORMER_FAMILIES:
        return transformer.param_specs(cfg, tp)
    if cfg.family == "hybrid":
        return zamba2.param_specs(cfg, tp)
    if cfg.family == "ssm":
        vp = cfg.padded_vocab(tp)
        d = cfg.d_model
        return {
            "embed": PSpec((vp, d), ("tp", "fsdp"), init="small"),
            "layers": rwkv6.layer_specs(cfg, tp, cfg.n_layers),
            "final_norm": PSpec((d,), (None,), init="ones"),
            "lm_head": PSpec((d, vp), ("fsdp", "tp"), init="small"),
        }
    raise ValueError(cfg.family)


def init_params(cfg: ModelConfig, seed: int, tp: int = 1,
                dtype=torch.float32, device: DeviceLike = None):
    """Random params drawn on ``device`` from a generator of that device
    seeded with ``seed`` (never staged on the host)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return common.init_from_specs(param_specs(cfg, tp), gen, dev, dtype)


def _no_recurrent_training(cfg: ModelConfig):
    return NotImplementedError(
        f"training the {cfg.family} family ({cfg.name!r}) is not ported to "
        f"the PyTorch package (ROADMAP A17: the recurrent families serve "
        f"forward only; their training needs backward kernels of the "
        f"wkv6/ssd scans)")


def forward_train(cfg: ModelConfig, p, batch, tp: int):
    if cfg.family in TRANSFORMER_FAMILIES:
        return transformer.forward_train(cfg, p, batch, tp)
    raise _no_recurrent_training(cfg)


def loss_fn(cfg: ModelConfig, p, batch, tp: int):
    if cfg.family in TRANSFORMER_FAMILIES:
        return transformer.loss_fn(cfg, p, batch, tp)
    raise _no_recurrent_training(cfg)


# ---------------------------------------------------------------------------
# rwkv model-level glue (transformer/zamba have their own modules)
# ---------------------------------------------------------------------------

def _rwkv_forward(cfg, p, tokens, state, tp, single_token):
    """Runs every layer, writing ``state`` in place; returns the final
    normed features."""
    x = p["embed"][tokens.long()]
    for i in range(cfg.n_layers):
        x, _ = rwkv6.block(cfg, index_tree(p["layers"], i), x,
                           index_tree(state, i), tp, single_token)
    return rms_norm(x, p["final_norm"], cfg.rms_eps)


def _rwkv_prefill(cfg, p, batch, tp, state):
    x = _rwkv_forward(cfg, p, batch["tokens"], state, tp, False)
    return torch.matmul(x[:, -1], p["lm_head"]), state


def _rwkv_step(cfg, p, tokens, pos, tp, state):
    del pos  # stateful: position-free
    x = _rwkv_forward(cfg, p, tokens[:, None], state, tp, True)
    return torch.matmul(x[:, -1], p["lm_head"]), state


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def serve_prefill(cfg: ModelConfig, p, batch, tp: int, cache,
                  last_pos=None):
    """``last_pos`` ((B,) int32) enables exact left-aligned padded prompt
    batches — attention-only families: recurrent state (ssm/hybrid)
    integrates right-padding, so those families must feed prompts
    token-by-token instead (repro_torch.serve.engine does)."""
    if cfg.family in TRANSFORMER_FAMILIES:
        return transformer.serve_prefill(cfg, p, batch, tp, cache,
                                         last_pos=last_pos)
    if last_pos is not None:
        raise ValueError(
            f"per-slot prefill (last_pos) is only exact for attention "
            f"families {TRANSFORMER_FAMILIES}; family {cfg.family!r} "
            f"carries recurrent state that would integrate the padding — "
            f"feed prompts through serve_step instead")
    if cfg.family == "hybrid":
        return zamba2.serve_prefill(cfg, p, batch, tp, cache)
    return _rwkv_prefill(cfg, p, batch, tp, cache)


def serve_step(cfg: ModelConfig, p, tokens, pos, tp: int, cache):
    if cfg.family in TRANSFORMER_FAMILIES:
        return transformer.serve_step(cfg, p, tokens, pos, tp, cache)
    if cfg.family == "hybrid":
        return zamba2.serve_step(cfg, p, tokens, pos, tp, cache)
    return _rwkv_step(cfg, p, tokens, pos, tp, cache)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, tp: int,
               dtype=torch.bfloat16, device: DeviceLike = None):
    dev = resolve_device(device)
    if cfg.family in TRANSFORMER_FAMILIES:
        return transformer.init_cache(cfg, batch, max_len, tp, dtype,
                                      device=dev)
    if cfg.family == "hybrid":
        return zamba2.init_cache(cfg, batch, max_len, tp, dtype, device=dev)
    return rwkv6.init_state(cfg, batch, tp, stacked=cfg.n_layers,
                            device=dev)


def cache_axes_tree(cfg: ModelConfig, tp: int):
    """Logical axes of each cache leaf, in the cache's own tree (the
    engine finds each leaf's batch axis as ``"cache_batch"``)."""
    attn.check_tp(tp)
    kv_axes = (None,) + attn.cache_axes(cfg, tp)
    kv_tree = attn.KVCache(k=kv_axes, v=kv_axes,
                           positions=(None, "cache_batch", kv_axes[2]))
    if cfg.family in TRANSFORMER_FAMILIES:
        return kv_tree
    if cfg.family == "hybrid":
        return zamba2.ZambaCache(
            mamba=mamba2.MambaState(
                conv=(None, "cache_batch", None, None),
                h=(None, "cache_batch", "tp", None, None)),
            kv=kv_tree,
        )
    return rwkv6.RWKVState(
        tshift=(None, "cache_batch", None),
        cshift=(None, "cache_batch", None),
        wkv=(None, "cache_batch", "tp", None, None),
    )
