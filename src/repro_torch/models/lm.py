"""Unified LM facade: one API over the ported architectures.

The port of ``repro/models/lm.py``:

  * ``param_specs / init_params / param_axes / abstract_params``
  * ``forward_train(cfg, params, batch, tp)``     (features)
  * ``loss_fn(cfg, params, batch, tp)``           (train shapes)
  * ``serve_prefill(cfg, params, batch, tp, cache, last_pos=None)``
  * ``serve_step(cfg, params, tokens, pos, tp, cache)``
  * ``init_cache / abstract_cache / cache_axes_tree``
  * ``input_specs / input_axes``  (``meta``-device stand-ins for the dry-run)

Families: dense/moe/vlm/audio -> transformer.py; ssm -> rwkv6.py;
hybrid -> zamba2.py, dispatched here as in the reference.  The recurrent
families train from the zero state through the scans' autograd functions
(whose backward is a kernel on the card), rwkv6 with each layer under
``torch.utils.checkpoint`` when ``cfg.remat``, as the reference remats its
scanned layer body.  Caches and states are written in place and
returned.

In a train step sharded over ``data`` (core/steps.py) the params are a
rank's FSDP shards, wrapped by :func:`anchor_params`, and every family
gathers them where it reads them: one layer's at a time inside the
function its layer loop checkpoints (``runtime/sharding.py`` ``gather``),
the embedding and head at their use.  Elsewhere they are whole tensors
and the gathers are the identity.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import common, mamba2, rwkv6, transformer, zamba2
from repro_torch.models.common import PSpec, index_tree, rms_norm
from repro_torch.runtime import sharding as shd

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
                dtype=torch.float32, device: DeviceLike = None, mesh=None):
    """Random params drawn on ``device`` from a generator of that device
    seeded with ``seed`` (never staged on the host); with a ``mesh``, this
    rank's block of each leaf's layout (the same draws on every rank)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return common.init_from_specs(param_specs(cfg, tp), gen, dev, dtype,
                                  mesh)


def param_axes(cfg: ModelConfig, tp: int):
    return common.axes_from_specs(param_specs(cfg, tp))


def anchor_params(cfg: ModelConfig, params, tp: int):
    """The reference pins every leaf to its logical sharding under the
    current mesh inside the jitted step, so that GSPMD gathers the FSDP
    shards of one layer at a time.  Here ``params`` are this rank's
    shards: under a mesh (``sharding.use_mesh``) with data ranks, each
    leaf its layout splits over ``data`` is wrapped as a
    :class:`~repro_torch.runtime.sharding.Sharded` of the mesh's
    :class:`~repro_torch.runtime.sharding.FSDP`, and the model gathers it
    where it reads it (``sharding.gather``): a layer's leaves inside the
    function each layer loop checkpoints, so under remat the recompute
    gathers again and no layer's whole weights outlive its block; the
    embedding, head and frontend at their use.  Without a mesh, or with
    one data rank, the params unchanged."""
    fsdp = shd.FSDP.over(shd.current_mesh())
    if fsdp is None:
        return params
    return fsdp.wrap(params, shd.tree_shardings(param_axes(cfg, tp),
                                                fsdp.mesh))


def abstract_params(cfg: ModelConfig, tp: int, dtype=torch.bfloat16):
    return common.shapes_from_specs(param_specs(cfg, tp), dtype)


def forward_train(cfg: ModelConfig, p, batch, tp: int):
    """(features (B, S, d) after the final norm, aux loss, prefix_len); the
    recurrent families have no aux loss and no prefix."""
    if cfg.family in TRANSFORMER_FAMILIES:
        return transformer.forward_train(cfg, p, batch, tp)
    tokens = batch["tokens"]
    if cfg.family == "hybrid":
        x = zamba2._run(cfg, p, shd.gather(p["embed"])[tokens.long()], tp,
                        "train")
        x = rms_norm(x, p["final_norm"], cfg.rms_eps)
    else:
        x = _rwkv_forward(cfg, p, tokens, None, tp, False)
    return x, torch.zeros((), dtype=torch.float32, device=x.device), 0


def loss_fn(cfg: ModelConfig, p, batch, tp: int):
    if cfg.family in TRANSFORMER_FAMILIES:
        return transformer.loss_fn(cfg, p, batch, tp)
    if cfg.family == "hybrid":
        return zamba2.loss_fn(cfg, p, batch, tp)
    return _rwkv_loss(cfg, p, batch, tp)


# ---------------------------------------------------------------------------
# rwkv model-level glue (transformer/zamba have their own modules)
# ---------------------------------------------------------------------------

def _rwkv_train_layer(cfg, tp, x, lp):
    return rwkv6.block(cfg, shd.gather(lp), x, None, tp, False)[0]


def _rwkv_forward(cfg, p, tokens, state, tp, single_token):
    """Runs every layer, writing ``state`` in place, or, with ``state``
    None, a training forward from the zero state (each layer checkpointed
    under ``cfg.remat``, its shards gathered inside); returns the final
    normed features."""
    x = shd.gather(p["embed"])[tokens.long()]
    remat = state is None and cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        lp = index_tree(p["layers"], i)
        if state is not None:
            x, _ = rwkv6.block(cfg, lp, x, index_tree(state, i), tp,
                               single_token)
        elif remat:
            x = checkpoint(_rwkv_train_layer, cfg, tp, x, lp,
                           use_reentrant=False)
        else:
            x = _rwkv_train_layer(cfg, tp, x, lp)
    return rms_norm(x, p["final_norm"], cfg.rms_eps)


def _rwkv_loss(cfg, p, batch, tp):
    """rwkv6's loss: the zamba2 module's seq-chunked cross-entropy (the
    reference's sharing) over the training forward's features."""
    x = _rwkv_forward(cfg, p, batch["tokens"], None, tp, False)
    return zamba2._chunked_ce(cfg, x, shd.gather(p["lm_head"]),
                              batch["tokens"], tp)


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


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int, tp: int,
                   dtype=torch.bfloat16):
    """:func:`init_cache` on the ``meta`` device (shapes and dtypes)."""
    meta = torch.device("meta")
    if cfg.family in TRANSFORMER_FAMILIES:
        return transformer.init_cache(cfg, batch, max_len, tp, dtype,
                                      device=meta)
    if cfg.family == "hybrid":
        return zamba2.init_cache(cfg, batch, max_len, tp, dtype, device=meta)
    return rwkv6.init_state(cfg, batch, tp, stacked=cfg.n_layers,
                            device=meta)


def cache_axes_tree(cfg: ModelConfig, tp: int):
    """Logical axes of each cache leaf, in the cache's own tree (the
    engine finds each leaf's batch axis as ``"cache_batch"``)."""
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


# ---------------------------------------------------------------------------
# input specs (meta-device stand-ins for the dry-run / launchers)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Abstract model inputs for one (arch x shape) cell."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind in ("train", "prefill"):
        if cfg.family == "vlm":
            np_ = min(cfg.n_frontend_tokens, S // 2)
            return {"patch_embeds": _meta((B, np_, cfg.d_model),
                                          torch.bfloat16),
                    "tokens": _meta((B, S - np_), i32)}
        if cfg.family == "audio":
            out = {"frames": _meta((B, S, cfg.d_model), torch.bfloat16)}
            if shape.kind == "train":
                out["labels"] = _meta((B, S), i32)
                out["mask"] = _meta((B, S), torch.bool)
            return out
        return {"tokens": _meta((B, S), i32)}
    # decode: one new token against a cache of S
    return {"tokens": _meta((B,), i32), "pos": _meta((), i32)}


def input_axes(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, tuple]:
    if shape.kind in ("train", "prefill"):
        if cfg.family == "vlm":
            return {"patch_embeds": ("batch", None, None),
                    "tokens": ("batch", None)}
        if cfg.family == "audio":
            out = {"frames": ("batch", None, None)}
            if shape.kind == "train":
                out["labels"] = ("batch", None)
                out["mask"] = ("batch", None)
            return out
        return {"tokens": ("batch", None)}
    return {"tokens": ("batch",), "pos": ()}
