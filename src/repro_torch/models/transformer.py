"""Transformer LM, dense family: forward, batched prefill and decode.

The port of ``repro/models/transformer.py`` for ``family="dense"``.  One
block = preRMS -> attention -> residual -> preRMS -> SwiGLU -> residual.
Layers are stacked on a leading axis L, as in the reference's param tree,
and iterated by a Python loop over per-layer views (the reference's
``lax.scan``).  The MoE family and the vlm/audio frontends are not ported
yet (ROADMAP A17) and raise.  Forward only: training through the LM is
the federated ``tiny_lm`` slice (ROADMAP A11).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import PSpec, rms_norm, swiglu

PORTED_FAMILIES = ("dense",)


def check_family(cfg: ModelConfig) -> None:
    """Only the dense family is ported; every other family (moe, the
    vlm/audio frontends, ssm, hybrid) raises naming ROADMAP A17."""
    if cfg.family not in PORTED_FAMILIES or cfg.frontend != "none":
        raise NotImplementedError(
            f"model family {cfg.family!r} (frontend {cfg.frontend!r}) of "
            f"{cfg.name!r} is not ported to the PyTorch package yet (ROADMAP "
            f"A17); ported: dense decoders without a frontend")


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def param_specs(cfg: ModelConfig, tp: int) -> Dict[str, Any]:
    check_family(cfg)
    attn.check_tp(tp)
    d, L = cfg.d_model, cfg.n_layers
    vp = cfg.padded_vocab(tp)
    layer: Dict[str, Any] = {
        "attn": attn.attn_specs(cfg, tp, prefix_layers=(L,)),
        "ln1": PSpec((L, d), ("layers", None), init="ones"),
        "ln2": PSpec((L, d), ("layers", None), init="ones"),
        "ffn": {
            "w_gate": PSpec((L, d, cfg.d_ff), ("layers", "fsdp", "tp")),
            "w_in": PSpec((L, d, cfg.d_ff), ("layers", "fsdp", "tp")),
            "w_out": PSpec((L, cfg.d_ff, d), ("layers", "tp", "fsdp")),
        },
    }
    sp: Dict[str, Any] = {
        "embed": PSpec((vp, d), ("tp", "fsdp"), init="small"),
        "layers": layer,
        "final_norm": PSpec((d,), (None,), init="ones"),
    }
    if not cfg.tie_embeddings:
        sp["lm_head"] = PSpec((d, vp), ("fsdp", "tp"), init="small")
    return sp


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _ffn(cfg: ModelConfig, lp, h: torch.Tensor) -> torch.Tensor:
    f = lp["ffn"]
    return swiglu(h, f["w_gate"], f["w_in"], f["w_out"])


def _block_train(cfg: ModelConfig, tp: int, x: torch.Tensor,
                 positions: torch.Tensor, lp) -> torch.Tensor:
    """One layer, full-sequence (forward only)."""
    h = rms_norm(x, lp["ln1"], cfg.rms_eps)
    x = x + attn.full_attention(cfg, lp["attn"], h, positions, tp)
    h = rms_norm(x, lp["ln2"], cfg.rms_eps)
    return x + _ffn(cfg, lp, h)


def _block_decode(cfg: ModelConfig, tp: int, x, pos, lp, cache):
    h = rms_norm(x, lp["ln1"], cfg.rms_eps)
    y, cache = attn.decode_attention(cfg, lp["attn"], h, pos, tp, cache)
    x = x + y
    h = rms_norm(x, lp["ln2"], cfg.rms_eps)
    return x + _ffn(cfg, lp, h), cache


def _block_prefill(cfg: ModelConfig, tp: int, x, positions, lp, cache):
    h = rms_norm(x, lp["ln1"], cfg.rms_eps)
    y, cache = attn.prefill_attention(cfg, lp["attn"], h, positions, tp, cache)
    x = x + y
    h = rms_norm(x, lp["ln2"], cfg.rms_eps)
    return x + _ffn(cfg, lp, h), cache


def _index(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, attn.KVCache):
        return attn.KVCache(*(t[i] for t in tree))
    return tree[i]


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------

def embed_inputs(cfg: ModelConfig, p, batch: Dict[str, torch.Tensor], tp: int
                 ) -> torch.Tensor:
    """Returns x (B,S,d).  Only frontend-free families are ported, so
    there is no prefix (the reference's prefix_len is always 0 here)."""
    check_family(cfg)
    return p["embed"][batch["tokens"].long()]


def lm_head(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    w = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    return torch.matmul(x, w)


def forward_train(cfg: ModelConfig, p, batch, tp: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Returns (features (B,S,d), aux_loss, prefix_len), prefix_len 0."""
    attn.check_tp(tp)
    x = embed_inputs(cfg, p, batch, tp)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for i in range(cfg.n_layers):
        x = _block_train(cfg, tp, x, positions, _index(p["layers"], i))
    x = rms_norm(x, p["final_norm"], cfg.rms_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device), 0


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, tp: int,
               dtype=torch.bfloat16, device=None) -> attn.KVCache:
    check_family(cfg)
    return attn.init_cache(cfg, batch, max_len, tp, dtype,
                           stacked=cfg.n_layers, device=device)


def serve_prefill(cfg, p, batch, tp: int, cache: attn.KVCache,
                  last_pos: Optional[torch.Tensor] = None):
    """Process the prompt; returns (last-position logits (B, V), cache),
    the stacked cache written in place.

    ``last_pos`` ((B,) int32, optional) serves *left-aligned* padded
    prompt batches: logits are gathered at each slot's own last real token
    and cache rows written past it are invalidated (``positions = -1``), so
    decode never attends the right-padding.
    """
    attn.check_tp(tp)
    x = embed_inputs(cfg, p, batch, tp)
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    for i in range(cfg.n_layers):
        x, _ = _block_prefill(cfg, tp, x, positions, _index(p["layers"], i),
                              _index(cache, i))
    x = rms_norm(x, p["final_norm"], cfg.rms_eps)
    if last_pos is None:
        return lm_head(cfg, p, x[:, -1]), cache
    last_pos = torch.as_tensor(last_pos, dtype=torch.int32, device=x.device)
    feats = x[torch.arange(x.shape[0], device=x.device), last_pos.long()]
    cpos = cache.positions                                   # (L, B, T)
    keep = (cpos >= 0) & (cpos <= last_pos[:, None])
    cpos.masked_fill_(~keep, -1)
    return lm_head(cfg, p, feats), cache


def serve_step(cfg: ModelConfig, p, tokens: torch.Tensor, pos, tp: int,
               cache: attn.KVCache) -> Tuple[torch.Tensor, attn.KVCache]:
    """One decode step. tokens: (B,) int32; pos: int or (B,) int32."""
    attn.check_tp(tp)
    check_family(cfg)
    x = p["embed"][tokens.long()[:, None]]
    for i in range(cfg.n_layers):
        x, _ = _block_decode(cfg, tp, x, pos, _index(p["layers"], i),
                             _index(cache, i))
    x = rms_norm(x, p["final_norm"], cfg.rms_eps)
    return lm_head(cfg, p, x[:, -1]), cache
