"""Transformer LM, dense family: forward, batched prefill and decode.

The port of ``repro/models/transformer.py`` for ``family="dense"``.  One
block = preRMS -> attention -> residual -> preRMS -> SwiGLU -> residual.
Layers are stacked on a leading axis L, as in the reference's param tree,
and iterated by a Python loop over per-layer views (the reference's
``lax.scan``); under ``cfg.remat`` each block of a differentiated forward
is a ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``), so
its activations, the flash forward included, are recomputed in the
backward.  :func:`loss_fn` is the reference's seq-chunked causal-LM
cross-entropy.  :func:`forward_train_clients` runs K models at once, every
param with a leading client axis (the federated LM's client update: the
written-out form of the reference's ``vmap``; projections are batched
matmuls over K, and attention folds K into its batch dim).  The MoE family
and the vlm/audio frontends are not ported yet (ROADMAP A17) and raise.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import PSpec, index_tree, rms_norm, swiglu

PORTED_FAMILIES = ("dense",)


def check_family(cfg: ModelConfig) -> None:
    """Of the transformer families only dense is ported; moe and the
    vlm/audio frontends raise naming ROADMAP A17.  (The ssm and hybrid
    families never reach this module: models/lm.py dispatches them to
    rwkv6.py and zamba2.py, as the reference does.)"""
    if cfg.family not in PORTED_FAMILIES or cfg.frontend != "none":
        raise NotImplementedError(
            f"model family {cfg.family!r} (frontend {cfg.frontend!r}) of "
            f"{cfg.name!r} is not ported to the PyTorch package yet (ROADMAP "
            f"A17); ported: dense decoders without a frontend, and the "
            f"ssm (rwkv6) and hybrid (zamba2) families through models/lm.py")


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
    """One layer, full-sequence.  x: (..., S, d); ``lp``'s leaves
    broadcast against x's leading dims."""
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


def _run_layers(cfg: ModelConfig, tp: int, x: torch.Tensor, layers,
                take: Callable[[Any, int], Any]) -> torch.Tensor:
    """Every block over x (..., S, d); ``take(layers, i)`` is layer i's
    params.  A differentiated forward under ``cfg.remat`` checkpoints each
    block (the reference remats the scanned block)."""
    positions = torch.arange(x.shape[-2], dtype=torch.int32, device=x.device)
    remat = cfg.remat and cfg.scan_layers and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        lp = take(layers, i)
        if remat:
            x = checkpoint(_block_train, cfg, tp, x, positions, lp,
                           use_reentrant=False)
        else:
            x = _block_train(cfg, tp, x, positions, lp)
    return x


def forward_train(cfg: ModelConfig, p, batch, tp: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Returns (features (B,S,d), aux_loss, prefix_len), prefix_len 0."""
    attn.check_tp(tp)
    x = embed_inputs(cfg, p, batch, tp)
    x = _run_layers(cfg, tp, x, p["layers"], index_tree)
    x = rms_norm(x, p["final_norm"], cfg.rms_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device), 0


def loss_fn(cfg: ModelConfig, p, batch, tp: int, loss_chunk: int = 512
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal-LM loss with a seq-chunked head (the reference's
    ``loss_fn``): labels are the tokens shifted left, the last position
    masked; the (B, S, V) logits never materialise at once, only one
    (B, loss_chunk, V) chunk of them (fp32).  Returns (loss, {"ce_loss",
    "aux_loss"})."""
    x, aux, _ = forward_train(cfg, p, batch, tp)
    B, S, _ = x.shape
    vp = cfg.padded_vocab(tp)
    tok = batch["tokens"].long()
    labels = F.pad(tok[:, 1:], (0, 1))
    mask = F.pad(torch.ones((B, S - 1), dtype=torch.float32,
                            device=x.device), (0, 1))
    C = min(loss_chunk, S)
    head_w = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    bias = None
    if vp > cfg.vocab_size:
        bias = torch.cat([
            torch.zeros((cfg.vocab_size,), dtype=torch.float32,
                        device=x.device),
            torch.full((vp - cfg.vocab_size,), -1e9, dtype=torch.float32,
                       device=x.device)])
    nll_sums, m_sums = [], []
    for c0 in range(0, S - S % C, C):
        logits = torch.matmul(x[:, c0:c0 + C], head_w).float()
        if bias is not None:
            logits = logits + bias
        lc, mc = labels[:, c0:c0 + C], mask[:, c0:c0 + C]
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, lc[..., None])[..., 0]
        nll_sums.append(((lse - gold) * mc).sum())
        m_sums.append(mc.sum())
    loss = torch.stack(nll_sums).sum() / torch.stack(m_sums).sum().clamp_min(
        1.0)
    return loss + aux, {"ce_loss": loss, "aux_loss": aux}


def _client_view(leaf: torch.Tensor, rank: int = 4) -> torch.Tensor:
    """A (K, *shape) client-stacked leaf padded with unit dims after K to
    ``rank``, so that it broadcasts against x (K, B, S, d): a matrix as
    (K, 1, d, out) in a batched matmul, a vector as (K, 1, 1, d)."""
    K, shape = leaf.shape[0], tuple(leaf.shape[1:])
    return leaf.reshape((K,) + (1,) * (rank - 1 - len(shape)) + shape)


def _client_layer(layers, i: int):
    return {k: (_client_layer(v, i) if isinstance(v, dict)
                else _client_view(v[:, i]))
            for k, v in layers.items()}


def forward_train_clients(cfg: ModelConfig, p, tokens: torch.Tensor
                          ) -> torch.Tensor:
    """K models at once: every leaf of ``p`` carries a leading client
    axis K (the reference's param tree under ``vmap``); tokens (K, B, S)
    -> logits (K, B, S, V) fp32.  Attention runs as one (K*B)-batch
    call."""
    check_family(cfg)
    K = tokens.shape[0]
    rows = torch.arange(K, device=tokens.device)[:, None, None]
    x = p["embed"][rows, tokens.long()]                      # (K, B, S, d)
    x = _run_layers(cfg, 1, x, p["layers"], _client_layer)
    x = rms_norm(x, _client_view(p["final_norm"]), cfg.rms_eps)
    w = p["embed"].transpose(1, 2) if cfg.tie_embeddings else p["lm_head"]
    return torch.matmul(x, _client_view(w)).float()


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
        x, _ = _block_prefill(cfg, tp, x, positions,
                              index_tree(p["layers"], i), index_tree(cache, i))
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
        x, _ = _block_decode(cfg, tp, x, pos, index_tree(p["layers"], i),
                             index_tree(cache, i))
    x = rms_norm(x, p["final_norm"], cfg.rms_eps)
    return lm_head(cfg, p, x[:, -1]), cache
