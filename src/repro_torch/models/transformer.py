"""Transformer LM: the dense, moe, vlm and audio families.

The port of ``repro/models/transformer.py``.  One block = preRMS ->
attention -> residual -> preRMS -> FFN -> residual, the FFN being SwiGLU
(gelu-tanh for vlm) or the MoE FFN (models/moe.py, whose aux losses the
forward sums).  Layers are stacked on a leading axis L, as in the
reference's param tree, and iterated by a Python loop over per-layer views
(the reference's ``lax.scan``); under ``cfg.remat`` each block of a
differentiated forward is a ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint``), so its activations, the flash forward included, are
recomputed in the backward.

Frontends (stubs, as in the reference): vlm prepends projected patch
embeddings to the scaled token embeddings and attends prefix-LM
(bidirectional over the patches); audio projects frame embeddings,
replaces masked frames by ``mask_embed`` and attends bidirectionally.
:func:`loss_fn` is the reference's seq-chunked cross-entropy: next token
(vlm: over the text only), or masked prediction (audio).
:func:`forward_train_clients` runs K dense models at once, every param
with a leading client axis (the federated LM's client update: the
written-out form of the reference's ``vmap``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import PSpec, index_tree, rms_norm, swiglu
from repro_torch.runtime import sharding as shd


def _is_moe(cfg: ModelConfig) -> bool:
    return cfg.family == "moe"


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def param_specs(cfg: ModelConfig, tp: int) -> Dict[str, Any]:
    d, L = cfg.d_model, cfg.n_layers
    vp = cfg.padded_vocab(tp)
    layer: Dict[str, Any] = {
        "attn": attn.attn_specs(cfg, tp, prefix_layers=(L,)),
        "ln1": PSpec((L, d), ("layers", None), init="ones"),
        "ln2": PSpec((L, d), ("layers", None), init="ones"),
    }
    if _is_moe(cfg):
        layer["moe"] = moe_mod.moe_specs(cfg, tp, prefix_layers=(L,))
    else:
        layer["ffn"] = {
            "w_gate": PSpec((L, d, cfg.d_ff), ("layers", "fsdp", "tp")),
            "w_in": PSpec((L, d, cfg.d_ff), ("layers", "fsdp", "tp")),
            "w_out": PSpec((L, cfg.d_ff, d), ("layers", "tp", "fsdp")),
        }
    sp: Dict[str, Any] = {
        "embed": PSpec((vp, d), ("tp", "fsdp"), init="small"),
        "layers": layer,
        "final_norm": PSpec((d,), (None,), init="ones"),
    }
    if cfg.frontend != "none":
        sp["frontend_proj"] = PSpec((d, d), ("fsdp", None))
        if cfg.family == "audio":
            sp["mask_embed"] = PSpec((d,), (None,), init="small")
    if not cfg.tie_embeddings:
        sp["lm_head"] = PSpec((d, vp), ("fsdp", "tp"), init="small")
    return sp


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _ffn(cfg: ModelConfig, tp: int, lp, h: torch.Tensor
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(y, aux): the MoE FFN and its aux loss, or SwiGLU (gelu for vlm)
    and no aux."""
    if _is_moe(cfg):
        return moe_mod.moe_ffn(cfg, lp["moe"], h, tp)
    f = lp["ffn"]
    return swiglu(h, f["w_gate"], f["w_in"], f["w_out"],
                  act="gelu" if cfg.family == "vlm" else "silu"), None


def _block_train(cfg: ModelConfig, tp: int, prefix_len: int,
                 x: torch.Tensor, positions: torch.Tensor, lp):
    """One layer, full-sequence.  x: (..., S, d); ``lp``'s leaves
    broadcast against x's leading dims (a rank's FSDP shards are gathered
    here, inside the checkpointed function).  Returns (x, aux), aux None
    without MoE."""
    lp = shd.gather(lp)
    h = rms_norm(x, lp["ln1"], cfg.rms_eps)
    x = x + attn.full_attention(cfg, lp["attn"], h, positions, tp,
                                prefix_len)
    h = rms_norm(x, lp["ln2"], cfg.rms_eps)
    y, aux = _ffn(cfg, tp, lp, h)
    return x + y, aux


def _block_decode(cfg: ModelConfig, tp: int, x, pos, lp, cache):
    h = rms_norm(x, lp["ln1"], cfg.rms_eps)
    y, cache = attn.decode_attention(cfg, lp["attn"], h, pos, tp, cache)
    x = x + y
    h = rms_norm(x, lp["ln2"], cfg.rms_eps)
    return x + _ffn(cfg, tp, lp, h)[0], cache


def _block_prefill(cfg: ModelConfig, tp: int, prefix_len: int, x, positions,
                   lp, cache):
    h = rms_norm(x, lp["ln1"], cfg.rms_eps)
    y, cache = attn.prefill_attention(cfg, lp["attn"], h, positions, tp,
                                      cache, prefix_len)
    x = x + y
    h = rms_norm(x, lp["ln2"], cfg.rms_eps)
    return x + _ffn(cfg, tp, lp, h)[0], cache


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------

def _needs(cfg: ModelConfig, batch, key: str, what: str) -> torch.Tensor:
    """batch[key], or a ValueError naming it (the serving engine, which
    passes tokens only, meets this with a vlm or audio config)."""
    if key not in batch:
        raise ValueError(
            f"{cfg.name!r} (family {cfg.family}, frontend {cfg.frontend}) "
            f"needs batch[{key!r}], {what}; got keys {sorted(batch)}: "
            f"call lm.serve_prefill with it")
    return batch[key]


def embed_inputs(cfg: ModelConfig, p, batch: Dict[str, torch.Tensor], tp: int
                 ) -> Tuple[torch.Tensor, int]:
    """Returns (x (B,S,d), prefix_len).  vlm: the projected patch
    embeddings (B, Np, d), then the token embeddings times sqrt(d_model);
    prefix_len = Np.  audio: the projected frames (B, S, d), masked frames
    replaced by ``mask_embed``."""
    d = cfg.d_model
    if cfg.family == "vlm":
        patches = _needs(cfg, batch, "patch_embeds",
                         "the (B, Np, d_model) image patch embeddings")
        front = torch.matmul(patches, shd.gather(p["frontend_proj"]))
        tok = shd.gather(p["embed"])[batch["tokens"].long()] * (d ** 0.5)
        x = torch.cat([front.to(tok.dtype), tok], dim=1)
        return x, patches.shape[1]
    if cfg.family == "audio":
        frames = _needs(cfg, batch, "frames",
                        "the (B, S, d_model) audio frame embeddings")
        x = torch.matmul(frames, shd.gather(p["frontend_proj"]))
        if "mask" in batch:
            x = torch.where(batch["mask"].bool()[..., None], p["mask_embed"],
                            x)
        return x, 0
    return shd.gather(p["embed"])[batch["tokens"].long()], 0


def lm_head(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    w = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
    return torch.matmul(x, w)


def _run_layers(cfg: ModelConfig, tp: int, x: torch.Tensor, layers,
                take: Callable[[Any, int], Any], prefix_len: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every block over x (..., S, d); ``take(layers, i)`` is layer i's
    params.  Returns (x, the layers' aux losses summed).  A differentiated
    forward under ``cfg.remat`` checkpoints each block (the reference
    remats the scanned block)."""
    positions = torch.arange(x.shape[-2], dtype=torch.int32, device=x.device)
    remat = cfg.remat and cfg.scan_layers and torch.is_grad_enabled()
    auxes = []
    for i in range(cfg.n_layers):
        lp = take(layers, i)
        if remat:
            x, aux = checkpoint(_block_train, cfg, tp, prefix_len, x,
                                positions, lp, use_reentrant=False)
        else:
            x, aux = _block_train(cfg, tp, prefix_len, x, positions, lp)
        if aux is not None:
            auxes.append(aux)
    aux = (torch.stack(auxes).sum() if auxes else
           torch.zeros((), dtype=torch.float32, device=x.device))
    return x, aux


def forward_train(cfg: ModelConfig, p, batch, tp: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Returns (features (B,S,d), aux_loss, prefix_len)."""
    x, prefix_len = embed_inputs(cfg, p, batch, tp)
    x, aux = _run_layers(cfg, tp, x, p["layers"], index_tree, prefix_len)
    x = rms_norm(x, p["final_norm"], cfg.rms_eps)
    return x, aux, prefix_len


def _labels_and_mask(cfg: ModelConfig, batch, B: int, S: int,
                     prefix_len: int, device
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each family's targets: masked prediction of ``labels`` where
    ``mask`` (audio); the next text token after the prefix (vlm); the next
    token (dense, moe).  The last position has no target."""
    if cfg.family == "audio":
        return batch["labels"].long(), batch["mask"].float()
    tok = batch["tokens"].long()
    labels = F.pad(tok[:, 1:], (0, 1))
    if cfg.family == "vlm":
        labels = F.pad(labels, (prefix_len, 0))[:, :S]
        mask = torch.zeros((B, S), dtype=torch.float32, device=device)
        mask[:, prefix_len:-1] = 1.0
        return labels, mask
    return labels, F.pad(torch.ones((B, S - 1), dtype=torch.float32,
                                    device=device), (0, 1))


def loss_fn(cfg: ModelConfig, p, batch, tp: int, loss_chunk: int = 512
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's seq-chunked loss: the (B, S, V) logits never
    materialise at once, only one (B, loss_chunk, V) chunk of them
    (fp32).  Returns (ce + aux, {"ce_loss", "aux_loss"})."""
    x, aux, prefix_len = forward_train(cfg, p, batch, tp)
    B, S, _ = x.shape
    vp = cfg.padded_vocab(tp)
    labels, mask = _labels_and_mask(cfg, batch, B, S, prefix_len, x.device)
    C = min(loss_chunk, S)
    head_w = (shd.gather(p["embed"]).T if cfg.tie_embeddings
              else shd.gather(p["lm_head"]))
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
    call.  Dense family only: the federated LM (tiny_lm) is its one
    user."""
    if cfg.family != "dense":
        raise ValueError(
            f"forward_train_clients runs the dense family only (the "
            f"federated LM's client update); {cfg.name!r} is {cfg.family}")
    K = tokens.shape[0]
    rows = torch.arange(K, device=tokens.device)[:, None, None]
    x = p["embed"][rows, tokens.long()]                      # (K, B, S, d)
    x, _ = _run_layers(cfg, 1, x, p["layers"], _client_layer)
    x = rms_norm(x, _client_view(p["final_norm"]), cfg.rms_eps)
    w = p["embed"].transpose(1, 2) if cfg.tie_embeddings else p["lm_head"]
    return torch.matmul(x, _client_view(w)).float()


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, tp: int,
               dtype=torch.bfloat16, device=None) -> attn.KVCache:
    return attn.init_cache(cfg, batch, max_len, tp, dtype,
                           stacked=cfg.n_layers, device=device)


def serve_prefill(cfg, p, batch, tp: int, cache: attn.KVCache,
                  last_pos: Optional[torch.Tensor] = None):
    """Process the prompt; returns (last-position logits (B, V), cache),
    the stacked cache written in place.

    ``last_pos`` ((B,) int32, optional) serves *left-aligned* padded
    prompt batches: logits are gathered at each slot's own last real token
    and cache rows written past it are invalidated (``positions = -1``), so
    decode never attends the right-padding.  It indexes the embedded
    sequence: for vlm, the patches come first.
    """
    x, prefix_len = embed_inputs(cfg, p, batch, tp)
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    for i in range(cfg.n_layers):
        x, _ = _block_prefill(cfg, tp, prefix_len, x, positions,
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
    x = p["embed"][tokens.long()[:, None]]
    if cfg.family == "vlm":
        x = x * (cfg.d_model ** 0.5)
    for i in range(cfg.n_layers):
        x, _ = _block_decode(cfg, tp, x, pos, index_tree(p["layers"], i),
                             index_tree(cache, i))
    x = rms_norm(x, p["final_norm"], cfg.rms_eps)
    return lm_head(cfg, p, x[:, -1]), cache
