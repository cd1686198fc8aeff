"""Zamba2 hybrid: Mamba2 backbone + ONE shared attention block applied every
``attn_every`` layers with the same weights (Zamba2's parameter sharing).

The port of ``repro/models/zamba2.py`` (training, prefill and decode) at
tensor parallelism 1.  The backbone runs groups of ``attn_every`` Mamba2
layers (models/mamba2.py; the SSD kernel B4 on a prompt), and between
groups the shared full-attention (+SwiGLU) block runs with the port's
attention (models/attention.py; the flash kernel B2 on a prompt).  Decode
carries per-layer Mamba states plus one KV cache per shared-block
application point, stacked ``(n_apps, ...)``; every state and KV row is
written in place into the stacked cache.

Training (:func:`loss_fn`) runs the backbone from the zero state with no
cache (the SSD scan through ``ssd.SSDScan``, whose backward is a kernel on
the card), each mamba2 block under ``torch.utils.checkpoint`` when
``cfg.remat``, and the shared block through the differentiable flash
attention, not checkpointed, as in the reference; :func:`_chunked_ce` is
the reference's seq-chunked cross-entropy, which rwkv6's loss shares.

Simplifications vs. the released checkpoints (the reference's, recorded
in DESIGN.md): the shared block consumes the running stream x rather than
concat(x, x_emb), and per-application LoRA deltas are omitted.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba2
from repro_torch.models.common import PSpec, index_tree, rms_norm, swiglu
from repro_torch.runtime import sharding as shd


def n_attn_apps(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.attn_every


def param_specs(cfg: ModelConfig, tp: int) -> Dict[str, Any]:
    d, L = cfg.d_model, cfg.n_layers
    vp = cfg.padded_vocab(tp)
    return {
        "embed": PSpec((vp, d), ("tp", "fsdp"), init="small"),
        "backbone": mamba2.layer_specs(cfg, tp, L),
        "shared": {
            "attn": attn.attn_specs(cfg, tp),
            "ln1": PSpec((d,), (None,), init="ones"),
            "ln2": PSpec((d,), (None,), init="ones"),
            "ffn": {
                "w_gate": PSpec((d, cfg.d_ff), ("fsdp", "tp")),
                "w_in": PSpec((d, cfg.d_ff), ("fsdp", "tp")),
                "w_out": PSpec((cfg.d_ff, d), ("tp", "fsdp")),
            },
        },
        "final_norm": PSpec((d,), (None,), init="ones"),
        "lm_head": PSpec((d, vp), ("fsdp", "tp"), init="small"),
    }


class ZambaCache(NamedTuple):
    mamba: mamba2.MambaState      # stacked (L, ...)
    kv: attn.KVCache              # stacked (n_apps, ...)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, tp: int,
               dtype=torch.bfloat16, device=None) -> ZambaCache:
    return ZambaCache(
        mamba=mamba2.init_state(cfg, batch, stacked=cfg.n_layers,
                                device=device),
        kv=attn.init_cache(cfg, batch, max_len, tp, dtype,
                           stacked=n_attn_apps(cfg), device=device),
    )


def _shared_block(cfg, sp, x, positions, tp, mode, kv_cache, pos=None):
    """The shared attention + SwiGLU block; ``kv_cache`` is this
    application's (B, T, kv, hd) views, written in place (None in
    training)."""
    h = rms_norm(x, sp["ln1"], cfg.rms_eps)
    if mode == "train":
        y = attn.full_attention(cfg, sp["attn"], h, positions, tp)
    elif mode == "prefill":
        y, _ = attn.prefill_attention(cfg, sp["attn"], h, positions, tp,
                                      kv_cache)
    else:
        y, _ = attn.decode_attention(cfg, sp["attn"], h, pos, tp, kv_cache)
    x = x + y
    h = rms_norm(x, sp["ln2"], cfg.rms_eps)
    f = sp["ffn"]
    return x + swiglu(h, f["w_gate"], f["w_in"], f["w_out"])


def _train_block(cfg: ModelConfig, tp: int, x, lp):
    return mamba2.block(cfg, shd.gather(lp), x, None, tp, False)[0]


def _run(cfg: ModelConfig, p, x, tp: int, mode: str,
         cache: Optional[ZambaCache] = None, pos=None) -> torch.Tensor:
    """Shared forward of ``train``, ``prefill`` and ``decode``. x:
    (B,S,d).  Serving writes every layer's state and every application's
    KV rows into ``cache`` in place; training takes no cache and writes
    nothing, each mamba2 block checkpointed under ``cfg.remat`` (the
    reference remats the scanned block, not the shared one); returns x.
    Under FSDP (a train step's shards) each mamba2 block gathers its
    layer inside the checkpointed function, and the shared block is
    gathered once: autograd sums its gradient over the applications
    before the one reduce-scatter, and one whole copy lives (the
    applications' matmuls would each save theirs if gathered each
    time)."""
    every = cfg.attn_every
    single = mode == "decode"
    train = mode == "train"
    remat = train and cfg.remat and torch.is_grad_enabled()
    positions = None if single else torch.arange(
        x.shape[1], dtype=torch.int32, device=x.device)
    shared = shd.gather(p["shared"])
    for g in range(n_attn_apps(cfg)):
        for j in range(g * every, (g + 1) * every):
            lp = index_tree(p["backbone"], j)
            if remat:
                x = checkpoint(_train_block, cfg, tp, x, lp,
                               use_reentrant=False)
            elif train:
                x = _train_block(cfg, tp, x, lp)
            else:
                x, _ = mamba2.block(cfg, lp, x, index_tree(cache.mamba, j),
                                    tp, single)
        x = _shared_block(cfg, shared, x, positions, tp, mode,
                          None if train else index_tree(cache.kv, g), pos)
    return x


def loss_fn(cfg: ModelConfig, p, batch, tp: int):
    """Next-token cross-entropy of a (B, S) ``tokens`` batch; returns
    (loss, {"ce_loss", "aux_loss"}) (aux 0: every family of the port logs
    both)."""
    x = shd.gather(p["embed"])[batch["tokens"].long()]
    x = _run(cfg, p, x, tp, "train")
    x = rms_norm(x, p["final_norm"], cfg.rms_eps)
    return _chunked_ce(cfg, x, shd.gather(p["lm_head"]), batch["tokens"],
                       tp)


def _chunked_ce(cfg: ModelConfig, x: torch.Tensor, head_w: torch.Tensor,
                tokens: torch.Tensor, tp: int, loss_chunk: int = 512):
    """The reference's seq-chunked cross-entropy over features x (B, S,
    d): the next token's, the last position masked, one (B, loss_chunk,
    V) chunk of fp32 logits at a time, a -1e9 bias on the padded vocab."""
    B, S, _ = x.shape
    vp = cfg.padded_vocab(tp)
    labels = F.pad(tokens[:, 1:].long(), (0, 1))
    mask = F.pad(torch.ones((B, S - 1), dtype=torch.float32,
                            device=x.device), (0, 1))
    C = min(loss_chunk, S)
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
    return loss, {"ce_loss": loss,
                  "aux_loss": torch.zeros((), dtype=torch.float32,
                                          device=x.device)}


def serve_prefill(cfg: ModelConfig, p, batch, tp: int, cache: ZambaCache):
    """Process the prompt from ``cache``'s state; returns (last-position
    logits (B, V), cache), the cache written in place."""
    x = p["embed"][batch["tokens"].long()]
    x = _run(cfg, p, x, tp, "prefill", cache)
    x = rms_norm(x, p["final_norm"], cfg.rms_eps)
    return torch.matmul(x[:, -1], p["lm_head"]), cache


def serve_step(cfg: ModelConfig, p, tokens: torch.Tensor, pos, tp: int,
               cache: ZambaCache):
    """One decode step. tokens: (B,) int32; pos: int or (B,) int32."""
    x = p["embed"][tokens.long()[:, None]]
    x = _run(cfg, p, x, tp, "decode", cache, pos=pos)
    x = rms_norm(x, p["final_norm"], cfg.rms_eps)
    return torch.matmul(x[:, -1], p["lm_head"]), cache
