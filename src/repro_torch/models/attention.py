"""GQA/MQA attention: chunked full/windowed prefill + cached decode.

The port of ``repro/models/attention.py``.  At ``tp > 1`` it computes
what the reference computes on one device: query heads padded to
``cfg.padded_heads(tp)`` (zero-initialised nowhere: the padded heads are
ordinary heads of the wider projection), the KV layout by
``cfg.kv_sharded(tp)``, and the ``reference`` backend; the reference's
sharding annotations are layouts (runtime/sharding.py).

  * Full-sequence attention (train / prefill) takes one of two backends
    (:func:`resolve_attention_backend`): ``flash`` routes through the
    kernel layer (:func:`repro_torch.kernels.ops.attention`: the CUDA flash
    kernel on the card, the blocked torch path on the CPU); ``reference``
    is the chunked softmax below, sliding-window configs slicing a
    (W + C)-slab of K/V per query chunk.  A prefix-LM mask (the vlm
    family: bidirectional over the image prefix, causal after it) takes
    the blocked path on every device, the reference's own rule: the flash
    kernel knows causal and window masks only.
  * Decode writes each slot's new K/V row at ``pos % T`` (a ring for
    sliding-window configs) and attends over the rows whose stored absolute
    position is valid for that slot.
  * The KV cache is updated in place (and returned): serving a 7B model
    keeps one cache, never a second copy per step.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ATTENTION_BACKENDS, ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.common import PSpec, apply_rope

NEG_INF = -1e9


def resolve_attention_backend(cfg: ModelConfig, tp: int) -> str:
    """``cfg.attention_backend`` -> the backend used: ``reference`` when
    asked for by name (or under tensor parallelism, as in the reference),
    ``flash`` otherwise."""
    be = getattr(cfg, "attention_backend", "auto")
    if be not in ATTENTION_BACKENDS:
        raise ValueError(
            f"unknown attention_backend {be!r}; expected one of "
            f"{ATTENTION_BACKENDS}")
    if be == "reference" or tp > 1:
        return "reference"
    return "flash"


def _exact_attend(cfg: ModelConfig) -> bool:
    """The broadcast-and-sum ``_attend`` formulation iff the config asked
    for the reference backend by name (as the reference does)."""
    return getattr(cfg, "attention_backend", "auto") == "reference"


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def attn_specs(cfg: ModelConfig, tp: int, prefix_layers: Tuple[int, ...] = ()
               ) -> Dict[str, PSpec]:
    """Param specs for one attention block (optionally stacked over layers)."""
    d, hd, kv = cfg.d_model, cfg.head_dim, cfg.n_kv_heads
    hp = cfg.padded_heads(tp)
    kv_ax = "tp" if cfg.kv_sharded(tp) else None
    L = prefix_layers
    lax_ = tuple("layers" for _ in L)
    sp = {
        "wq": PSpec(L + (d, hp * hd), lax_ + ("fsdp", "tp")),
        "wk": PSpec(L + (d, kv * hd), lax_ + ("fsdp", kv_ax)),
        "wv": PSpec(L + (d, kv * hd), lax_ + ("fsdp", kv_ax)),
        "wo": PSpec(L + (hp * hd, d), lax_ + ("tp", "fsdp")),
    }
    if cfg.qkv_bias:
        sp["bq"] = PSpec(L + (hp * hd,), lax_ + ("tp",), init="zeros")
        sp["bk"] = PSpec(L + (kv * hd,), lax_ + (kv_ax,), init="zeros")
        sp["bv"] = PSpec(L + (kv * hd,), lax_ + (kv_ax,), init="zeros")
    return sp


def cache_axes(cfg: ModelConfig, tp: int) -> Tuple[Optional[str], ...]:
    """Logical axes of a (B, T, kv, hd) KV cache slab."""
    if cfg.kv_sharded(tp):
        return ("cache_batch", None, "tp", None)
    return ("cache_batch", "kv_seq", None, None)


class KVCache(NamedTuple):
    """Per-layer KV cache. k/v: (B, T, kv, hd); positions: (B, T) int32,
    the absolute position stored in each slot (-1 empty).  With a leading
    layer axis when stacked.  For sliding-window configs T == window and
    writes wrap (ring buffer)."""
    k: torch.Tensor
    v: torch.Tensor
    positions: torch.Tensor


def init_cache(cfg: ModelConfig, batch: int, max_len: int, tp: int,
               dtype=torch.bfloat16, stacked: int = 0,
               device: Optional[torch.device] = None) -> KVCache:
    T = min(max_len, cfg.swa_window) if cfg.swa_window else max_len
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    lead = (stacked,) if stacked else ()
    k = torch.zeros(lead + (batch, T, kv, hd), dtype=dtype, device=device)
    v = torch.zeros_like(k)   # distinct from k: the cache is written in place
    pos = torch.full(lead + (batch, T), -1, dtype=torch.int32, device=device)
    return KVCache(k=k, v=v, positions=pos)


# ---------------------------------------------------------------------------
# core math
# ---------------------------------------------------------------------------

def _project_qkv(cfg: ModelConfig, p, x: torch.Tensor,
                 positions: torch.Tensor, tp: int):
    """x: (..., S, d) -> q: (..., S, kv, G, hd), k/v: (..., S, kv, hd),
    RoPE applied.  Weights may carry leading dims that broadcast against
    x's (the client-stacked federated LM: (K, 1, d, out) against x (K, B,
    S, d))."""
    hd, kv = cfg.head_dim, cfg.n_kv_heads
    hp = cfg.padded_heads(tp)
    q = torch.matmul(x, p["wq"])
    k = torch.matmul(x, p["wk"])
    v = torch.matmul(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(*q.shape[:-1], hp, hd)
    k = k.reshape(*k.shape[:-1], kv, hd)
    v = v.reshape(*v.shape[:-1], kv, hd)
    if cfg.causal or cfg.family in ("audio",):  # RoPE everywhere
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = q.reshape(*q.shape[:-2], kv, hp // kv, hd)
    return q, k, v


def _attend(q, k, v, mask, exact: bool = False):
    """q: (B,C,kv,G,hd), k/v: (B,T,kv,hd), mask: (B|1,C,T) bool ->
    (B,C,kv,G,hd).  Logits and softmax in fp32; ``probs`` are cast to
    ``v``'s dtype before the PV product, as in the reference.

    ``exact`` evaluates both contractions as broadcast-multiply and sum
    (the reference's shape-stable form) instead of ``einsum``.  A row whose
    mask is all false (an idle decode slot) gets a uniform softmax, not NaN.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    if exact:
        qx = q.permute(0, 2, 3, 1, 4)[:, :, :, :, None, :]  # (B,kv,G,C,1,hd)
        kx = k.permute(0, 2, 1, 3)[:, :, None, None, :, :]  # (B,kv,1,1,T,hd)
        logits = (qx * kx).float().sum(dim=-1) * scale
        logits = torch.where(mask[:, None, None], logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        vx = v.permute(0, 2, 1, 3)[:, :, None, None, :, :]  # (B,kv,1,1,T,hd)
        out = (probs[..., None] * vx).sum(dim=-2)           # (B,kv,G,C,hd)
        return out.permute(0, 3, 1, 2, 4)
    logits = torch.einsum("bckgh,btkh->bkgct", q, k).float() * scale
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bkgct,btkh->bckgh", probs, v)


def _attention_core(cfg: ModelConfig, q, k, v, positions: torch.Tensor,
                    tp: int, prefix_len: int = 0) -> torch.Tensor:
    """Full-sequence attention of projected q (..., S, kv, G, hd) and k/v
    (..., S, kv, hd) -> (..., S, H*hd), before the output projection; the
    leading dims are folded into one batch dim (attention has no
    weights).  The mask is causal or bidirectional, with an optional
    window; a causal mask with ``prefix_len > 0`` is a prefix-LM mask
    (every query also sees the first ``prefix_len`` keys)."""
    lead = q.shape[:-4]
    q = q.reshape(-1, *q.shape[-4:])
    k = k.reshape(-1, *k.shape[-3:])
    v = v.reshape(-1, *v.shape[-3:])
    B, S = q.shape[:2]
    C = min(cfg.attn_chunk, S)
    W = cfg.swa_window

    if resolve_attention_backend(cfg, tp) == "flash":
        # kernel-layer contract: q (B, S, H, hd), k/v (B, S, kv, hd); q's
        # (kv, G) grouping flattens kv-major, the kernels' GQA mapping
        qf = q.reshape(B, S, -1, cfg.head_dim)
        # the flash kernel has no prefix-LM mask: a prefix goes to the
        # blocked path on every device, as in the reference
        impl = "blocked" if prefix_len else "auto"
        out = kops.attention(qf, k, v, causal=cfg.causal, window=W,
                             impl=impl, block=C, prefix_len=prefix_len)
        return out.reshape(*lead, S, -1)

    def block_mask(pos_q, pos_kv):
        m = torch.ones((pos_q.shape[0], pos_kv.shape[0]), dtype=torch.bool,
                       device=pos_q.device)
        if cfg.causal:
            m = pos_q[:, None] >= pos_kv[None, :]
            if prefix_len:  # prefix-LM: bidirectional over the prefix
                m = m | (pos_kv[None, :] < prefix_len)
        if W is not None:
            m = m & (pos_q[:, None] - pos_kv[None, :] < W)
        return m

    exact = _exact_attend(cfg)
    if S <= C:
        out = _attend(q, k, v, block_mask(positions, positions)[None],
                      exact=exact)
    else:
        dev = q.device
        slab = W + C if W is not None and W + C < S else None
        outs = []
        for s0 in range(0, S, C):
            s1 = min(s0 + C, S)
            pq = torch.arange(s0, s1, device=dev)
            if slab is not None:
                # windowed: only a (W + C)-slab of K/V is live per chunk
                start = min(max(s0 + C - slab, 0), S - slab)
                ks, vs = k[:, start:start + slab], v[:, start:start + slab]
                pkv = torch.arange(start, start + slab, device=dev)
            else:
                ks, vs, pkv = k, v, positions
            outs.append(_attend(q[:, s0:s1], ks, vs,
                                block_mask(pq, pkv)[None], exact=exact))
        out = torch.cat(outs, dim=1)
    return out.reshape(*lead, S, -1)


def full_attention(cfg: ModelConfig, p, x: torch.Tensor,
                   positions: torch.Tensor, tp: int, prefix_len: int = 0
                   ) -> torch.Tensor:
    """Full-sequence attention (train / prefill). x: (B, S, d)."""
    q, k, v = _project_qkv(cfg, p, x, positions, tp)
    out = _attention_core(cfg, q, k, v, positions, tp, prefix_len)
    return torch.matmul(out, p["wo"])


def prefill_attention(cfg: ModelConfig, p, x, positions, tp: int,
                      cache: KVCache, prefix_len: int = 0
                      ) -> Tuple[torch.Tensor, KVCache]:
    """Full attention + write this segment's K/V into the (per-layer)
    cache, in place: positions 0..S-1, the last min(S, T) of them kept,
    placed at slot ``pos % T`` (the reference's pad-then-roll)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x, positions, tp)
    out = torch.matmul(
        _attention_core(cfg, q, k, v, positions, tp, prefix_len), p["wo"])
    T = cache.k.shape[1]
    keep = min(S, T)
    k, v = k[:, -keep:], v[:, -keep:]
    pos_tail = torch.arange(S - keep, S, dtype=torch.int32, device=x.device)
    if keep < T:  # right-pad empty slots
        pad = (0, 0, 0, 0, 0, T - keep)
        k = torch.nn.functional.pad(k, pad)
        v = torch.nn.functional.pad(v, pad)
        pos_tail = torch.nn.functional.pad(pos_tail, (0, T - keep), value=-1)
    shift = (S - keep) % T  # first kept position lands at this slot
    if shift:
        k = torch.roll(k, shift, dims=1)
        v = torch.roll(v, shift, dims=1)
        pos_tail = torch.roll(pos_tail, shift)
    cache.k.copy_(k)
    cache.v.copy_(v)
    cache.positions.copy_(pos_tail[None, :].expand(B, T))
    return out, cache


def decode_attention(cfg: ModelConfig, p, x: torch.Tensor, pos, tp: int,
                     cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode. x: (B, 1, d); pos: int, or (B,) int32 per-slot
    positions (a recycled slot restarts at 0 while its neighbours keep
    decoding).  Writes each slot's row at ``pos % T`` in place."""
    B = x.shape[0]
    T = cache.k.shape[1]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device)
    pos_b = pos.expand(B) if pos.dim() == 0 else pos               # (B,)
    q, k, v = _project_qkv(cfg, p, x, pos_b[:, None], tp)  # q:(B,1,kv,G,hd)

    rows = torch.arange(B, device=x.device)
    slot = (pos_b % T).long()
    cache.k[rows, slot] = k[:, 0].to(cache.k.dtype)
    cache.v[rows, slot] = v[:, 0].to(cache.v.dtype)
    cache.positions[rows, slot] = pos_b
    cpos = cache.positions

    valid = (cpos >= 0) & (cpos <= pos_b[:, None])
    if cfg.swa_window is not None:
        valid = valid & (cpos > pos_b[:, None] - cfg.swa_window)
    out = _attend(q, cache.k.to(x.dtype), cache.v.to(x.dtype),
                  valid[:, None, :], exact=_exact_attend(cfg))
    y = torch.matmul(out.reshape(B, 1, -1), p["wo"])
    return y, cache
