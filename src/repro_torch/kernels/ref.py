"""Plain PyTorch versions of the port's kernels.

The CPU path of every kernel wrapper, and the yardstick the CUDA kernels
are held against on the card (chip_smoke.py).  The codec's repeats its
kernel's arithmetic exactly, so that comparison is bitwise.  Attention has
two: :func:`blocked_attention`, the streaming CPU path of the kernel's
wrapper (``repro/kernels/ops.py`` ``blocked_attention``), and
:func:`attention`, the materialised oracle of the reference
(``repro/kernels/ref.py``) the kernel is held to within a tolerance.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

BLOCK = 256


def qmax(bits: int) -> int:
    return (1 << (bits - 1)) - 1


def code_dtype(bits: int) -> torch.dtype:
    return torch.int8 if bits <= 8 else torch.int16


def compress_blocks(x: torch.Tensor, bits: int = 8):
    """x: flat (n,) float32 -> (q (ceil(n/256), 256) int8|int16,
    scale (ceil(n/256), 1) float32); the ragged tail reads as zeros.

    ``scale = max(max|x| * fl32(1/qmax), 1e-30)`` is the reciprocal-multiply
    form XLA compiles ``max|x| / qmax`` into under jit; ``x / scale`` is a
    true division and ``torch.round`` rounds half to even, as jnp.round does.
    """
    n = x.numel()
    nb = -(-n // BLOCK)
    blocks = F.pad(x, (0, nb * BLOCK - n)).reshape(nb, BLOCK)
    q_max = qmax(bits)
    one = torch.ones((), dtype=torch.float32, device=x.device)
    inv = one / float(q_max)            # correctly rounded f32 reciprocal
    floor = torch.full((), 1e-30, dtype=torch.float32, device=x.device)
    # torch.maximum propagates NaN, as jnp.maximum does
    scale = torch.maximum(blocks.abs().amax(dim=1, keepdim=True) * inv, floor)
    q = torch.clamp(torch.round(blocks / scale), -q_max, q_max)
    return q.to(code_dtype(bits)), scale


def decompress_blocks(q: torch.Tensor, scale: torch.Tensor, n: int
                      ) -> torch.Tensor:
    """Inverse of :func:`compress_blocks`: the first ``n`` values of
    ``float(q) * scale``, flat."""
    return (q.to(torch.float32) * scale).reshape(-1)[:n]


# --- attention ---------------------------------------------------------------

NEG_INF = -1e30   # the reference kernel's mask value


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: Optional[int] = None
              ) -> torch.Tensor:
    """q: (BH, S, hd); k/v: (BH, T, hd) -> (BH, S, hd).  The full (S, T)
    logits, fp32 inside, masked logits -1e30, output in q's dtype."""
    S, T = q.shape[1], k.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bsh,bth->bst", q.float(), k.float()) * scale
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bst,bth->bsh", probs, v.float()).to(q.dtype)


def attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, window: Optional[int] = None
                  ) -> torch.Tensor:
    """:func:`attention` in the kernel's layout: q (B, S, H, hd), k/v
    (B, T, KV, hd) -> (B, S, H, hd); query head h reads KV head h // G."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qf = q.transpose(1, 2).reshape(B * H, S, hd)
    kf = k.repeat_interleave(G, dim=2).transpose(1, 2).reshape(B * H, T, hd)
    vf = v.repeat_interleave(G, dim=2).transpose(1, 2).reshape(B * H, T, hd)
    out = attention(qf, kf, vf, causal=causal, window=window)
    return out.reshape(B, H, S, hd).transpose(1, 2)


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, window: Optional[int] = None,
                      block: int = 64, prefix_len: int = 0) -> torch.Tensor:
    """Flash-style streaming attention in plain torch ops (any device).

    The same contract and masks as the flash kernel (plus the prefix-LM
    mask), processed in query blocks of ``block`` rows: each block
    touches only the K/V rows it can see (causal upper bound, window lower
    bound), so the (S, T) logits never materialise.  Masks are built on the
    host per block, and a block that sees all its keys skips the mask.
    """
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / (hd ** 0.5)
    C = min(block, S)
    n = -(-S // C)
    out_blocks = []
    for i in range(n):
        s0, s1 = i * C, min((i + 1) * C, S)
        hi = T
        if causal and not prefix_len:
            hi = min(s1, T)
        lo = 0
        if window is not None:
            lo = max(0, s0 + 1 - window)
        qi = q[:, s0:s1].float() * scale                  # (B, c, H, hd)
        qi = qi.reshape(B, s1 - s0, KV, G, hd)            # kv-major grouping
        ki = k[:, lo:hi].float()                          # (B, t, KV, hd)
        vi = v[:, lo:hi].float()
        logits = torch.einsum("bckgd,btkd->bckgt", qi, ki)
        qpos = torch.arange(s0, s1)[:, None]
        kpos = torch.arange(lo, hi)[None, :]
        mask = None
        if causal:
            m = qpos >= kpos
            if prefix_len:
                m = m | (kpos < prefix_len)
            mask = m
        if window is not None:
            m = (qpos - kpos) < window
            mask = m if mask is None else (mask & m)
        if mask is not None and not bool(mask.all()):
            logits = torch.where(mask.to(q.device)[None, :, None, None, :],
                                 logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        o = torch.einsum("bckgt,btkd->bckgd", probs, vi)
        out_blocks.append(o.reshape(B, s1 - s0, H, hd))
    out = out_blocks[0] if n == 1 else torch.cat(out_blocks, dim=1)
    return out.to(q.dtype)
