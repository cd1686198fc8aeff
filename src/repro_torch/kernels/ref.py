"""Plain PyTorch versions of the port's kernels.

The CPU path of every kernel wrapper, and the yardstick the CUDA kernels
are held against on the card (chip_smoke.py).  The codec's repeats its
kernel's arithmetic exactly, so that comparison is bitwise.  Attention has
two: :func:`blocked_attention`, the streaming CPU path of the kernel's
wrapper (``repro/kernels/ops.py`` ``blocked_attention``), and
:func:`attention`, the materialised oracle of the reference
(``repro/kernels/ref.py``) the kernel is held to within a tolerance; its
backward kernel has :func:`blocked_attention_backward`.  So
have the two chunk scans: the token-level oracles :func:`wkv6` and
:func:`ssd`, and the chunked forms with a state in and out,
:func:`wkv6_chunked` and :func:`ssd_chunked` (the models' own chunk scans,
which are the CPU path of the scan kernels' wrappers).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

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


def roundtrip_blocks(leaves: Sequence[torch.Tensor], bits: int = 8
                     ) -> List[torch.Tensor]:
    """decompress(compress(x)) of each flat float32 leaf: the link's lossy
    step, leaf by leaf."""
    return [decompress_blocks(*compress_blocks(x, bits), x.numel())
            for x in leaves]


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


def _block_span(s0: int, s1: int, T: int, causal: bool,
                window: Optional[int], prefix_len: int = 0) -> Tuple[int, int]:
    """The keys [lo, hi) query rows [s0, s1) can see, as a block."""
    hi = min(s1, T) if causal and not prefix_len else T
    lo = max(0, s0 + 1 - window) if window is not None else 0
    return lo, max(lo, hi)   # empty when the rows see no key


def _block_mask(s0: int, s1: int, lo: int, hi: int, causal: bool,
                window: Optional[int], prefix_len: int = 0):
    """(s1 - s0, hi - lo) bool visibility of a block, or None when every
    key of the span is visible to every row."""
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
    if mask is not None and bool(mask.all()):
        return None
    return mask


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, window: Optional[int] = None,
                      block: int = 64, prefix_len: int = 0,
                      return_lse: bool = False):
    """Flash-style streaming attention in plain torch ops (any device).

    The same contract and masks as the flash kernel (plus the prefix-LM
    mask), processed in query blocks of ``block`` rows: each block
    touches only the K/V rows it can see (causal upper bound, window lower
    bound), so the (S, T) logits never materialise.  Masks are built on the
    host per block, and a block that sees all its keys skips the mask.

    ``return_lse`` also returns each row's log-sum-exp over the keys it
    sees, float32 (B, H, S), -inf for a row that sees none (the kernel's
    forward writes the same for the backward).
    """
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / (hd ** 0.5)
    C = min(block, S)
    n = -(-S // C)
    out_blocks, lse_blocks = [], []
    for i in range(n):
        s0, s1 = i * C, min((i + 1) * C, S)
        lo, hi = _block_span(s0, s1, T, causal, window, prefix_len)
        qi = q[:, s0:s1].float() * scale                  # (B, c, H, hd)
        qi = qi.reshape(B, s1 - s0, KV, G, hd)            # kv-major grouping
        ki = k[:, lo:hi].float()                          # (B, t, KV, hd)
        vi = v[:, lo:hi].float()
        logits = torch.einsum("bckgd,btkd->bckgt", qi, ki)
        mask = _block_mask(s0, s1, lo, hi, causal, window, prefix_len)
        if mask is not None:
            mask = mask.to(q.device)[None, :, None, None, :]
            logits = torch.where(mask, logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        o = torch.einsum("bckgt,btkd->bckgd", probs, vi)
        out_blocks.append(o.reshape(B, s1 - s0, H, hd))
        if return_lse:
            seen = logits if mask is None else torch.where(
                mask, logits, -math.inf)
            lse_blocks.append(torch.logsumexp(seen, dim=-1)
                              .reshape(B, s1 - s0, H))
    out = out_blocks[0] if n == 1 else torch.cat(out_blocks, dim=1)
    if not return_lse:
        return out.to(q.dtype)
    return out.to(q.dtype), torch.cat(lse_blocks, dim=1).transpose(1, 2)


def blocked_attention_backward(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, out: torch.Tensor,
                               lse: torch.Tensor, dout: torch.Tensor,
                               causal: bool = True,
                               window: Optional[int] = None, block: int = 64
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """The gradient of :func:`blocked_attention` in the arithmetic of the
    backward kernel (csrc/flash_attention_bwd.cu): P recomputed from the
    forward's ``lse`` (B, H, S), D = rowsum(dO o O), dS = P (dO V^T - D),
    then dQ = scale dS K, dK = scale dS^T Q and dV = P^T dO, the last two
    summed over the G query heads of each KV head.  fp32 inside; a row
    whose ``lse`` is -inf (it sees no key) contributes nothing.  Returns
    (dq, dk, dv) in the dtypes of q, k, v."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / (hd ** 0.5)
    delta = (dout.float() * out.float()).sum(dim=-1)      # (B, S, H)
    lse_s = lse.float().transpose(1, 2)                   # (B, S, H)
    dq = torch.zeros((B, S, H, hd), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, T, KV, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    C = min(block, S)
    for s0 in range(0, S, C):
        s1 = min(s0 + C, S)
        c = s1 - s0
        lo, hi = _block_span(s0, s1, T, causal, window)
        if hi <= lo:
            continue
        qi = q[:, s0:s1].float().reshape(B, c, KV, G, hd)
        gi = dout[:, s0:s1].float().reshape(B, c, KV, G, hd)
        ki, vi = k[:, lo:hi].float(), v[:, lo:hi].float()
        logits = torch.einsum("bckgd,btkd->bckgt", qi, ki) * scale
        li = lse_s[:, s0:s1].reshape(B, c, KV, G, 1)
        live = torch.isfinite(li)
        keep = live
        mask = _block_mask(s0, s1, lo, hi, causal, window)
        if mask is not None:
            keep = keep & mask.to(q.device)[None, :, None, None, :]
        p = torch.where(keep, torch.exp(logits - torch.where(live, li, 0.0)),
                        0.0)
        dp = torch.einsum("bckgd,btkd->bckgt", gi, vi)
        ds = p * (dp - delta[:, s0:s1].reshape(B, c, KV, G, 1))
        dv[:, lo:hi] += torch.einsum("bckgt,bckgd->btkd", p, gi)
        dk[:, lo:hi] += torch.einsum("bckgt,bckgd->btkd", ds, qi) * scale
        dq[:, s0:s1] = (torch.einsum("bckgt,btkd->bckgd", ds, ki)
                        * scale).reshape(B, c, H, hd)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# --- wkv6 -------------------------------------------------------------------

def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Token-level WKV6 recurrence (the definitional form, the oracle of
    ``repro/kernels/ref.py`` ``wkv6``).  r/k/v/logw: (BH, S, N); u:
    (BH, N) -> y (BH, S, N) in r's dtype, from a zero state."""
    r32, k32, v32 = r.float(), k.float(), v.float()
    lw, u32 = logw.float(), u.float()
    BH, S, N = r.shape
    state = torch.zeros((BH, N, N), dtype=torch.float32, device=r.device)
    ys = []
    for t in range(S):
        kv = k32[:, t, :, None] * v32[:, t, None, :]          # (BH, N, N)
        ys.append(torch.einsum("bi,bij->bj", r32[:, t],
                               state + u32[:, :, None] * kv))
        state = torch.exp(lw[:, t])[:, :, None] * state + kv
    return torch.stack(ys, dim=1).to(r.dtype)


def wkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                 chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk-parallel WKV6 (``repro/models/rwkv6.py`` ``_wkv_chunked``).

    r/k/v/logw: (B, S, H, N); u: (H, N); state: (B, H, N, N) f32.
    Returns (y (B, S, H, N) f32, final state).  The ragged tail is zero-padded:
    k = 0 adds nothing to the state and logw = 0 keeps its decay at 1.
    The intra-chunk decay is exponentiated pairwise in log space (the
    difference is <= 0 below the diagonal): a factored
    ``exp(cum_prev_t) * exp(-cum_s)`` overflows for strong decays.
    """
    B, S, H, N = r.shape
    C = min(chunk, S)
    nc = -(-S // C)
    Sp = nc * C
    if Sp != S:
        pad = lambda a: F.pad(a, (0, 0, 0, 0, 0, Sp - S))  # noqa: E731
        r, k, v, logw = pad(r), pad(k), pad(v), pad(logw)
    rs = lambda a: a.reshape(B, nc, C, H, N).permute(1, 0, 3, 2, 4)  # noqa
    r, k, v = (rs(a).float() for a in (r, k, v))              # (nc,B,H,C,N)
    logw = rs(logw).float()
    uu = u.float()[None]                                       # (1,H,N)
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device),
                      diagonal=-1)
    ys = []
    for c in range(nc):
        rc, kc, vc, lw = r[c], k[c], v[c], logw[c]             # (B,H,C,N)
        cum = torch.cumsum(lw, dim=2)
        cum_prev = cum - lw
        y = torch.einsum("bhti,bhij->bhtj", rc * torch.exp(cum_prev), state)
        diff = cum_prev[:, :, :, None, :] - cum[:, :, None, :, :]
        diff = torch.where(mask[None, None, :, :, None], diff, -math.inf)
        att = torch.einsum("bhti,bhsi,bhtsi->bhts", rc, kc, torch.exp(diff))
        diag = torch.einsum("bhti,bhti->bht", rc, kc * uu[:, :, None, :])
        y = y + torch.einsum("bhts,bhsj->bhtj", att, vc) + diag[..., None] * vc
        last = cum[:, :, -1:, :]                                # (B,H,1,N)
        kdec = kc * torch.exp(last - cum)
        state = torch.exp(last[:, :, 0])[..., None] * state + \
            torch.einsum("bhsi,bhsj->bhij", kdec, vc)
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, Sp, H, N)[:, :S]
    return y, state


# --- ssd --------------------------------------------------------------------

def ssd(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
        da: torch.Tensor) -> torch.Tensor:
    """Token-level SSD recurrence (the oracle of ``repro/kernels/ref.py``
    ``ssd``).  x: (BH, S, P); Bm/Cm: (BH, S, N); da: (BH, S, 1) -> y
    (BH, S, P) in x's dtype, from a zero state."""
    x32, B32, C32, da32 = x.float(), Bm.float(), Cm.float(), da.float()
    BH, S, P = x.shape
    h = torch.zeros((BH, P, Bm.shape[-1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(S):
        h = torch.exp(da32[:, t])[..., None] * h + \
            torch.einsum("bp,bn->bpn", x32[:, t], B32[:, t])
        ys.append(torch.einsum("bn,bpn->bp", C32[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype)


def ssd_chunked(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                da: torch.Tensor, h: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD (``repro/models/mamba2.py`` ``_ssd_chunked``).

    x: (B, S, H, P) with dt folded in; Bm/Cm: (B, S, N), shared by the
    heads; da: (B, S, H) log decay <= 0; h: (B, H, P, N) f32.  Returns
    (y (B, S, H, P) f32, final state).  The ragged tail is zero-padded
    (x = 0 adds nothing, da = 0 keeps the decay at 1).
    """
    B, S, H, P = x.shape
    C = min(chunk, S)
    nc = -(-S // C)
    Sp = nc * C
    if Sp != S:
        x = F.pad(x, (0, 0, 0, 0, 0, Sp - S))
        da = F.pad(da, (0, 0, 0, Sp - S))
        Bm = F.pad(Bm, (0, 0, 0, Sp - S))
        Cm = F.pad(Cm, (0, 0, 0, Sp - S))
    xc = x.reshape(B, nc, C, H, P).permute(1, 0, 3, 2, 4).float()
    dac = da.reshape(B, nc, C, H).permute(1, 0, 3, 2).float()
    Bc = Bm.reshape(B, nc, C, -1).permute(1, 0, 2, 3).float()
    Cc = Cm.reshape(B, nc, C, -1).permute(1, 0, 2, 3).float()
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool, device=x.device))
    ys = []
    for c in range(nc):
        x_, da_, B_, C_ = xc[c], dac[c], Bc[c], Cc[c]
        cum = torch.cumsum(da_, dim=-1)                         # (B,H,C)
        y = torch.einsum("btn,bhpn,bht->bhtp", C_, h, torch.exp(cum))
        g = torch.einsum("btn,bsn->bts", C_, B_)                # (B,C,C)
        diff = cum[:, :, :, None] - cum[:, :, None, :]          # (B,H,t,s)
        ldec = torch.where(mask[None, None], torch.exp(diff), 0.0)
        y = y + torch.einsum("bts,bhts,bhsp->bhtp", g, ldec, x_)
        dtot = torch.exp(cum[:, :, -1])                         # (B,H)
        kdec = torch.exp(cum[:, :, -1:] - cum)                  # (B,H,C)
        h = dtot[..., None, None] * h + \
            torch.einsum("bhs,bhsp,bsn->bhpn", kdec, x_, B_)
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, Sp, H, P)[:, :S]
    return y, h
