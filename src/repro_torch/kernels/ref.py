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
                window: Optional[int], prefix_len: int = 0,
                device: Optional[torch.device] = None):
    """(s1 - s0, hi - lo) bool visibility of a block, or None when every
    key of the span is visible to every row.  Built on the host, or on
    ``device`` when it is ``meta`` (shapes only: the mask is kept, as
    nothing there can be read)."""
    dev = device if device is not None and device.type == "meta" else None
    qpos = torch.arange(s0, s1, device=dev)[:, None]
    kpos = torch.arange(lo, hi, device=dev)[None, :]
    mask = None
    if causal:
        m = qpos >= kpos
        if prefix_len:
            m = m | (kpos < prefix_len)
        mask = m
    if window is not None:
        m = (qpos - kpos) < window
        mask = m if mask is None else (mask & m)
    if mask is not None and dev is None and bool(mask.all()):
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
        mask = _block_mask(s0, s1, lo, hi, causal, window, prefix_len,
                           q.device)
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
                               window: Optional[int] = None, block: int = 64,
                               prefix_len: int = 0
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """The gradient of :func:`blocked_attention` in the arithmetic of the
    backward kernel (csrc/flash_attention_bwd.cu): P recomputed from the
    forward's ``lse`` (B, H, S), D = rowsum(dO o O), dS = P (dO V^T - D),
    then dQ = scale dS K, dK = scale dS^T Q and dV = P^T dO, the last two
    summed over the G query heads of each KV head.  fp32 inside; a row
    whose ``lse`` is -inf (it sees no key) contributes nothing.  The
    masks are :func:`blocked_attention`'s, the prefix-LM one included.
    Returns (dq, dk, dv) in the dtypes of q, k, v."""
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
        lo, hi = _block_span(s0, s1, T, causal, window, prefix_len)
        if hi <= lo:
            continue
        qi = q[:, s0:s1].float().reshape(B, c, KV, G, hd)
        gi = dout[:, s0:s1].float().reshape(B, c, KV, G, hd)
        ki, vi = k[:, lo:hi].float(), v[:, lo:hi].float()
        logits = torch.einsum("bckgd,btkd->bckgt", qi, ki) * scale
        li = lse_s[:, s0:s1].reshape(B, c, KV, G, 1)
        live = torch.isfinite(li)
        keep = live
        mask = _block_mask(s0, s1, lo, hi, causal, window, prefix_len,
                           q.device)
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
    (x = 0 adds nothing, da = 0 keeps the decay at 1).  The intra-chunk
    decay is masked in log space before the exp (the reference masks after
    it: the same values, but its gradient is NaN once a chunk's decay sums
    past about 88, where exp overflows above the diagonal).
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
        # masked before the exp: above the diagonal diff >= 0 overflows
        # for strong decays, and exp(inf) * 0 would make the gradient NaN
        ldec = torch.exp(torch.where(mask[None, None], diff, -math.inf))
        y = y + torch.einsum("bts,bhts,bhsp->bhtp", g, ldec, x_)
        dtot = torch.exp(cum[:, :, -1])                         # (B,H)
        kdec = torch.exp(cum[:, :, -1:] - cum)                  # (B,H,C)
        h = dtot[..., None, None] * h + \
            torch.einsum("bhs,bhsp,bsn->bhpn", kdec, x_, B_)
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, Sp, H, P)[:, :S]
    return y, h


# --- the chunk scans' backward ------------------------------------------------
#
# In two passes, as the backward kernels run them (csrc/wkv6_bwd.cu,
# csrc/ssd_bwd.cu): pass 1 scans the chunks in reverse carrying only the
# gradient of the state, and writes it after each chunk; pass 2 takes every
# chunk on its own, from its start state (the forward's) and that gradient.
# The *_chunked_backward functions are their composition.

def _wide(a: torch.Tensor) -> torch.Tensor:
    """f32, or f64 for an f64 input (a float64 oracle of the same
    arithmetic)."""
    return a if a.dtype == torch.float64 else a.float()


def _split(a: torch.Tensor, C: int, nc: int, heads: bool = True
           ) -> torch.Tensor:
    """(B, S, H, ...) zero-padded to nc C tokens -> (B, H, nc, C, ...), or
    with ``heads=False`` (B, S, N) -> (B, nc, C, N), in :func:`_wide`'s
    type."""
    B, S = a.shape[:2]
    if nc * C != S:
        a = F.pad(a, (0,) * (2 * (a.dim() - 2)) + (0, nc * C - S))
    a = a.reshape(B, nc, C, *a.shape[2:])
    return _wide(a.movedim(3, 1) if heads else a)


def _merge(a: torch.Tensor, S: int) -> torch.Tensor:
    """(B, H, nc, C, ...) -> (B, S, H, ...), the padding dropped."""
    B, H, nc, C = a.shape[:4]
    return a.movedim(1, 3).reshape(B, nc * C, H, *a.shape[4:])[:, :S]


def _rev_cumsum(a: torch.Tensor, dim: int) -> torch.Tensor:
    """sum over the positions at or after each one, along ``dim``."""
    return a.flip(dim).cumsum(dim).flip(dim)


def _scan_states(dec: torch.Tensor, inc: torch.Tensor, s: torch.Tensor,
                 reverse: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """s <- dec[c] s + inc[c] over the chunks (axis 2 of inc, (B, H, nc,
    X, Y); dec broadcasts against it), in order or in reverse: (the value
    before each chunk's step, stacked on axis 2; the last value)."""
    nc = inc.shape[2]
    out = [None] * nc
    for c in (reversed(range(nc)) if reverse else range(nc)):
        out[c] = s
        s = dec[:, :, c] * s + inc[:, :, c]
    return torch.stack(out, 2), s


def _dims(S: int, chunk: int) -> Tuple[int, int]:
    C = min(chunk, S)
    return C, -(-S // C)


def wkv6_chunk_states(k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
                      state0: torch.Tensor, chunk: int = 32) -> torch.Tensor:
    """The state at the start of each chunk of :func:`wkv6_chunked` (what
    csrc/wkv6.cu writes when asked): (B, H, nc, N, N), f32 (f64 for f64
    inputs)."""
    C, nc = _dims(k.shape[1], chunk)
    k_, v_, lw = (_split(a, C, nc) for a in (k, v, logw))    # (B,H,nc,C,N)
    cum = lw.cumsum(3)
    last = cum[:, :, :, -1:]
    inc = torch.einsum("bhcsi,bhcsj->bhcij", k_ * torch.exp(last - cum), v_)
    return _scan_states(torch.exp(last[:, :, :, 0])[..., None], inc,
                        _wide(state0), reverse=False)[0]


def wkv6_chunk_dstates(r: torch.Tensor, logw: torch.Tensor, dy: torch.Tensor,
                       dstate: Optional[torch.Tensor] = None,
                       chunk: int = 32):
    """Pass 1 of :func:`wkv6_chunked_backward` (csrc/wkv6_bwd.cu
    ``wkv6_bwd_dstate``): in reverse over the chunks, dS <- e^{cum_C} dS +
    rd^T dy with rd = r e^{cum_prev}, from ``dstate`` (None = 0).
    r/logw/dy: (B, S, H, N).  Returns (dstates (B, H, nc, N, N), the
    gradient of the state after each chunk, whose last entry is
    ``dstate``; dstate0 (B, H, N, N), the gradient of the state at the
    start), f32 (f64 for f64 inputs)."""
    B, S, H, N = r.shape
    C, nc = _dims(S, chunk)
    r_, lw, g = (_split(a, C, nc) for a in (r, logw, dy))
    cum = lw.cumsum(3)
    inc = torch.einsum("bhcti,bhctj->bhcij", r_ * torch.exp(cum - lw), g)
    ds = (torch.zeros((B, H, N, N), dtype=inc.dtype, device=r.device)
          if dstate is None else _wide(dstate))
    return _scan_states(torch.exp(cum[:, :, :, -1])[..., None], inc, ds,
                        reverse=True)


def wkv6_chunk_grads(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     logw: torch.Tensor, u: torch.Tensor,
                     states: torch.Tensor, dstates: torch.Tensor,
                     dy: torch.Tensor, chunk: int = 32):
    """Pass 2 of :func:`wkv6_chunked_backward` (csrc/wkv6_bwd.cu
    ``wkv6_bwd``): every chunk on its own, from its start state S
    (``states``, the forward's) and the gradient dS of the state after it
    (``dstates``, pass 1's), both (B, H, nc, N, N).  With cum = inclusive
    cumsum of logw down the chunk, cum_prev = cum - logw, rd = r
    e^{cum_prev}, kd = k e^{cum_C - cum} and A the intra-chunk attention
    (strictly lower pairwise decayed products, the bonus u on the
    diagonal):

        dA = dy v^T,  dv = A^T dy + kd dS,  d(rd) = dy S^T,  d(kd) = v dS^T

    and the pairwise terms of A, whose decays stay pairwise in log space
    (every exponent <= 0), as the forward's do.  The gradients of cum and
    cum_prev become dlogw by reverse cumulative sums down the chunk.
    Returns (dr, dk, dv, dlogw (B, S, H, N), du (B, H, nc, N): each
    chunk's part), f32 (f64 for f64 inputs)."""
    B, S, H, N = r.shape
    C, nc = _dims(S, chunk)
    rc, kc, vc, lw, g = (_split(a, C, nc) for a in (r, k, v, logw, dy))
    S0, ds = _wide(states), _wide(dstates)                  # (B,H,nc,N,N)
    uu = _wide(u)[None, :, None, None, :]                    # (1,H,1,1,N)
    strict = torch.tril(torch.ones((C, C), dtype=torch.bool,
                                   device=r.device), diagonal=-1)
    cum = lw.cumsum(3)
    cp = cum - lw
    last = cum[:, :, :, -1:]                                 # (B,H,nc,1,N)
    rd, kd = rc * torch.exp(cp), kc * torch.exp(last - cum)
    diff = cp[..., :, None, :] - cum[..., None, :, :]        # (..,t,s,N)
    E = torch.exp(torch.where(strict[..., None], diff, -math.inf))
    A = torch.einsum("bhcti,bhcsi,bhctsi->bhcts", rc, kc, E)
    A = A + torch.diag_embed(torch.einsum("bhcti,bhcti->bhct", rc, kc * uu))
    dA = torch.einsum("bhctj,bhcsj->bhcts", g, vc)
    dd = dA.diagonal(dim1=-2, dim2=-1)                       # (B,H,nc,C)
    dA = torch.where(strict, dA, 0.0)
    dv = (torch.einsum("bhcts,bhctj->bhcsj", A, g)
          + torch.einsum("bhcsi,bhcij->bhcsj", kd, ds))
    drd = torch.einsum("bhctj,bhcij->bhcti", g, S0)
    dkd = torch.einsum("bhcsj,bhcij->bhcsi", vc, ds)
    dlast = torch.exp(last[:, :, :, 0]) * (ds * S0).sum(-1)  # (B,H,nc,N)
    dr2 = torch.einsum("bhcts,bhcsi,bhctsi->bhcti", dA, kc, E)
    dk2 = torch.einsum("bhcts,bhcti,bhctsi->bhcsi", dA, rc, E)
    dr = drd * torch.exp(cp) + dr2 + dd[..., None] * uu * kc
    dk = dkd * torch.exp(last - cum) + dk2 + dd[..., None] * uu * rc
    du = torch.einsum("bhct,bhcti->bhci", dd, rc * kc)
    dcp = drd * rd + rc * dr2
    dcum = -dkd * kd - kc * dk2
    dcum[:, :, :, -1] += dlast + (dkd * kd).sum(3)
    # cum_t sums logw up to t, cum_prev_t before t
    dlw = _rev_cumsum(dcum, 3) + _rev_cumsum(dcp, 3) - dcp
    return (*(_merge(a, S) for a in (dr, dk, dv, dlw)), du)


def wkv6_chunked_backward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          logw: torch.Tensor, u: torch.Tensor,
                          state0: torch.Tensor, dy: torch.Tensor,
                          dstate: Optional[torch.Tensor] = None,
                          chunk: int = 32):
    """The gradient of :func:`wkv6_chunked` in the arithmetic of the
    backward kernels (csrc/wkv6_bwd.cu): the chunk-start states from a
    forward pass (:func:`wkv6_chunk_states`), the gradient of the state
    after each chunk (:func:`wkv6_chunk_dstates`, pass 1), then every
    chunk's gradients (:func:`wkv6_chunk_grads`, pass 2).

    r/k/v/logw, dy: (B, S, H, N); u: (H, N); state0, dstate (None = 0):
    (B, H, N, N).  Returns (dr, dk, dv, dlogw (B, S, H, N), du (H, N),
    summed over the batch and the chunks, dstate0 (B, H, N, N)), all f32
    (f64 for f64 inputs)."""
    states = wkv6_chunk_states(k, v, logw, state0, chunk)
    dstates, ds0 = wkv6_chunk_dstates(r, logw, dy, dstate, chunk)
    dr, dk, dv, dlw, du = wkv6_chunk_grads(r, k, v, logw, u, states, dstates,
                                           dy, chunk)
    return dr, dk, dv, dlw, du.sum((0, 2)), ds0


def ssd_chunk_states(x: torch.Tensor, Bm: torch.Tensor, da: torch.Tensor,
                     h0: torch.Tensor, chunk: int = 32) -> torch.Tensor:
    """The state at the start of each chunk of :func:`ssd_chunked` (what
    csrc/ssd.cu writes when asked): (B, H, nc, P, N), f32 (f64 for f64
    inputs)."""
    C, nc = _dims(x.shape[1], chunk)
    xc, dac = _split(x, C, nc), _split(da, C, nc)        # (B,H,nc,C,P|)
    Bc = _split(Bm, C, nc, heads=False)                  # (B,nc,C,N)
    cum = dac.cumsum(-1)
    inc = torch.einsum("bhcs,bhcsp,bcsn->bhcpn",
                       torch.exp(cum[..., -1:] - cum), xc, Bc)
    return _scan_states(torch.exp(cum[..., -1])[..., None, None], inc,
                        _wide(h0), reverse=False)[0]


def ssd_chunk_dstates(Cm: torch.Tensor, da: torch.Tensor, dy: torch.Tensor,
                      dh: Optional[torch.Tensor] = None, chunk: int = 32):
    """Pass 1 of :func:`ssd_chunked_backward` (csrc/ssd_bwd.cu
    ``ssd_bwd_dstate``): in reverse over the chunks, dh <- e^{cum_C} dh +
    dye^T C with dye = dy e^{cum}, from ``dh`` (None = 0).  Cm: (B, S, N);
    da: (B, S, H); dy: (B, S, H, P).  Returns (dstates (B, H, nc, P, N),
    the gradient of the state after each chunk, whose last entry is
    ``dh``; dh0 (B, H, P, N)), f32 (f64 for f64 inputs)."""
    B, S, H, P = dy.shape
    C, nc = _dims(S, chunk)
    gc, dac = _split(dy, C, nc), _split(da, C, nc)
    Cc = _split(Cm, C, nc, heads=False)
    cum = dac.cumsum(-1)
    inc = torch.einsum("bhctp,bctn->bhcpn", gc * torch.exp(cum)[..., None],
                       Cc)
    d = (torch.zeros((B, H, P, Cm.shape[-1]), dtype=inc.dtype,
                     device=dy.device) if dh is None else _wide(dh))
    return _scan_states(torch.exp(cum[..., -1])[..., None, None], inc, d,
                        reverse=True)


def ssd_chunk_grads(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                    da: torch.Tensor, states: torch.Tensor,
                    dstates: torch.Tensor, dy: torch.Tensor, chunk: int = 32):
    """Pass 2 of :func:`ssd_chunked_backward` (csrc/ssd_bwd.cu
    ``ssd_bwd``): every chunk and head on its own, from its start state h
    (``states``, the forward's) and the gradient dh of the state after it
    (``dstates``, pass 1's), both (B, H, nc, P, N).  With L the decay
    e^{cum_t - cum_s} (s <= t, taken pairwise with every exponent <= 0, as
    the repaired forward's), G = C B^T, M = G L, dye = dy e^{cum} and xd =
    x e^{cum_last - cum}:

        dM = dy x^T,  dx = M^T dy + e^{cum_last - cum} (B dh^T)
        dC = dye h + (dM L) B,  dB = (dM L)^T C + xd dh

    and dcum from the row and column sums of dM G L and the two decays;
    dda is its reverse cumulative sum down the chunk.  Returns (dx (B, S,
    H, P), dB, dC (B, S, H, N): each head's part, dda (B, S, H)), f32 (f64
    for f64 inputs)."""
    B, S, H, P = x.shape
    C, nc = _dims(S, chunk)
    x_, g, dac = (_split(a, C, nc) for a in (x, dy, da))
    Bc, Cc = (_split(a, C, nc, heads=False) for a in (Bm, Cm))  # (B,nc,C,N)
    h, dh_ = _wide(states), _wide(dstates)                     # (B,H,nc,P,N)
    mask = torch.tril(torch.ones((C, C), dtype=torch.bool, device=x.device))
    cum = dac.cumsum(-1)                                       # (B,H,nc,C)
    elast = torch.exp(cum[..., -1])                            # (B,H,nc)
    kdec = torch.exp(cum[..., -1:] - cum)
    L = torch.exp(torch.where(mask, cum[..., :, None] - cum[..., None, :],
                              -math.inf))
    G = torch.einsum("bctn,bcsn->bcts", Cc, Bc)[:, None]       # (B,1,nc,t,s)
    dye = g * torch.exp(cum)[..., None]
    dC1 = torch.einsum("bhctp,bhcpn->bhctn", dye, h)
    dM = torch.einsum("bhctp,bhcsp->bhcts", g, x_)
    dG = dM * L
    W = dG * G
    Bdh = torch.einsum("bcsn,bhcpn->bhcsp", Bc, dh_)
    dkdec = (x_ * Bdh).sum(-1)                                 # (B,H,nc,C)
    dcum = (torch.einsum("bhctn,bctn->bhct", dC1, Cc) + W.sum(-1)
            - W.sum(-2) - dkdec * kdec)
    dcum[..., -1] += elast * (dh_ * h).sum((-1, -2)) + (dkdec * kdec).sum(-1)
    dx = (torch.einsum("bhcts,bhctp->bhcsp", G * L, g)
          + kdec[..., None] * Bdh)
    dC = dC1 + torch.einsum("bhcts,bcsn->bhctn", dG, Bc)
    dB = (torch.einsum("bhcts,bctn->bhcsn", dG, Cc)
          + torch.einsum("bhcs,bhcsp,bhcpn->bhcsn", kdec, x_, dh_))
    return (_merge(dx, S), _merge(dB, S), _merge(dC, S),
            _merge(_rev_cumsum(dcum, -1), S))


def ssd_chunked_backward(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                         da: torch.Tensor, h0: torch.Tensor, dy: torch.Tensor,
                         dh: Optional[torch.Tensor] = None, chunk: int = 32):
    """The gradient of :func:`ssd_chunked` in the arithmetic of the
    backward kernels (csrc/ssd_bwd.cu): the chunk-start states from a
    forward pass (:func:`ssd_chunk_states`), the gradient of the state
    after each chunk (:func:`ssd_chunk_dstates`, pass 1), then every
    chunk's gradients (:func:`ssd_chunk_grads`, pass 2), whose dB and dC
    are summed over the heads (B and C have no head axis).

    x, dy: (B, S, H, P); Bm/Cm: (B, S, N); da: (B, S, H); h0, dh (None =
    0): (B, H, P, N).  Returns (dx (B, S, H, P), dBm, dCm (B, S, N), dda
    (B, S, H), dh0 (B, H, P, N)), all f32 (f64 for f64 inputs)."""
    states = ssd_chunk_states(x, Bm, da, h0, chunk)
    dstates, dh0 = ssd_chunk_dstates(Cm, da, dy, dh, chunk)
    dx, dB, dC, dda = ssd_chunk_grads(x, Bm, Cm, da, states, dstates, dy,
                                      chunk)
    return dx, dB.sum(2), dC.sum(2), dda, dh0


# --- meta tensors: shape-only routes -----------------------------------------
#
# A ``meta`` tensor (the dry-run's stand-ins, launch/dryrun.py) takes each
# kernel's plain version, as a CPU tensor does, through one op of the
# ``repro_torch`` operator library: ``attention`` and ``attention_backward``
# (the flash forward with its log-sum-exp, and its backward; any causal,
# window or prefix-LM mask), ``wkv6`` / ``wkv6_backward`` and ``ssd`` /
# ``ssd_backward`` (the chunk scans from a state, and their backward).  The
# ops are registered for the Meta key only: a CPU tensor keeps the plain
# functions, a CUDA tensor the kernel.  So
# ``torch.utils.flop_counter.FlopCounterMode`` sees one op a kernel call,
# and the dry-run counts each by the products the kernel computes (each
# kernel module's ``flops``), not by the products of the plain version
# (the blocked attention multiplies whole blocks past the mask; the scans'
# plain chunk is the model's, not the kernel's).  As nothing is computed
# on meta, the plain versions take the whole sequence as one block or
# chunk there: the same function, in a few ops a call rather than a few a
# block.

_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("attention(Tensor q, Tensor k, Tensor v, bool causal, "
            "int? window, int prefix_len) -> (Tensor, Tensor)")
_LIB.define("attention_backward(Tensor q, Tensor k, Tensor v, Tensor out, "
            "Tensor lse, Tensor dout, bool causal, int? window, "
            "int prefix_len) -> (Tensor, Tensor, Tensor)")
_LIB.define("wkv6(Tensor r, Tensor k, Tensor v, Tensor logw, Tensor u, "
            "Tensor state) -> (Tensor, Tensor)")
_LIB.define("wkv6_backward(Tensor r, Tensor k, Tensor v, Tensor logw, "
            "Tensor u, Tensor state0, Tensor dy, Tensor? dstate) "
            "-> (Tensor, Tensor, Tensor, Tensor, Tensor, Tensor)")
_LIB.define("ssd(Tensor x, Tensor Bm, Tensor Cm, Tensor da, Tensor h) "
            "-> (Tensor, Tensor)")
_LIB.define("ssd_backward(Tensor x, Tensor Bm, Tensor Cm, Tensor da, "
            "Tensor h0, Tensor dy, Tensor? dh) "
            "-> (Tensor, Tensor, Tensor, Tensor, Tensor)")


def _meta_attention(q, k, v, causal, window, prefix_len):
    return blocked_attention(q, k, v, causal=causal, window=window,
                             block=q.shape[1], prefix_len=prefix_len,
                             return_lse=True)


def _meta_attention_backward(q, k, v, out, lse, dout, causal, window,
                             prefix_len):
    return blocked_attention_backward(q, k, v, out, lse, dout, causal=causal,
                                      window=window, block=q.shape[1],
                                      prefix_len=prefix_len)


def _meta_wkv6(r, k, v, logw, u, state):
    return wkv6_chunked(r, k, v, logw, u, state, r.shape[1])


def _meta_wkv6_backward(r, k, v, logw, u, state0, dy, dstate):
    return wkv6_chunked_backward(r, k, v, logw, u, state0, dy, dstate,
                                 r.shape[1])


def _meta_ssd(x, Bm, Cm, da, h):
    return ssd_chunked(x, Bm, Cm, da, h, x.shape[1])


def _meta_ssd_backward(x, Bm, Cm, da, h0, dy, dh):
    return ssd_chunked_backward(x, Bm, Cm, da, h0, dy, dh, x.shape[1])


for _name, _fn in (("attention", _meta_attention),
                   ("attention_backward", _meta_attention_backward),
                   ("wkv6", _meta_wkv6),
                   ("wkv6_backward", _meta_wkv6_backward),
                   ("ssd", _meta_ssd), ("ssd_backward", _meta_ssd_backward)):
    _LIB.impl(_name, _fn, "Meta")


class MetaAttention(torch.autograd.Function):
    """Differentiable attention on meta tensors: ``attention`` forward,
    ``attention_backward`` backward (a checkpointed block's recompute runs
    the forward op again)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int],
                prefix_len: int):
        out, lse = torch.ops.repro_torch.attention(q, k, v, causal, window,
                                                   prefix_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, prefix_len)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return (*torch.ops.repro_torch.attention_backward(
            q, k, v, out, lse, dout, *ctx.mask), None, None, None)

