"""RWKV-6 (Finch): data-dependent decay linear RNN [arXiv:2404.05892].

The port of ``repro/models/rwkv6.py``; at ``tp > 1`` the heads are
padded to a multiple of ``tp`` (:func:`padded_rwkv_heads`), as there.
Structure per layer: time-mix (WKV6 recurrence) + channel-mix, both with
token-shift and the ddlerp dynamic mixing LoRA.  Recurrence per head:

    S_t[i,j] = w_t[i] * S_{t-1}[i,j] + k_t[i] * v_t[j]
    y_t[j]   = sum_i r_t[i] * (S_{t-1}[i,j] + u[i] * k_t[i] * v_t[j])

with w_t = exp(-exp(decay_t)) data-dependent per channel.  A prompt runs
the chunk scan (:func:`_wkv_chunked`: the CUDA kernel B3 on the card, the
plain chunked version on the CPU); decode carries (shift tokens, WKV
state) only and runs :func:`_wkv_step` in plain torch, one token a call.
The state is written in place: :func:`block` updates the per-layer views
of the stacked :class:`RWKVState` it is given and returns the same object.

Training calls :func:`block` with ``state=None``: the reference's zero
state, no state written (so a checkpointed layer recomputes from what the
first pass read), and the chunk scan through ``rwkv6_scan.WKV6``, whose
backward is the kernel ``csrc/wkv6_bwd.cu`` on the card.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import rwkv6_scan
from repro_torch.models.common import PSpec, rms_norm

# The reference model's WKV6 chunk length (its intra-chunk pairwise-decay
# tensor is (B, H, C, C, N) f32); the CPU path uses it, the kernel its own.
CHUNK = 32


def padded_rwkv_heads(cfg: ModelConfig, tp: int) -> int:
    """Heads padded up to a multiple of the tensor-parallel degree."""
    h = cfg.d_model // cfg.rwkv.head_size
    return -(-h // tp) * tp if tp > 1 else h


def layer_specs(cfg: ModelConfig, tp: int, L: int) -> Dict[str, Any]:
    d, r = cfg.d_model, cfg.rwkv
    hp = padded_rwkv_heads(cfg, tp)
    da = hp * r.head_size
    lx = ("layers",)
    return {
        # time-mix
        "mu_x": PSpec((L, d), lx + (None,), init="small"),
        "mu": PSpec((L, 5, d), lx + (None, None), init="small"),
        "mix_w1": PSpec((L, d, 5 * r.mix_lora), lx + ("fsdp", None),
                        init="small"),
        "mix_w2": PSpec((L, 5, r.mix_lora, d), lx + (None, None, None),
                        init="small"),
        "wr": PSpec((L, d, da), lx + ("fsdp", "tp")),
        "wk": PSpec((L, d, da), lx + ("fsdp", "tp")),
        "wv": PSpec((L, d, da), lx + ("fsdp", "tp")),
        "wg": PSpec((L, d, da), lx + ("fsdp", "tp")),
        "decay_mu": PSpec((L, da), lx + ("tp",), init="zeros"),
        "dec_w1": PSpec((L, d, r.decay_lora), lx + ("fsdp", None),
                        init="small"),
        "dec_w2": PSpec((L, r.decay_lora, da), lx + (None, "tp"),
                        init="small"),
        "u": PSpec((L, da), lx + ("tp",), init="small"),
        "wo": PSpec((L, da, d), lx + ("tp", "fsdp")),
        "gn": PSpec((L, da), lx + ("tp",), init="ones"),
        "ln1": PSpec((L, d), lx + (None,), init="ones"),
        # channel-mix
        "c_mu_k": PSpec((L, d), lx + (None,), init="small"),
        "c_mu_r": PSpec((L, d), lx + (None,), init="small"),
        "wck": PSpec((L, d, cfg.d_ff), lx + ("fsdp", "tp")),
        "wcv": PSpec((L, cfg.d_ff, d), lx + ("tp", "fsdp")),
        "wcr": PSpec((L, d, d), lx + ("fsdp", None)),
        "ln2": PSpec((L, d), lx + (None,), init="ones"),
    }


class RWKVState(NamedTuple):
    tshift: torch.Tensor   # (B, d) last token fed to time-mix
    cshift: torch.Tensor   # (B, d) last token fed to channel-mix
    wkv: torch.Tensor      # (B, H, N, N) f32 state


def init_state(cfg: ModelConfig, batch: int, tp: int, stacked: int = 0,
               device=None) -> RWKVState:
    """Zero state, f32 whatever the cache dtype (as in the reference)."""
    hp = padded_rwkv_heads(cfg, tp)
    n = cfg.rwkv.head_size
    lead = (stacked,) if stacked else ()
    z = lambda *s: torch.zeros(lead + s, dtype=torch.float32,  # noqa: E731
                               device=device)
    return RWKVState(tshift=z(batch, cfg.d_model), cshift=z(batch, cfg.d_model),
                     wkv=z(batch, hp, n, n))


def _ddlerp(lp, x, xprev):
    """Dynamic token-shift mixing -> the 5 mixed inputs (r,k,v,g,w)."""
    delta = xprev - x
    xxx = x + delta * lp["mu_x"]
    lora = torch.tanh(torch.matmul(xxx, lp["mix_w1"]))
    lora = lora.reshape(*lora.shape[:-1], 5, -1)
    dyn = torch.einsum("...km,kmd->...kd", lora, lp["mix_w2"])  # (...,5,d)
    mixed = x[..., None, :] + delta[..., None, :] * (lp["mu"] + dyn)
    return [mixed[..., i, :] for i in range(5)]


def _tmix_projections(cfg, lp, x, xprev, tp):
    """Returns r,k,v: (B,S,H,N); g: (B,S,H*N); logw: (B,S,H,N) f32 (log
    decay <= 0)."""
    n = cfg.rwkv.head_size
    xr, xk, xv, xg, xw = _ddlerp(lp, x, xprev)
    r = torch.matmul(xr, lp["wr"])
    k = torch.matmul(xk, lp["wk"])
    v = torch.matmul(xv, lp["wv"])
    g = torch.matmul(xg, lp["wg"])
    dec = lp["decay_mu"] + torch.matmul(torch.matmul(xw, lp["dec_w1"]),
                                        lp["dec_w2"])
    logw = -torch.exp(dec.float())
    shp = (*r.shape[:-1], -1, n)
    return (r.reshape(shp), k.reshape(shp), v.reshape(shp), g,
            logw.reshape(shp))


def _wkv_chunked(r, k, v, logw, u, state):
    """Chunk-parallel WKV6.  r/k/v/logw: (B,S,H,N); u: (H,N); state:
    (B,H,N,N) f32, written in place with the final state.  Returns
    (y (B,S,H,N) f32, state): the CUDA kernel B3 for CUDA tensors, the
    plain chunked version (at the reference's CHUNK) for CPU tensors."""
    y = rwkv6_scan.wkv6(r, k, v, logw, u, state, chunk=CHUNK)
    return y.float(), state


def _wkv_step(r, k, v, logw, u, state):
    """Single-token WKV. r/k/v/logw: (B,H,N); u: (H,N); state (B,H,N,N),
    written in place."""
    r, k, v = r.float(), k.float(), v.float()
    kv = k[..., :, None] * v[..., None, :]                     # (B,H,N,N)
    y = torch.einsum("bhi,bhij->bhj", r, state + u[None, :, :, None] * kv)
    state.mul_(torch.exp(logw)[..., None]).add_(kv)
    return y, state


def _group_norm(y, gamma, eps=1e-5):
    """Per-head normalization. y: (..., H, N)."""
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    return (y - mu) * torch.rsqrt(var + eps) * gamma


def _shifted(xn, shift, single_token: bool):
    """The token before each position: the carried one, then the input's."""
    prev = shift[:, None, :].to(xn.dtype)
    return prev if single_token else torch.cat([prev, xn[:, :-1]], dim=1)


def _zero_shift(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((x.shape[0], x.shape[-1]), dtype=torch.float32,
                       device=x.device)


def time_mix(cfg: ModelConfig, lp, x, state: Optional[RWKVState], tp: int,
             single_token: bool) -> Tuple[torch.Tensor, RWKVState]:
    """``state`` None: a training forward from the zero state (none
    written; the differentiable scan)."""
    n = cfg.rwkv.head_size
    hp = padded_rwkv_heads(cfg, tp)
    xn = rms_norm(x, lp["ln1"], cfg.rms_eps)
    shift = _zero_shift(xn) if state is None else state.tshift
    xprev = _shifted(xn, shift, single_token)
    r, k, v, g, logw = _tmix_projections(cfg, lp, xn, xprev, tp)
    u = lp["u"].reshape(hp, n)
    if single_token:
        y, _ = _wkv_step(r[:, 0], k[:, 0], v[:, 0], logw[:, 0], u, state.wkv)
        y = y[:, None]
    elif state is None:
        B, _, H, N = r.shape
        zero = torch.zeros((B, H, N, N), dtype=torch.float32,
                           device=r.device)
        y, _ = rwkv6_scan.WKV6.apply(r, k, v, logw, u, zero, CHUNK)
        y = y.float()
    else:
        y, _ = _wkv_chunked(r, k, v, logw, u, state.wkv)
    y = _group_norm(y, lp["gn"].reshape(hp, n)).to(x.dtype)
    y = y.reshape(*y.shape[:-2], hp * n) * F.silu(g)
    if state is not None:
        state.tshift.copy_(xn[:, -1])
    return torch.matmul(y, lp["wo"]), state


def channel_mix(cfg: ModelConfig, lp, x, state: Optional[RWKVState],
                tp: int, single_token: bool
                ) -> Tuple[torch.Tensor, RWKVState]:
    xn = rms_norm(x, lp["ln2"], cfg.rms_eps)
    shift = _zero_shift(xn) if state is None else state.cshift
    delta = _shifted(xn, shift, single_token) - xn
    xk = xn + delta * lp["c_mu_k"]
    xr = xn + delta * lp["c_mu_r"]
    kh = torch.square(torch.relu(torch.matmul(xk, lp["wck"])))
    kv = torch.matmul(kh, lp["wcv"])
    rr = torch.sigmoid(torch.matmul(xr, lp["wcr"]))
    if state is not None:
        state.cshift.copy_(xn[:, -1])
    return rr * kv, state


def block(cfg: ModelConfig, lp, x, state: Optional[RWKVState], tp: int,
          single_token: bool) -> Tuple[torch.Tensor, RWKVState]:
    """One layer with both residuals; ``state`` holds this layer's views
    and is updated in place, or is None for a training forward (the zero
    state, nothing written)."""
    y, state = time_mix(cfg, lp, x, state, tp, single_token)
    x = x + y
    y, state = channel_mix(cfg, lp, x, state, tp, single_token)
    return x + y, state
