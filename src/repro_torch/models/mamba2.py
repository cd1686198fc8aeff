"""Mamba2 (SSD) block [arXiv:2405.21060], the Zamba2 backbone unit.

The port of ``repro/models/mamba2.py`` at tensor parallelism 1.
State-space recurrence per head (A scalar per head, n_groups=1):

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * x_t (x) B_t      h: (P, N)
    y_t = C_t . h_t + D * x_t

A prompt runs the chunk scan (:func:`_ssd_chunked`: the CUDA kernel B4 on
the card, the plain chunked version on the CPU); decode carries (conv
window, h) only and updates them in plain torch, one token a call.  The
state is written in place: :func:`block` updates the per-layer views of
the stacked :class:`MambaState` it is given and returns the same object.

Training calls :func:`block` with ``state=None``: the reference's zero
state, no state written (so a checkpointed layer recomputes from what the
first pass read), and the chunk scan through ``ssd.SSDScan``, whose
backward is the kernel ``csrc/ssd_bwd.cu`` on the card.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ssd as ssd_kernel
from repro_torch.models.common import PSpec, rms_norm


def layer_specs(cfg: ModelConfig, tp: int, L: int) -> Dict[str, Any]:
    d, s = cfg.d_model, cfg.ssm
    di = s.d_inner(d)
    nh = s.n_heads(d)
    ds = s.d_state
    lx = ("layers",)
    return {
        "w_z": PSpec((L, d, di), lx + ("fsdp", "tp")),
        "w_x": PSpec((L, d, di), lx + ("fsdp", "tp")),
        "w_B": PSpec((L, d, ds), lx + ("fsdp", None)),
        "w_C": PSpec((L, d, ds), lx + ("fsdp", None)),
        "w_dt": PSpec((L, d, nh), lx + ("fsdp", "tp")),
        "conv_x": PSpec((L, s.d_conv, di), lx + (None, "tp"), init="small"),
        "conv_B": PSpec((L, s.d_conv, ds), lx + (None, None), init="small"),
        "conv_C": PSpec((L, s.d_conv, ds), lx + (None, None), init="small"),
        "dt_bias": PSpec((L, nh), lx + ("tp",), init="zeros"),
        "A_log": PSpec((L, nh), lx + ("tp",), init="zeros"),
        "D": PSpec((L, nh), lx + ("tp",), init="ones"),
        "gn": PSpec((L, di), lx + ("tp",), init="ones"),
        "ln": PSpec((L, d), lx + (None,), init="ones"),
        "w_out": PSpec((L, di, d), lx + ("tp", "fsdp")),
    }


class MambaState(NamedTuple):
    conv: torch.Tensor  # (B, d_conv-1, di + 2*ds) last inputs to the conv
    h: torch.Tensor     # (B, nh, P, N) f32 SSD state


def init_state(cfg: ModelConfig, batch: int, stacked: int = 0,
               device=None) -> MambaState:
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    lead = (stacked,) if stacked else ()
    return MambaState(
        conv=torch.zeros(lead + (batch, s.d_conv - 1, di + 2 * s.d_state),
                         dtype=torch.float32, device=device),
        h=torch.zeros(lead + (batch, nh, s.head_dim, s.d_state),
                      dtype=torch.float32, device=device),
    )


def _causal_conv(seq: torch.Tensor, w: torch.Tensor, prev: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv. seq: (B,S,ch), w: (K,ch), prev: (B,K-1,ch)."""
    K = w.shape[0]
    full = torch.cat([prev.to(seq.dtype), seq], dim=1)
    out = torch.zeros_like(seq)
    for i in range(K):
        out = out + full[:, i:i + seq.shape[1]] * w[i]
    return out


def _ssd_chunked(xh, Bm, Cm, da, h, chunk):
    """Chunked SSD.  xh: (B,S,H,P); Bm/Cm: (B,S,N); da: (B,S,H) log
    decay <= 0; h: (B,H,P,N) f32, written in place with the final state.
    Returns (y (B,S,H,P) f32, h): the CUDA kernel B4 for CUDA tensors, the
    plain chunked version (at the config's ``chunk``) for CPU tensors.
    Inputs are taken in f32, as the reference's scan does."""
    y = ssd_kernel.ssd_scan(xh.float(), Bm.float(), Cm.float(), da.float(),
                            h, chunk=chunk)
    return y, h


def block(cfg: ModelConfig, lp, x: torch.Tensor, state: Optional[MambaState],
          tp: int, single_token: bool) -> Tuple[torch.Tensor, MambaState]:
    """One Mamba2 block with residual. x: (B,S,d); ``state`` holds this
    layer's views and is updated in place, or is None for a training
    forward (the zero state, nothing written)."""
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    P, N = s.head_dim, s.d_state
    B_, S_, _ = x.shape
    K = s.d_conv
    if state is not None and not single_token and S_ < K - 1:
        raise ValueError(f"a mamba2 prompt needs at least d_conv - 1 = "
                         f"{K - 1} tokens to fill the conv state, got {S_}")

    xn = rms_norm(x, lp["ln"], cfg.rms_eps)
    z = torch.matmul(xn, lp["w_z"])
    xi = torch.matmul(xn, lp["w_x"])
    Bm = torch.matmul(xn, lp["w_B"])
    Cm = torch.matmul(xn, lp["w_C"])
    dt = torch.matmul(xn, lp["w_dt"])

    conv_in = torch.cat([xi, Bm, Cm], dim=-1)
    conv_w = torch.cat([lp["conv_x"], lp["conv_B"], lp["conv_C"]], dim=-1)
    if single_token:
        window = torch.cat([state.conv.to(conv_in.dtype), conv_in], dim=1)
        conv_out = torch.einsum("bkc,kc->bc", window, conv_w)[:, None]
        state.conv.copy_(window[:, 1:])
    elif state is None:
        conv_out = _causal_conv(conv_in, conv_w, torch.zeros(
            (B_, K - 1, conv_in.shape[-1]), dtype=torch.float32,
            device=x.device))
    else:
        conv_out = _causal_conv(conv_in, conv_w, state.conv)
        state.conv.copy_(conv_in[:, -(K - 1):])
    conv_out = F.silu(conv_out)
    xi, Bm, Cm = torch.split(conv_out, [di, N, N], dim=-1)

    # softplus as jax.nn.softplus computes it: log(1 + exp(x)), no cutoff
    dt = torch.logaddexp(dt.float() + lp["dt_bias"],
                         torch.zeros((), device=x.device))
    A = -torch.exp(lp["A_log"].float())
    da = dt * A                                                # (B,S,H) <= 0
    xh = xi.reshape(B_, S_, nh, P)
    xdt = xh.float() * dt[..., None]

    if single_token:
        # h' = exp(da) h + dt x (x) B ; y = C.h' + D x
        h = state.h
        h.mul_(torch.exp(da[:, 0])[..., None, None]).add_(
            torch.einsum("bhp,bn->bhpn", xdt[:, 0], Bm[:, 0].float()))
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].float(), h)[:, None]
    elif state is None:
        h0 = torch.zeros((B_, nh, P, N), dtype=torch.float32, device=x.device)
        y, _ = ssd_kernel.SSDScan.apply(xdt, Bm.float(), Cm.float(),
                                        da.float(), h0, s.chunk)
    else:
        y, _ = _ssd_chunked(xdt, Bm, Cm, da, state.h, s.chunk)

    y = y + xh.float() * lp["D"][None, None, :, None]
    y = y.reshape(B_, S_, di).to(x.dtype)
    y = y * F.silu(z)
    y = rms_norm(y, lp["gn"], cfg.rms_eps)
    return x + torch.matmul(y, lp["w_out"]), state
