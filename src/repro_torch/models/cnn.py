"""The paper's client models (FedAT §6.1), batched over clients.

  * CIFAR-10 / Fashion-MNIST CNN: conv(32) -> conv(64) -> conv(64) ->
    dense(64) -> dense(n_classes), each conv followed by 2x2 max-pool.
  * Sentiment140: logistic regression (convex objective).

The reference's layouts are kept at the public surface: NHWC inputs, HWIO
conv weights, a ``(flat, 64)`` dense layer and the same param-dict keys.
The ``*_clients`` functions take every param with a leading client axis K
and inputs ``(K, B, ...)``: the K clients of a round train in one pass of
batched products, the written-out form of the reference's ``vmap``.

The convolution is im2col + ``torch.matmul``, as in the reference
(``repro/models/cnn.py:_conv``): a batched GEMM over clients, never
cuDNN, so no TF32 convolution path is involved.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SAME-padded stride-1 conv as im2col + matmul (odd kernels only).

    x (K, B, H, W, C), w (K, kh, kw, C, O), b (K, O) -> (K, B, H, W, O).
    """
    K, B, H, W, C = x.shape
    kh, kw, _, O = w.shape[1:]
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError("im2col conv assumes odd kernels")
    xp = F.pad(x, (0, 0, kw // 2, kw // 2, kh // 2, kh // 2))
    patches = torch.cat(
        [xp[:, :, i:i + H, j:j + W, :] for i in range(kh) for j in range(kw)],
        dim=-1)                                       # (K, B, H, W, kh*kw*C)
    y = torch.matmul(patches.reshape(K, B * H * W, kh * kw * C),
                     w.reshape(K, kh * kw * C, O))
    return y.reshape(K, B, H, W, O) + b[:, None, None, None, :]


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 VALID max-pool over (H, W) of (K, B, H, W, C)."""
    K, B, H, W, C = x.shape
    x = x[:, :, :H // 2 * 2, :W // 2 * 2]
    return x.reshape(K, B, H // 2, 2, W // 2, 2, C).amax(dim=(3, 5))


def cnn_init(generator: torch.Generator,
             in_shape: Tuple[int, int, int] = (32, 32, 3),
             n_classes: int = 10) -> Params:
    """He-normal init from ``generator`` (a CPU generator: the draws do
    not depend on the device the params end up on)."""
    h, w, c = in_shape

    def he(shape, fan_in):
        return torch.randn(shape, generator=generator) * math.sqrt(2.0 / fan_in)

    p = {
        "c1_w": he((3, 3, c, 32), 9 * c), "c1_b": torch.zeros(32),
        "c2_w": he((3, 3, 32, 64), 9 * 32), "c2_b": torch.zeros(64),
        "c3_w": he((3, 3, 64, 64), 9 * 64), "c3_b": torch.zeros(64),
    }
    flat = (h // 8) * (w // 8) * 64                   # three 2x2 pools
    p["d1_w"] = he((flat, 64), flat)
    p["d1_b"] = torch.zeros(64)
    p["d2_w"] = he((64, n_classes), 64)
    p["d2_b"] = torch.zeros(n_classes)
    return p


def cnn_apply_clients(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x (K, B, H, W, C) with per-client params (K, ...) -> (K, B, classes)."""
    x = _maxpool(torch.relu(_conv(x, p["c1_w"], p["c1_b"])))
    x = _maxpool(torch.relu(_conv(x, p["c2_w"], p["c2_b"])))
    x = _maxpool(torch.relu(_conv(x, p["c3_w"], p["c3_b"])))
    x = x.reshape(x.shape[0], x.shape[1], -1)
    x = torch.relu(torch.matmul(x, p["d1_w"]) + p["d1_b"][:, None, :])
    return torch.matmul(x, p["d2_w"]) + p["d2_b"][:, None, :]


def cnn_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) -> logits (B, n_classes), unbatched params."""
    return cnn_apply_clients({k: v[None] for k, v in p.items()}, x[None])[0]


def logreg_init(generator: torch.Generator, n_features: int,
                n_classes: int = 2) -> Params:
    return {
        "w": torch.randn((n_features, n_classes), generator=generator) * 0.01,
        "b": torch.zeros(n_classes),
    }


def logreg_apply_clients(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x (K, B, F) -> logits (K, B, n_classes)."""
    return torch.matmul(x, p["w"]) + p["b"][:, None, :]



def logreg_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x (B, F) -> logits (B, n_classes), unbatched params.  Convex
    objective."""
    return torch.matmul(x, p["w"]) + p["b"]


def make_model(kind: str, generator: torch.Generator, **kw):
    """Returns (params, apply_fn) for ``cnn`` or ``logreg``."""
    if kind == "cnn":
        return cnn_init(generator, **kw), cnn_apply
    if kind == "logreg":
        return logreg_init(generator, **kw), logreg_apply
    raise ValueError(kind)


def ce_loss(apply_fn, params: Params, batch) -> torch.Tensor:
    """Mean cross-entropy of ``apply_fn(params, batch["x"])`` against
    ``batch["y"]`` (one-hot times log-softmax, as the reference sums)."""
    logits = apply_fn(params, batch["x"])
    labels = F.one_hot(batch["y"].long(), logits.shape[-1]).to(logits.dtype)
    logp = torch.log_softmax(logits, dim=-1)
    return -(labels * logp).sum(dim=-1).mean()


def accuracy(apply_fn, params: Params, x: torch.Tensor, y: torch.Tensor
             ) -> torch.Tensor:
    return (torch.argmax(apply_fn(params, x), dim=-1) == y).float().mean()
