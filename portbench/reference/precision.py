"""Matrix products in the reference's precision.

``"fp32"``: plain float32 products (the benches set TF32 off).
``"tf32"``: the control, the nearest precision below float32: every
operand of a product (forward and backward) rounded to TF32, 10 mantissa
bits, round to nearest even, and the products accumulated in float32, as
the card's TF32 path computes them.  It runs the same on the CPU.  (The
CNN's convolutions are im2col products, so these two cover them.)
"""
from __future__ import annotations

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties to even), as float32."""
    b = x.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    r = (b + 0x0FFF + lsb) & ~0x1FFF
    return r.view(torch.float32)


class _MatmulTF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ar, br = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(ar, br)
        return torch.matmul(ar, br)

    @staticmethod
    def backward(ctx, gy):
        ar, br = ctx.saved_tensors
        g = round_tf32(gy)
        ga = torch.matmul(g, br.transpose(-1, -2))
        gb = torch.matmul(ar.transpose(-1, -2), g)
        # broadcast leading dims back to each operand's shape
        while ga.dim() > ar.dim():
            ga = ga.sum(0)
        while gb.dim() > br.dim():
            gb = gb.sum(0)
        for i, n in enumerate(ar.shape):
            if n == 1 and ga.shape[i] != 1:
                ga = ga.sum(i, keepdim=True)
        for i, n in enumerate(br.shape):
            if n == 1 and gb.shape[i] != 1:
                gb = gb.sum(i, keepdim=True)
        return ga, gb


def matmul(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "tf32":
        return _MatmulTF32.apply(a, b)
    return torch.matmul(a, b)
