"""The CNN's conv-block glue (csrc/cnn_block.cu) as two autograd Functions.

    patches = Im2col.apply(x, kh, kw)   # x (K, B, H, W, C) -> (K, B, H, W, kh*kw*C)
    y = torch.matmul(patches.reshape(K, B*H*W, kh*kw*C), w.reshape(...))
    out = BiasReluPool.apply(y.reshape(K, B, H, W, O), b,
                             torch.is_grad_enabled())
                                        # -> (K, B, H//2, W//2, O)

How models/cnn.py runs each conv block.  The product between them is
left to ``torch.matmul`` under autograd, on the operands it had, so its
forward and both backward products are the same cuBLAS calls as before;
these two Functions take over only the copies and elementwise passes
around it, which autograd's composite (pad + nine slices + ``cat``;
``+ b``, ``relu``, a crop and ``amax``) ran as about a dozen full-size
ATen passes a block and their backward:

  * :class:`Im2col`: the patches of a SAME-padded stride-1 conv (odd
    kernels), taps in (i, j, c) order; backward, a gather-sum of the
    patches' gradient (col2im) with no zero-filled buffer.  An input that
    needs no gradient (the images) gets no backward, as before.
  * :class:`BiasReluPool`: 2x2 stride-2 max-pool of ``relu(y + b)``
    cropped to even sizes.  Under grad it keeps one byte per pooled value
    (which window positions equal the max, which pass ReLU's gradient) in
    place of the activations autograd kept; backward writes ``dy``
    contiguous, as the matmul's backward had it, and ``db`` is the same
    ATen sum over (B, H, W) that autograd took.

Both are bit for bit the composite's result on each device: the kernels
repeat ATen's per-element arithmetic on CUDA and its order of
accumulation (csrc/cnn_block.cu says how).  A CPU (or meta) tensor takes
the plain version: the composite ops themselves (kernels/ref.py), with
autograd through them, re-run on the saved inputs, as the backward.  A
CUDA tensor launches the kernel or raises, with no fallback.  Each
kernel's launches are counted (``launch_counts``): a training step of the
paper CNN launches 3 ``im2col``, 3 ``pool``, 2 ``col2im`` and 3
``pool_bwd``; the counter ``cnn.kernel_blocks`` (spans.py) counts the
blocks whose forward launched them.

What bounds them is memory (:func:`nbytes` counts each launch's bytes).
The kernels are compiled at first use with ``nvcc`` (kernels/build.py).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch import spans
from repro_torch.kernels import build as kbuild
from repro_torch.kernels import ref

_vp, _ci, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_LIB = kbuild.Library(
    "cnn_block", "cnn_error_string",
    {"cnn_im2col": [_vp, _vp, _ll, _ci, _ci, _ci, _ci, _ci, _vp],
     "cnn_col2im": [_vp, _vp, _ll, _ci, _ci, _ci, _ci, _ci, _vp],
     "cnn_pool": [_vp, _vp, _vp, _vp, _ll, _ci, _ci, _ci, _ci, _vp],
     "cnn_pool_bwd": [_vp, _vp, _vp, _ll, _ci, _ci, _ci, _vp],
     "cnn_im2col_rows": [_ci, _ci, _ci, _ci]},
    kernels=("im2col", "col2im", "pool", "pool_bwd"))
launch_counts = _LIB.launch_counts
reset_launch_counts = _LIB.reset_launch_counts


def _on_card(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, which must be float32; False for any other
    device (the plain version)."""
    if t.device.type != "cuda":
        return False
    if t.dtype != torch.float32:
        raise ValueError(f"{what}: the CUDA kernels are float32 only, got "
                         f"{t.dtype}")
    return True


def _card_only(t: torch.Tensor, what: str) -> None:
    if not _on_card(t, what):
        raise ValueError(f"{what} launches the CUDA kernel only; the plain "
                         f"version is autograd through kernels/ref.py")


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def im2col(x: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """x (K, B, H, W, C) -> patches (K, B, H, W, kh*kw*C), contiguous."""
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError("im2col conv assumes odd kernels")
    if not _on_card(x, "im2col"):
        return ref.im2col(x, kh, kw)
    K, B, H, W, C = x.shape
    x = x.contiguous()
    out = torch.empty((K, B, H, W, kh * kw * C), dtype=x.dtype,
                      device=x.device)
    if out.numel():
        if _LIB.query("cnn_im2col_rows", H, W, C, kh) < 1:
            raise ValueError(f"im2col: a row of {W} x {C} floats and its "
                             f"halo do not fit the kernel's shared memory")
        with torch.cuda.device(x.device):
            _LIB.launch("im2col", "cnn_im2col", x.data_ptr(), out.data_ptr(),
                        K * B, H, W, C, kh, kw, _stream(x))
    return out


def im2col_backward(g: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """The col2im kernel: the patches' gradient (K, B, H, W, kh*kw*C) ->
    dx (K, B, H, W, C)."""
    _card_only(g, "im2col_backward")
    K, B, H, W, T = g.shape
    g = g.contiguous()
    dx = torch.empty((K, B, H, W, T // (kh * kw)), dtype=g.dtype,
                     device=g.device)
    if dx.numel():
        with torch.cuda.device(g.device):
            _LIB.launch("col2im", "cnn_col2im", g.data_ptr(), dx.data_ptr(),
                        K * B, H, W, T // (kh * kw), kh, kw, _stream(g))
    return dx


def bias_relu_pool(y: torch.Tensor, b: torch.Tensor, with_mask: bool):
    """y (K, B, H, W, O), b (K, O) -> (``ref.bias_relu_pool(y, b)``, (K, B,
    H//2, W//2, O); on the card with ``with_mask``, its uint8 mask of the
    same shape, else None).  Bit e of the mask marks the window positions
    (e = 2 * dh + dw) equal to the max, bit 4 + e those whose ReLU output
    is not <= 0."""
    if not _on_card(y, "bias_relu_pool"):
        return ref.bias_relu_pool(y, b), None
    K, B, H, W, O = y.shape
    if b.shape != (K, O) or b.device != y.device or b.dtype != y.dtype:
        raise ValueError(f"bias_relu_pool: b must be ({K}, {O}) {y.dtype} on "
                         f"{y.device}, got {tuple(b.shape)} {b.dtype} on "
                         f"{b.device}")
    y, b = y.contiguous(), b.contiguous()
    shape = (K, B, H // 2, W // 2, O)
    out = torch.empty(shape, dtype=y.dtype, device=y.device)
    mask = (torch.empty(shape, dtype=torch.uint8, device=y.device)
            if with_mask else None)
    if out.numel():
        with torch.cuda.device(y.device):
            _LIB.launch("pool", "cnn_pool", y.data_ptr(), b.data_ptr(),
                        out.data_ptr(),
                        None if mask is None else mask.data_ptr(),
                        K * B, B, H, W, O, _stream(y))
    return out, mask


def bias_relu_pool_backward(g: torch.Tensor, mask: torch.Tensor, H: int,
                            W: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pool_bwd kernel, then the bias sum: g and mask (K, B, H//2,
    W//2, O) -> (dy (K, B, H, W, O), db (K, O))."""
    _card_only(g, "bias_relu_pool_backward")
    K, B, _, _, O = g.shape
    g = g.contiguous()
    dy = torch.empty((K, B, H, W, O), dtype=g.dtype, device=g.device)
    if dy.numel():
        with torch.cuda.device(g.device):
            _LIB.launch("pool_bwd", "cnn_pool_bwd", g.data_ptr(),
                        mask.data_ptr(), dy.data_ptr(), K * B, H, W, O,
                        _stream(g))
    # the reduction autograd's sum_to took for the broadcast bias
    return dy, dy.sum(dim=(1, 2, 3), keepdim=True).reshape(K, O)


def _plain_grad(fn, inputs, g):
    """The plain version's gradient: autograd through ``fn`` (composite
    ops of kernels/ref.py), re-run on the saved inputs."""
    leaves = [t.detach().requires_grad_() for t in inputs]
    with torch.enable_grad():
        out = fn(*leaves)
    return torch.autograd.grad(out, leaves, g)


class Im2col(torch.autograd.Function):
    """:func:`im2col` with the col2im kernel (or, off the card, autograd
    through ``ref.im2col``) as its gradient."""

    @staticmethod
    def forward(ctx, x, kh: int, kw: int):
        ctx.kernel = (kh, kw)
        ctx.plain = x.device.type != "cuda"
        if ctx.plain:
            ctx.save_for_backward(x)
        return im2col(x, kh, kw)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        kh, kw = ctx.kernel
        if ctx.plain:
            dx, = _plain_grad(lambda x: ref.im2col(x, kh, kw),
                              ctx.saved_tensors, g)
        else:
            dx = im2col_backward(g, kh, kw)
        return dx, None, None


class BiasReluPool(torch.autograd.Function):
    """:func:`bias_relu_pool`: ``BiasReluPool.apply(y, b,
    torch.is_grad_enabled())`` keeps what its gradient needs (on the card
    the mask, else y and b) only where one is recorded (grad mode on,
    which forward cannot read itself, and y or b needing it)."""

    @staticmethod
    def forward(ctx, y, b, grad_mode: bool):
        ctx.plain = y.device.type != "cuda"
        grad = grad_mode and any(ctx.needs_input_grad[:2])
        out, mask = bias_relu_pool(y, b, grad and not ctx.plain)
        if not ctx.plain:
            spans.count("cnn.kernel_blocks", 1)
        if grad:
            ctx.save_for_backward(*((y, b) if ctx.plain else (mask,)))
            ctx.hw = tuple(y.shape[2:4])
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        if ctx.plain:
            return (*_plain_grad(ref.bias_relu_pool, ctx.saved_tensors, g),
                    None)
        mask, = ctx.saved_tensors
        return (*bias_relu_pool_backward(g, mask, *ctx.hw), None)


def nbytes(kernel: str, N: int, H: int, W: int, C: int, O: int = 0,
           kh: int = 3, kw: int = 3) -> int:
    """The least bytes a launch of ``kernel`` moves for N images of H x W:
    what it needs of its input read once and its output written once (C
    input channels for im2col and col2im, O channels for the pool).
    col2im needs only the patch gradients of taps inside the image."""
    T = kh * kw * C
    if kernel == "im2col":
        return 4 * N * H * W * (C + T)
    if kernel == "col2im":
        inside = sum((H - abs(i - kh // 2)) * (W - abs(j - kw // 2))
                     for i in range(kh) for j in range(kw))
        return 4 * N * C * (inside + H * W)
    pooled = N * (H // 2) * (W // 2) * O
    if kernel == "pool":
        return 4 * N * H * W * O + 4 * pooled + pooled
    if kernel == "pool_bwd":
        return 4 * pooled + pooled + 4 * N * H * W * O
    raise ValueError(kernel)
