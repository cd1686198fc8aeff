"""The CNN's conv-block Functions (``kernels/cnn_block.py``: ``Im2col``,
``BiasReluPool``) against autograd through the composite ops they replace,
kept here as the yardstick: pad + nine slices + ``cat`` + matmul + bias,
``relu``, a crop and ``amax``.

Bit for bit: logits, losses and every leaf's gradient compare as int32
bit patterns, so the signs of zeros and NaNs count.  On the CPU the
Functions take the plain versions (``kernels/ref.py``); on a card
(``cuda`` marker) the hand-written kernels, at the benchmark cell's
shapes and at 28 x 28, over three Adam steps.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.kernels import cnn_block, ref
from repro_torch.models import cnn

torch.set_num_threads(1)

KEYS = ["c1_w", "c1_b", "c2_w", "c2_b", "c3_w", "c3_b",
        "d1_w", "d1_b", "d2_w", "d2_b"]


# --- the yardstick: the composite the Functions replace ----------------------

def composite_block(x, w, b):
    """The conv block through the composite ops (kernels/ref.py) under
    autograd, as models/cnn.py ran it before the Functions."""
    K, B, H, W, C = x.shape
    kh, kw, _, O = w.shape[1:]
    y = torch.matmul(ref.im2col(x, kh, kw).reshape(K, B * H * W, kh * kw * C),
                     w.reshape(K, kh * kw * C, O))
    return ref.bias_relu_pool(y.reshape(K, B, H, W, O), b)


def _apply(p, x, block):
    for i in (1, 2, 3):
        x = block(x, p[f"c{i}_w"], p[f"c{i}_b"])
    x = x.reshape(x.shape[0], x.shape[1], -1)
    x = torch.relu(torch.matmul(x, p["d1_w"]) + p["d1_b"][:, None, :])
    return torch.matmul(x, p["d2_w"]) + p["d2_b"][:, None, :]


def _loss(logits, y):
    labels = F.one_hot(y, logits.shape[-1]).to(logits.dtype)
    return -(labels * torch.log_softmax(logits, dim=-1)).sum(-1).mean(-1)


def _bits(t):
    return t.detach().contiguous().view(torch.int32)


def assert_bitwise(a, b, what):
    assert a.shape == b.shape, what
    assert torch.equal(_bits(a), _bits(b)), (
        f"{what}: {int((_bits(a) != _bits(b)).sum())} of {a.numel()} "
        f"values differ")


def _params(K, hw, gen, device="cpu"):
    p0 = cnn.cnn_init(gen, in_shape=(hw, hw, 3))
    return {k: torch.stack([v * (1 + 0.05 * i) + 0.01 * i for i in range(K)])
            .to(device) for k, v in p0.items()}


def run_both(p, x, y, grad=True):
    """(logits, loss, grads) of the model through the Functions and through
    the composite, from the same params."""
    out = []
    for block in (cnn._conv_block, composite_block):
        leaves = {k: v.clone().requires_grad_(grad) for k, v in p.items()}
        with torch.set_grad_enabled(grad):
            logits = _apply(leaves, x, block)
            loss = _loss(logits, y)
            grads = (torch.autograd.grad(loss.sum(), [leaves[k] for k in KEYS])
                     if grad else ())
        out.append((logits, loss, grads))
    return out


def check_model(p, x, y, grad=True):
    (la, sa, ga), (lb, sb, gb) = run_both(p, x, y, grad)
    assert_bitwise(la, lb, "logits")
    assert_bitwise(sa, sb, "loss")
    for k, a, b in zip(KEYS, ga, gb):
        assert_bitwise(a, b, f"d{k}")
    return la, ga


# --- the cases ---------------------------------------------------------------

def case_layers(gen, dev):
    """The three blocks at 16 x 16 x 3 (16 -> 8 -> 4 -> 2), K=2, B=3."""
    p = _params(2, 16, gen, dev)
    x = torch.randn(2, 3, 16, 16, 3, generator=gen)
    check_model(p, x.to(dev),
                torch.randint(0, 10, (2, 3), generator=gen).to(dev))


def case_c3_input_grad(gen, dev):
    """One block on an input that needs its gradient, C = 3 and O = 5 (the
    kernels' paths for channels not a multiple of 4), H != W."""
    x = torch.randn(2, 3, 9, 6, 3, generator=gen)
    w = torch.randn(2, 3, 3, 3, 5, generator=gen)
    b = torch.randn(2, 5, generator=gen) * 0.3
    g = torch.randn(2, 3, 4, 3, 5, generator=gen)
    x, w, b, g = (t.to(dev) for t in (x, w, b, g))
    outs = []
    for block in (cnn._conv_block, composite_block):
        xs, ws, bs = (t.clone().requires_grad_() for t in (x, w, b))
        out = block(xs, ws, bs)
        outs.append((out, *torch.autograd.grad((out * g).sum(),
                                                [xs, ws, bs])))
    for what, a, c in zip(["out", "dx", "dw", "db"], *outs):
        assert_bitwise(a, c, what)


def case_odd_28(gen, dev):
    """28 x 28 images: 28 -> 14 -> 7 -> 3, the third pool crops 7 to 6."""
    p = _params(2, 28, gen, dev)
    x = torch.randn(2, 2, 28, 28, 3, generator=gen)
    check_model(p, x.to(dev),
                torch.randint(0, 10, (2, 2), generator=gen).to(dev))


def case_positive_ties(gen, dev):
    """Small integer images and half-integer weights: conv outputs tie
    inside pool windows at positive values (the gradient splits)."""
    p = _params(2, 8, gen)
    for i in (1, 2, 3):
        p[f"c{i}_w"] = torch.randint(-1, 2, p[f"c{i}_w"].shape,
                                     generator=gen).float() * 0.5
        p[f"c{i}_b"] = torch.full_like(p[f"c{i}_b"], 0.5)
    x = torch.randint(0, 3, (2, 4, 8, 8, 3), generator=gen).float()
    y = torch.matmul(ref.im2col(x, 3, 3).reshape(2, 4 * 64, 27),
                     p["c1_w"].reshape(2, 27, 32)).reshape(2, 4, 8, 8, 32)
    r = torch.relu(y + p["c1_b"][:, None, None, None, :])
    r = r.reshape(2, 4, 4, 2, 4, 2, 32)
    top = r.amax(dim=(3, 5), keepdim=True)
    ties = ((r == top).sum(dim=(3, 5)) >= 2) & (top[:, :, :, 0, :, 0] > 0)
    assert bool(ties.any()), "no positive tie"
    p = {k: v.to(dev) for k, v in p.items()}
    check_model(p, x.to(dev),
                torch.randint(0, 10, (2, 4), generator=gen).to(dev))


def case_negative_windows(gen, dev):
    """Half the first layer's channels biased far below zero: whole
    windows are negative, ReLU passes no gradient there."""
    p = _params(2, 8, gen, dev)
    p["c1_b"][:, :16] = -100.0
    x = torch.randn(2, 3, 8, 8, 3, generator=gen)
    check_model(p, x.to(dev),
                torch.randint(0, 10, (2, 3), generator=gen).to(dev))


def case_nan_input(gen, dev):
    """A NaN pixel in one image: NaNs through the pool, its max's gradient
    (count 0) and the rest of the model, bit for bit."""
    p = _params(2, 8, gen, dev)
    x = torch.randn(2, 3, 8, 8, 3, generator=gen)
    x[1, 2, 3, 4, 0] = float("nan")
    logits, _ = check_model(
        p, x.to(dev), torch.randint(0, 10, (2, 3), generator=gen).to(dev))
    assert bool(torch.isnan(logits[1, 2]).all())
    assert not bool(torch.isnan(logits[0]).any())


def case_signed_zeros(gen, dev):
    """Pool windows of +0 and -0 from y and b: the signs ReLU and the max
    keep, and the gradient's signed zeros."""
    y = torch.randn(2, 3, 6, 6, 4, generator=gen)
    zeros = torch.rand(y.shape, generator=gen) < 0.4
    y = torch.where(zeros, torch.where(torch.rand(y.shape, generator=gen)
                                       < 0.5, -0.0, 0.0), y)
    b = torch.tensor([[0.0, -0.0, 0.0, -0.0], [-0.0, -0.0, 0.0, 0.0]])
    g = torch.randn(2, 3, 3, 3, 4, generator=gen)
    g[0] = -0.0
    y, b, g = y.to(dev), b.to(dev), g.to(dev)
    outs = []
    for f in (lambda ys, bs: cnn_block.BiasReluPool.apply(ys, bs, True),
              ref.bias_relu_pool):
        ys, bs = y.clone().requires_grad_(), b.clone().requires_grad_()
        out = f(ys, bs)
        outs.append((out, *torch.autograd.grad((out * g).sum(), [ys, bs])))
    for what, a, c in zip(["out", "dy", "db"], *outs):
        assert_bitwise(a, c, what)


def case_no_grad(gen, dev, monkeypatch):
    """Under no_grad, as the eval runs it (one model expanded over the
    clients, so the bias has a stride-0 client axis): the same logits, and
    no mask made."""
    seen = []
    pool = cnn_block.bias_relu_pool
    monkeypatch.setattr(cnn_block, "bias_relu_pool",
                        lambda y, b, m: seen.append(m) or pool(y, b, m))
    p0 = cnn.cnn_init(gen, in_shape=(8, 8, 3))
    p = {k: v.to(dev)[None].expand((3,) + tuple(v.shape))
         for k, v in p0.items()}
    x = torch.randn(3, 4, 8, 8, 3, generator=gen).to(dev)
    with torch.no_grad():
        got = _apply(p, x, cnn._conv_block)
        want = _apply(p, x, composite_block)
    assert_bitwise(got, want, "logits")
    assert seen == [False] * 3


def case_col2im_order(gen, dev):
    """col2im sums a pixel's taps in the order autograd adds the slices'
    padded gradients: from the last tap to the first.  Taps of magnitudes
    1e-3 .. 1e3 make the order show: summed from the first tap the result
    differs."""
    x = torch.randn(2, 2, 7, 5, 4, generator=gen)
    scale = torch.logspace(-3, 3, 9).repeat_interleave(4)
    g = torch.randn(2, 2, 7, 5, 36, generator=gen) * scale[torch.randperm(
        36, generator=gen)]
    x, g = x.to(dev), g.to(dev)
    xs = x.clone().requires_grad_()
    want, = torch.autograd.grad((ref.im2col(xs, 3, 3) * g).sum(), [xs])
    xs = x.clone().requires_grad_()
    got, = torch.autograd.grad((cnn_block.Im2col.apply(xs, 3, 3) * g).sum(),
                               [xs])
    assert_bitwise(got, want, "dx")
    gp = F.pad(g.reshape(2, 2, 7, 5, 9, 4), (0, 0, 0, 0, 1, 1, 1, 1))
    forward = sum(gp[:, :, 2 - i:9 - i, 2 - j:7 - j, 3 * i + j]
                  for i in range(3) for j in range(3))
    assert not torch.equal(_bits(forward), _bits(want))


CASES = {"layers": case_layers, "c3_input_grad": case_c3_input_grad,
         "odd_28": case_odd_28, "positive_ties": case_positive_ties,
         "negative_windows": case_negative_windows,
         "nan_input": case_nan_input, "signed_zeros": case_signed_zeros,
         "no_grad": case_no_grad, "col2im_order": case_col2im_order}


def _run_case(case, dev, monkeypatch):
    gen = torch.Generator().manual_seed(sorted(CASES).index(case))
    fn = CASES[case]
    fn(gen, dev, monkeypatch) if case == "no_grad" else fn(gen, dev)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_path_matches_composite_bitwise(case, monkeypatch):
    _run_case(case, "cpu", monkeypatch)


def test_kernel_blocks_counter_reads_zero_on_cpu():
    spans.disable()
    spans.enable("cpu")
    try:
        gen = torch.Generator().manual_seed(0)
        p = _params(2, 8, gen)
        loss = _loss(cnn.cnn_apply_clients(
            p, torch.randn(2, 3, 8, 8, 3, generator=gen)),
            torch.zeros(2, 3, dtype=torch.long))
        assert loss.shape == (2,)
        counters = spans.collect()["counters"]
    finally:
        spans.disable()
    assert counters.get("cnn.kernel_blocks", 0) == 0
    assert cnn_block.launch_counts() == dict.fromkeys(
        ("im2col", "col2im", "pool", "pool_bwd"), 0)


def test_backward_kernels_refuse_cpu_tensors():
    """The col2im and pool_bwd wrappers launch kernels only: off the card
    the Functions' gradient is autograd through kernels/ref.py."""
    with pytest.raises(ValueError, match="CUDA kernel only"):
        cnn_block.im2col_backward(torch.zeros(1, 1, 4, 4, 18), 3, 3)
    with pytest.raises(ValueError, match="CUDA kernel only"):
        cnn_block.bias_relu_pool_backward(
            torch.zeros(1, 1, 2, 2, 3), torch.zeros(1, 1, 2, 2, 3,
                                                    dtype=torch.uint8), 4, 4)


def test_im2col_refuses_even_kernels():
    x = torch.zeros(1, 1, 4, 4, 2)
    with pytest.raises(ValueError, match="odd kernels"):
        cnn_block.Im2col.apply(x, 2, 3)


# --- on the card --------------------------------------------------------------

def _adam(p, m, v, grads, t):
    """clients.py's Adam step, the same arithmetic on both sides."""
    c1 = float(np.float32(1) - np.float32(0.9) ** np.float32(t))
    c2 = float(np.float32(1) - np.float32(0.999) ** np.float32(t))
    for k, g in zip(KEYS, grads):
        m[k] = 0.9 * m[k] + 0.1 * g
        v[k] = 0.999 * v[k] + 0.001 * g.square()
        p[k] = p[k] - 1e-3 * (m[k] / c1) / (torch.sqrt(v[k] / c2) + 1e-8)


@pytest.mark.cuda
@pytest.mark.parametrize("K,B,hw", [(100, 50, 32), (10, 20, 28)])
def test_card_kernels_match_composite_bitwise(K, B, hw):
    """The kernel path against the composite on the card over three Adam
    steps from the same params: logits and all ten gradients bitwise at
    every step; 3 + 3 forward and 2 + 3 backward launches a step, and
    ``cnn.kernel_blocks`` 3 a forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    gen = torch.Generator().manual_seed(hw)
    p = _params(K, hw, gen, "cuda")
    x = torch.randn(K, B, hw, hw, 3, generator=gen).cuda()
    y = torch.randint(0, 10, (K, B), generator=gen).cuda()
    state = [{k: v.clone() for k, v in p.items()} for _ in range(2)]
    mom = [[{k: torch.zeros_like(v) for k, v in p.items()} for _ in range(2)]
           for _ in range(2)]
    for t in (1, 2, 3):
        res = []
        for side, block in enumerate((cnn._conv_block, composite_block)):
            leaves = {k: v.clone().requires_grad_()
                      for k, v in state[side].items()}
            cnn_block.reset_launch_counts()
            spans.enable("cuda")
            try:
                logits = _apply(leaves, x, block)
                counters = spans.collect()["counters"]
            finally:
                spans.disable()
            grads = torch.autograd.grad(_loss(logits, y).sum(),
                                        [leaves[k] for k in KEYS])
            torch.cuda.synchronize()
            res.append((logits, grads, cnn_block.launch_counts(), counters))
        (la, ga, na, ca), (lb, gb, nb, cb) = res
        assert_bitwise(la, lb, f"step {t} logits")
        for k, a, b in zip(KEYS, ga, gb):
            assert_bitwise(a, b, f"step {t} d{k}")
        assert na == {"im2col": 3, "col2im": 2, "pool": 3, "pool_bwd": 3}
        assert ca == {"cnn.kernel_blocks": 3}
        assert nb == dict.fromkeys(na, 0) and cb == {}
        for side, grads in ((0, ga), (1, gb)):
            _adam(state[side], *mom[side], grads, t)
    for k in KEYS:
        assert_bitwise(state[0][k], state[1][k], f"params {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_card_cases_match_composite_bitwise(case, monkeypatch):
    """The CPU cases on the card: the same tensors, drawn on the host and
    moved to the card, through the kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    cnn_block.reset_launch_counts()
    _run_case(case, "cuda", monkeypatch)
    assert sum(cnn_block.launch_counts().values()) > 0
