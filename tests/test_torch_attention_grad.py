"""The gradient of the port's flash attention against the JAX reference.

The JAX package has no backward kernel: off the TPU it trains through
``repro.kernels.ops.blocked_attention``, which JAX differentiates.  Here
``jax.grad`` of that function is the oracle for the port's two backward
paths on the CPU: ``FlashAttention`` (the autograd function whose forward
saves the log-sum-exp and whose backward is the kernel's plain version on
CPU tensors) and ``ref.blocked_attention_backward`` called directly.  The
same numpy inputs and output cotangent go to both packages.

Tolerances: fp32, 2e-5 of each gradient's max |value| (the recompute from
the log-sum-exp and the GQA sums round in another order than XLA's
autodiff); bf16 inputs, 1e-2 (both sides compute in fp32 from the same
bf16 values and round the gradients to bf16 once: one bf16 rounding is
2^-8 of a value).  The CUDA kernel itself is held to the same plain
version on the card by the ``cuda``-marked test at the end and by
chip_smoke.py phase 13.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from _tf32 import mma

torch.set_num_threads(1)

# the reference's ATTN_CASES (tests/test_kernels.py) and GQA / head-dim
# cases of the training paths: (S, T, H, KV, hd, causal, window)
CASES = [
    (128, 128, 4, 4, 64, True, None),
    (256, 256, 4, 2, 64, True, None),
    (200, 200, 4, 2, 80, True, None),
    (128, 128, 8, 1, 128, True, None),
    (128, 384, 2, 2, 64, False, None),
    (256, 256, 4, 4, 64, True, 100),
    (512, 512, 2, 2, 64, True, 128),
    (96, 96, 6, 2, 16, True, None),         # tiny_lm's hd 16, GQA 3
    (64, 64, 4, 2, 120, True, None),        # hd 120
]
TOL = {"float32": 2e-5, "bfloat16": 1e-2}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(case, dtype, seed=0, B=2):
    S, T, H, KV, hd, causal, window = case
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd),
                      (B, S, H, hd))]
    # round to the working dtype once, so both packages see the same values
    arrs = [np.array(jnp.asarray(a, _JDT[dtype]).astype(jnp.float32))
            for a in arrs]
    return arrs, causal, window


def _jax_grads(arrs, causal, window, dtype):
    q, k, v, g = (jnp.asarray(a, _JDT[dtype]) for a in arrs)

    def f(q, k, v):
        out = jops.blocked_attention(q, k, v, causal=causal, window=window)
        return jnp.sum(out.astype(jnp.float32) * g.astype(jnp.float32))
    return [np.asarray(x.astype(jnp.float32))
            for x in jax.grad(f, argnums=(0, 1, 2))(q, k, v)]


def _torch(arrs, dtype, grad=False):
    return [torch.from_numpy(a).to(_TDT[dtype]).requires_grad_(grad)
            for a in arrs]


def _check(got, want, dtype, what):
    for name, a, b in zip("qkv", got, want):
        a = a.detach().float().numpy()
        assert a.shape == b.shape, (what, name, a.shape, b.shape)
        assert np.isfinite(a).all(), (what, name)
        err = float(np.abs(a - b).max())
        bound = TOL[dtype] * max(float(np.abs(b).max()), 1e-6)
        assert err <= bound, f"{what} d{name}: {err} > {bound}"


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_function_grads_match_jax(case, dtype):
    arrs, causal, window = _inputs(case, dtype)
    want = _jax_grads(arrs, causal, window, dtype)
    q, k, v = _torch(arrs[:3], dtype, grad=True)
    g = torch.from_numpy(arrs[3]).to(_TDT[dtype])
    out = tfa.FlashAttention.apply(q, k, v, causal, window)
    grads = torch.autograd.grad(out, (q, k, v), g)
    _check(grads, want, dtype, "FlashAttention")


@pytest.mark.parametrize("case", CASES[:4] + CASES[5:6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_backward_matches_jax(case, dtype):
    arrs, causal, window = _inputs(case, dtype, seed=1)
    want = _jax_grads(arrs, causal, window, dtype)
    q, k, v, g = _torch(arrs, dtype)
    out, lse = tref.blocked_attention(q, k, v, causal=causal, window=window,
                                      return_lse=True)
    assert lse.shape == (q.shape[0], q.shape[2], q.shape[1])
    assert lse.dtype == torch.float32
    grads = tref.blocked_attention_backward(q, k, v, out, lse, g,
                                            causal=causal, window=window)
    for x, t in zip(grads, (q, k, v)):
        assert x.dtype == t.dtype and x.shape == t.shape
    _check(grads, want, dtype, "blocked_attention_backward")


def test_lse_is_the_rows_logsumexp():
    arrs, causal, window = _inputs((64, 80, 4, 2, 16, True, 24), "float32")
    q, k, v, _ = _torch(arrs, "float32")
    _, lse = tref.blocked_attention(q, k, v, causal=True, window=24,
                                    block=16, return_lse=True)
    oracle = torch.einsum("bshd,bthd->bhst", q,
                          k.repeat_interleave(2, dim=2)) / 4.0
    s = torch.arange(64)[:, None]
    t = torch.arange(80)[None, :]
    oracle = torch.where((s >= t) & (s - t < 24), oracle, -torch.inf)
    torch.testing.assert_close(lse, torch.logsumexp(oracle, -1),
                               rtol=1e-6, atol=1e-5)


def test_row_that_sees_no_key_gets_zero_grads():
    """S > T with a causal window: rows s >= T + window - 1 see no key.
    Their lse is -inf, their dq is 0, they add nothing to dk/dv, and
    nothing is NaN."""
    B, S, T, H, KV, hd, W = 1, 48, 16, 2, 1, 16, 8
    rng = np.random.default_rng(3)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  for s in ((B, S, H, hd), (B, T, KV, hd), (B, T, KV, hd),
                            (B, S, H, hd)))
    out, lse = tfa.flash_attention(q, k, v, causal=True, window=W,
                                   return_lse=True)
    dead = T + W - 1
    assert torch.isinf(lse[..., dead:]).all()
    assert torch.isfinite(lse[..., :dead]).all()
    dq, dk, dv = tfa.flash_attention_backward(q, k, v, out, lse, g,
                                              causal=True, window=W)
    for x in (dq, dk, dv):
        assert torch.isfinite(x).all()
    assert not dq[:, dead:].any()
    # the dead rows' cotangent changes nothing
    g2 = g.clone()
    g2[:, dead:] = torch.from_numpy(
        rng.standard_normal((B, S - dead, H, hd)).astype(np.float32))
    _, dk2, dv2 = tfa.flash_attention_backward(q, k, v, out, lse, g2,
                                               causal=True, window=W)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)


def test_gqa_sum_equals_grads_of_repeated_kv():
    """dk/dv of a KV head are the sums over its G query heads: the same
    as the gradient through K/V repeated G times (MHA)."""
    arrs, _, _ = _inputs((64, 64, 6, 2, 16, True, None), "float32", seed=5)
    q, k, v = _torch(arrs[:3], "float32", grad=True)
    g = torch.from_numpy(arrs[3])
    out = tfa.FlashAttention.apply(q, k, v, True, None)
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
    kr = k.detach().repeat_interleave(3, dim=2).requires_grad_(True)
    vr = v.detach().repeat_interleave(3, dim=2).requires_grad_(True)
    qm = q.detach().requires_grad_(True)
    out2 = tfa.FlashAttention.apply(qm, kr, vr, True, None)
    dq2, dkr, dvr = torch.autograd.grad(out2, (qm, kr, vr), g)
    torch.testing.assert_close(dq, dq2, rtol=0, atol=1e-6)
    torch.testing.assert_close(dk, dkr.reshape(2, 64, 2, 3, 16).sum(3),
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dv, dvr.reshape(2, 64, 2, 3, 16).sum(3),
                               rtol=1e-5, atol=1e-6)


def test_ops_attention_routes_grads_through_flash_function():
    """``attention(impl="kernel")`` differentiates through FlashAttention
    when an operand needs a gradient, and calls the plain forward under
    no_grad; both give the same output."""
    arrs, _, _ = _inputs((64, 64, 4, 2, 16, True, None), "float32", seed=7)
    q, k, v = _torch(arrs[:3], "float32", grad=True)
    out = tops.attention(q, k, v, causal=True, impl="kernel")
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    with torch.no_grad():
        out2 = tops.attention(q, k, v, causal=True, impl="kernel")
    assert out2.grad_fn is None
    assert torch.equal(out.detach(), out2)


def test_backward_checks_its_operands():
    q = torch.zeros(1, 8, 2, 16)
    k = torch.zeros(1, 8, 1, 16)
    out, lse = tfa.flash_attention(q, k, k, return_lse=True)
    with pytest.raises(ValueError, match="lse"):
        tfa.flash_attention_backward(q, k, k, out, lse[:, :, :4], out)
    with pytest.raises(ValueError, match="dout"):
        tfa.flash_attention_backward(q, k, k, out, lse, out.double())


def _model_backward(q, k, v, o, lse, do, causal, window, mm, rnd):
    """The arithmetic of the backward kernels' tensor-core designs, in
    numpy: every product through ``mm(a, b)`` (float64 out, cast to fp32),
    elementwise work in fp32, P and dS passed through ``rnd`` before the
    dV, dK and dQ products take them.  q, k, v, o, do are fp32 numpy
    arrays (B, S|T, heads, hd), lse (B, H, S); returns fp32 (dq, dk, dv)."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = np.float32(1.0 / hd ** 0.5)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    heads = lambda x, n: x.reshape(B, x.shape[1], n, -1, hd).transpose(  # noqa: E731
        0, 2, 3, 1, 4)   # (B, KV, G|1, rows, hd)
    Q, dO, O = heads(q, KV), heads(do, KV), heads(o, KV)
    K, V = heads(k, KV), heads(v, KV)
    lse = lse.reshape(B, KV, G, S)[..., None]
    s_idx, t_idx = np.arange(S)[:, None], np.arange(T)[None, :]
    keep = (t_idx <= s_idx) if causal else np.ones((S, T), bool)
    if window:
        keep = keep & (s_idx - t_idx < window)
    keep = keep & np.isfinite(lse)
    logits = f32(mm(Q, K.swapaxes(-1, -2))) * scale
    p = np.where(keep, np.exp(logits - np.where(np.isfinite(lse), lse, 0)),
                 0).astype(np.float32)
    dp = f32(mm(dO, V.swapaxes(-1, -2)))
    delta = (dO * O).sum(-1, keepdims=True, dtype=np.float32)
    ds = (p * (dp - delta)).astype(np.float32)
    p, ds = rnd(p), rnd(ds)
    dv = f32(mm(p.swapaxes(-1, -2), dO)).sum(2)
    dk = f32(mm(ds.swapaxes(-1, -2), Q)).sum(2) * scale
    dq = f32(mm(ds, K)) * scale
    back = lambda x, n: x.reshape(B, n, -1, hd).transpose(0, 2, 1, 3)  # noqa: E731
    return (back(dq.reshape(B, H, S, hd), H), back(dk, KV), back(dv, KV))


def _bf16(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _plain(arrs, causal, window, dtype):
    """The plain forward and backward on ``arrs`` in ``dtype``: (o, lse,
    grads) as fp32 numpy."""
    q, k, v, g = _torch(arrs, dtype)
    o, lse = tref.blocked_attention(q, k, v, causal=causal, window=window,
                                    return_lse=True)
    grads = tref.blocked_attention_backward(q, k, v, o, lse, g,
                                            causal=causal, window=window)
    return (o.float().numpy(), lse.numpy(),
            [x.float().numpy() for x in grads])


def _rel_errs(got, want):
    return [float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))
            for a, b in zip(got, want)]


@pytest.mark.parametrize("case", CASES)
def test_bf16_tensor_core_model_holds_chip_bounds(case):
    """The bf16 design's numerics (the wgmma kernels): products of bf16
    operands accumulate exactly in fp32, and P and dS are rounded to bf16
    once before the dV, dK and dQ products take them (one rounding, no hi
    + lo split).  On every case the gradients stay within chip_smoke.py
    phase 13's bounds: 2e-2 of each gradient's max from the plain bf16
    version, and 3 bf16 roundings plus 1% of the max from the fp32
    gradients."""
    arrs, causal, window = _inputs(case, "bfloat16", seed=11)
    o, lse, want16 = _plain(arrs, causal, window, "bfloat16")
    f64 = lambda a, b: np.matmul(a.astype(np.float64), b)  # noqa: E731
    got = [_bf16(x) for x in _model_backward(
        *arrs[:3], o, lse, arrs[3], causal, window, f64, _bf16)]
    errs = _rel_errs(got, want16)
    assert max(errs) <= 2e-2, errs
    _, _, want32 = _plain(arrs, causal, window, "float32")
    for a, b in zip(got, want32):
        lim = 2.0 ** -8 * np.abs(b) + 1e-2 * np.abs(b).max()
        assert float((np.abs(a - b) / lim).max()) <= 3.0


@pytest.mark.parametrize("case", [CASES[1], CASES[3], CASES[6], CASES[8]])
def test_3xtf32_backward_holds_fp32_tolerance_and_tf32_does_not(case):
    """The fp32 design's numerics (mma.sync m16n8k8 on TF32 operands): the
    backward's products (S, dP, dV, dK, dQ) each in 3xTF32 keep every
    gradient within 1e-4 of its max from the plain fp32 version
    (chip_smoke.py's BWD_TOL), and a single TF32 product does not.  The
    model sums exactly; the tensor cores' accumulation truncates, which
    the kernels bound by summing each tile's products apart (measured on
    the card, chip_smoke.py phase 13)."""
    arrs, causal, window = _inputs(case, "float32", seed=12)
    o, lse, want = _plain(arrs, causal, window, "float32")
    rel = {}
    for split in ("3xtf32", "tf32"):
        got = _model_backward(*arrs[:3], o, lse, arrs[3], causal, window,
                              lambda a, b: mma(a, b, split), lambda x: x)
        rel[split] = max(_rel_errs(got, want))
    assert rel["3xtf32"] <= 1e-4 and rel["3xtf32"] < 1e-5, rel
    assert rel["tf32"] > 1e-4, rel


def test_dout_layouts_copied_for_tma_and_counted():
    """The backward's dO layout step (CPU tensors: it reads shapes,
    strides and pointers only): a bf16 dO that TMA can read, contiguous or
    a slice of 8-padded rows, is taken as it is; a misaligned one (offset
    one element, rows of hd + 1) is copied into 8-padded rows, equal in
    value, and counted, as is one whose rows are not 16-byte steps; fp32
    never is (its kernels load by cp.async)."""
    B, S, H, hd = 2, 24, 4, 16
    wide = torch.randn(B, S, H, hd + 8).to(torch.bfloat16)
    odd = torch.randn(B, S, H, hd + 1).to(torch.bfloat16)
    tfa.reset_layout_copy_counts()
    for do in (wide[..., :hd].contiguous(), wide[..., :hd]):
        assert tfa.tma_readable(do)
        assert tfa.dout_for_kernel(do) is do
    assert tfa.layout_copy_counts() == {"flash_attention_bwd_dout": 0}
    mis = odd[..., 1:]
    assert not tfa.tma_readable(mis)
    got = tfa.dout_for_kernel(mis)
    assert got is not mis and tfa.tma_readable(got)
    assert got.stride() == (S * H * hd, H * hd, hd, 1)
    assert torch.equal(got, mis)
    assert tfa.layout_copy_counts() == {"flash_attention_bwd_dout": 1}
    # rows of 12 elements: contiguous, but not in 16-byte steps
    narrow = torch.randn(B, S, H, 12).to(torch.bfloat16)
    got = tfa.dout_for_kernel(narrow)
    assert got.stride() == (S * H * 16, H * 16, 16, 1)
    assert torch.equal(got, narrow)
    assert tfa.layout_copy_counts() == {"flash_attention_bwd_dout": 2}
    f32 = torch.randn(B * S * H * hd + 1)[1:].view(B, S, H, hd)
    assert tfa.dout_for_kernel(f32) is f32
    assert tfa.layout_copy_counts() == {"flash_attention_bwd_dout": 2}
    tfa.reset_layout_copy_counts()
    assert tfa.layout_copy_counts() == {"flash_attention_bwd_dout": 0}


def test_bwd_grids_and_tiles():
    """One CTA per 64 keys of a KV head (dK/dV) and per 128 query rows of
    a head (dQ), in both dtypes; 64-row tiles stream through them."""
    assert tfa.BWD_TILES == {"dkdv": 64, "dq": 128}
    # the trainer's shape (qwen2-7b widths, one 4096-token sequence)
    assert tfa.bwd_grids(1, 4096, 4096, 28, 4) == {"dkdv": (4, 64),
                                                   "dq": (28, 32)}
    # the federated LM's (tiny_lm_long: 40 sequences of 128)
    assert tfa.bwd_grids(40, 128, 128, 2, 2) == {"dkdv": (80, 2),
                                                 "dq": (80, 1)}
    # ragged lengths round up; S and T apart
    assert tfa.bwd_grids(2, 300, 129, 8, 2) == {"dkdv": (4, 3),
                                                "dq": (16, 3)}


def test_backward_only_names_a_kernel_and_needs_cuda():
    """``only`` names one of the three kernels and needs CUDA tensors (it
    times a part of the kernel call); the plain version takes none."""
    assert tfa.BWD_KERNELS == {"delta": 1, "dkdv": 2, "dq": 4}
    q = torch.zeros(1, 8, 2, 16)
    k = torch.zeros(1, 8, 1, 16)
    out, lse = tfa.flash_attention(q, k, k, return_lse=True)
    for only in ("dq", "dkdv_and_dq"):
        with pytest.raises(ValueError, match="only must be one of"):
            tfa.flash_attention_backward(q, k, k, out, lse, out, only=only)


def test_attention_bwd_bounds():
    """chip_smoke.py's bound of one backward at the trainer's shape: 5
    products over 234.9 M visible pairs a head (300.7 GFLOP); fp32 at the
    FFMA rate (67 TFLOP/s) and, beside it, in 3xTF32 on the tensor cores
    (3x the operations at 495 TFLOP/s); bf16 at 989 TFLOP/s."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    b32 = chip_smoke.attention_bwd_bound(1, 4096, 4096, 28, 4, 128, True,
                                         None, "float32")
    b16 = chip_smoke.attention_bwd_bound(1, 4096, 4096, 28, 4, 128, True,
                                         None, "bfloat16")
    pairs = 4096 * 4097 // 2
    assert b32["flops"] == b16["flops"] == 10 * 28 * pairs * 128
    assert b32["bound_by"] == b16["bound_by"] == "operations"
    assert b32["bound_ms"] == pytest.approx(b32["flops"] / 67e12 * 1e3)
    assert b32["bound_ms"] == pytest.approx(4.4884, abs=1e-4)
    assert b32["tc_bound_ms"] == pytest.approx(
        3 * b32["flops"] / 495e12 * 1e3)
    assert b16["bound_ms"] == pytest.approx(0.3041, abs=1e-4)
    assert b16["tc_bound_ms"] == b16["bound_ms"]
    # the federated LM's shape is bound by its bytes
    fl = chip_smoke.attention_bwd_bound(40, 128, 128, 2, 2, 16, True, None,
                                        "float32")
    assert fl["bound_by"] == "bytes" and fl["tc_bound_by"] == "bytes"


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_backward_matches_plain_version(case, dtype):
    """On the card: the forward's lse and the backward kernels against the
    plain versions on the same inputs (fp32 1e-4, bf16 2e-2 of each
    gradient's max), with dO contiguous, a strided slice of wider rows
    and misaligned (bf16 copies it for TMA, counted); a second call gives
    the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    arrs, causal, window = _inputs(case, dtype)
    q, k, v, g = (t.cuda() for t in _torch(arrs, dtype))
    out, lse = tfa.flash_attention(q, k, v, causal=causal, window=window,
                                   return_lse=True)
    hd = g.shape[-1]
    wide = torch.zeros(*g.shape[:-1], hd + 8, dtype=g.dtype, device="cuda")
    odd = torch.zeros(*g.shape[:-1], hd + 1, dtype=g.dtype, device="cuda")
    wide[..., :hd] = g
    odd[..., 1:] = g
    tol = 1e-4 if dtype == "float32" else 2e-2
    want = tref.blocked_attention_backward(q, k, v, out, lse, g,
                                           causal=causal, window=window)
    tfa.reset_layout_copy_counts()
    for do in (g, wide[..., :hd], odd[..., 1:]):
        grads = tfa.flash_attention_backward(q, k, v, out, lse, do,
                                             causal=causal, window=window)
        again = tfa.flash_attention_backward(q, k, v, out, lse, do,
                                             causal=causal, window=window)
        torch.cuda.synchronize()
        for a, a2, b in zip(grads, again, want):
            assert torch.equal(a, a2)
            err = float((a.float() - b.float()).abs().max())
            assert err <= tol * max(float(b.float().abs().max()), 1e-6)
    copies = 2 if dtype == "bfloat16" else 0
    assert tfa.layout_copy_counts() == {"flash_attention_bwd_dout": copies}
