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
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

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


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_backward_matches_plain_version(case, dtype):
    """On the card: the forward's lse and the backward kernel against the
    plain versions on the same inputs (fp32 1e-4, bf16 2e-2 of each
    gradient's max)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    arrs, causal, window = _inputs(case, dtype)
    q, k, v, g = (t.cuda() for t in _torch(arrs, dtype))
    out, lse = tfa.flash_attention(q, k, v, causal=causal, window=window,
                                   return_lse=True)
    grads = tfa.flash_attention_backward(q, k, v, out, lse, g,
                                         causal=causal, window=window)
    torch.cuda.synchronize()
    want = tref.blocked_attention_backward(q, k, v, out, lse, g,
                                           causal=causal, window=window)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for a, b in zip(grads, want):
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * max(float(b.float().abs().max()), 1e-6)
