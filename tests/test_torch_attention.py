"""The port's attention kernel layer against the JAX reference: the plain
version (``ref.attention``), the blocked streaming path, the dispatcher and
the kernel wrapper's CPU path, from the same numpy inputs.

Tolerances are the reference's own kernel tolerances
(tests/test_kernels.py): 2e-5 max abs in fp32 (sums in another order),
2e-2 in bf16 (the output is rounded to bf16, about 3 significant digits).
The Pallas kernel in interpret mode is a yardstick in fp32 only: its bf16
interpret cases fail in the reference itself.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)

# (S, T, H, KV, hd, causal, window): the reference's ATTN_CASES
ATTN_CASES = [
    (128, 128, 4, 4, 64, True, None),
    (256, 256, 4, 2, 64, True, None),
    (200, 200, 4, 2, 80, True, None),       # unaligned S, hd
    (128, 128, 8, 1, 128, True, None),      # MQA
    (128, 384, 2, 2, 64, False, None),      # cross/bidirectional
    (256, 256, 4, 4, 64, True, 100),        # sliding window
    (512, 512, 2, 2, 64, True, 128),        # window == block
]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(case, seed=0, B=2):
    S, T, H, KV, hd, _, _ = case
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, T, KV, hd)).astype(np.float32),
            rng.standard_normal((B, T, KV, hd)).astype(np.float32))


def _j(x, dtype):
    return jnp.asarray(x).astype(_JDT[dtype])


def _t(x, dtype):
    return torch.from_numpy(x).to(_TDT[dtype])


def _err(a, b) -> float:
    a = a.float().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(jnp.asarray(a).astype(jnp.float32))
    b = b.float().numpy() if isinstance(b, torch.Tensor) else \
        np.asarray(jnp.asarray(b).astype(jnp.float32))
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max())


def _jax_gqa_ref(q, k, v, causal, window):
    """The reference's oracle in the (B, S, H, hd) layout, as
    tests/test_kernels.py builds it."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    kr = jnp.repeat(k, G, 2).transpose(0, 2, 1, 3).reshape(B * H, T, hd)
    vr = jnp.repeat(v, G, 2).transpose(0, 2, 1, 3).reshape(B * H, T, hd)
    qr = q.transpose(0, 2, 1, 3).reshape(B * H, S, hd)
    o = jref.attention(qr, kr, vr, causal=causal, window=window)
    return o.reshape(B, H, S, hd).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_ref_attention_matches_reference(case, dtype):
    """The plain version in the reference's (BH, S, hd) layout."""
    S, T, H, KV, hd, causal, window = case
    rng = np.random.default_rng(1)
    q = rng.standard_normal((3, S, hd)).astype(np.float32)
    k = rng.standard_normal((3, T, hd)).astype(np.float32)
    v = rng.standard_normal((3, T, hd)).astype(np.float32)
    want = jref.attention(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                          causal=causal, window=window)
    got = tref.attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                         causal=causal, window=window)
    assert got.dtype == _TDT[dtype]
    assert _err(got, want) < TOL[dtype]


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_blocked_attention_matches_reference(case, dtype):
    S, T, H, KV, hd, causal, window = case
    q, k, v = _inputs(case)
    want = jops.blocked_attention(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                                  causal=causal, window=window)
    got = tops.blocked_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                                 causal=causal, window=window)
    assert got.dtype == _TDT[dtype]
    assert _err(got, want) < TOL[dtype]


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cpu_dispatch_and_kernel_wrapper_match_reference(case, dtype):
    """``ops.attention(impl="auto")`` takes the blocked path on the CPU and
    the kernel wrapper takes its plain version: both equal the reference's
    oracle."""
    S, T, H, KV, hd, causal, window = case
    q, k, v = _inputs(case, seed=2)
    want = _jax_gqa_ref(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                        causal, window)
    tq, tk, tv = _t(q, dtype), _t(k, dtype), _t(v, dtype)
    tfa.reset_launch_counts()
    for got in (tops.attention(tq, tk, tv, causal=causal, window=window),
                tops.flash_attention(tq, tk, tv, causal=causal,
                                     window=window)):
        assert got.shape == tq.shape and got.dtype == tq.dtype
        assert _err(got, want) < TOL[dtype]
    assert tfa.launch_counts() == {"flash_attention": 0}  # CPU: no launch


@pytest.mark.parametrize("case", ATTN_CASES)
def test_kernel_wrapper_matches_pallas_interpret_fp32(case):
    from jax.experimental import pallas as pl
    if not hasattr(pl, "load"):
        pytest.skip("this jax's Pallas has no pl.load: the reference's "
                    "interpret-mode kernel cannot run here")
    S, T, H, KV, hd, causal, window = case
    q, k, v = _inputs(case, seed=3)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=window,
                                interpret=True)
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window)
    assert _err(got, want) < TOL["float32"]


@pytest.mark.parametrize("prefix_len", [0, 24])
def test_blocked_prefix_lm_matches_reference(prefix_len):
    case = (96, 96, 4, 2, 16, True, None)
    q, k, v = _inputs(case, seed=4)
    want = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          impl="blocked", block=32, prefix_len=prefix_len)
    got = tops.attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), block=32, prefix_len=prefix_len)
    assert _err(got, want) < TOL["float32"]
    if prefix_len:
        with pytest.raises(NotImplementedError, match="prefix-LM"):
            tops.attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), impl="kernel",
                           prefix_len=prefix_len)


def test_default_impl_and_dispatch_errors():
    x = torch.zeros(1, 4, 2, 16)
    assert tops.default_attention_impl(x) == "blocked"
    with pytest.raises(ValueError, match="unknown attention impl"):
        tops.attention(x, x, x, impl="pallas")


@pytest.mark.parametrize("shapes,dtypes,match", [
    (((1, 8, 4, 16), (1, 8, 3, 16)), None, "H % KV"),
    (((1, 8, 4, 16), (1, 8, 2, 32)), None, "equal B and hd"),
    (((1, 8, 4, 16), (1, 8, 2, 16)), (torch.float16,) * 3, "float32 or"),
    (((1, 8, 4, 16), (1, 8, 2, 16)),
     (torch.float32, torch.bfloat16, torch.bfloat16), "one dtype"),
    (((8, 4, 16), (8, 2, 16)), None, r"\(B, S, H, hd\)"),
])
def test_kernel_wrapper_rejects_bad_operands(shapes, dtypes, match):
    dq, dk, dv = dtypes or (torch.float32,) * 3
    q = torch.zeros(shapes[0], dtype=dq)
    k = torch.zeros(shapes[1], dtype=dk)
    v = torch.zeros(shapes[1], dtype=dv)
    with pytest.raises(ValueError, match=match):
        tfa.flash_attention(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ATTN_CASES + [
    (100, 100, 4, 2, 16, True, None),      # tiny-lm / smoke head dim
    (130, 130, 4, 2, 120, True, None),     # h2o-danube head dim
    (96, 96, 4, 2, 16, True, 64),          # h2o-danube smoke window
])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_kernel_matches_plain_version(case, dtype):
    """The CUDA kernel against its plain version on the card (chip_smoke.py
    runs the same comparison, plus the serving prefill shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    S, T, H, KV, hd, causal, window = case
    q, k, v = (torch.from_numpy(a).to("cuda", _TDT[dtype])
               for a in _inputs(case, seed=5))
    tfa.reset_launch_counts()
    got = tfa.flash_attention(q, k, v, causal=causal, window=window)
    want = tref.attention_gqa(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.launch_counts() == {"flash_attention": 1}
    assert _err(got.cpu(), want.cpu()) < TOL[dtype]
