"""The port's chunk scans (kernels/ref.py, kernels/rwkv6_scan.py,
kernels/ssd.py, kernels/ops.py) against the JAX reference.

The same numpy inputs go to both packages.  On the CPU the port's
wrappers take the plain chunked versions, which are held to:

  * the reference's ``ops.wkv6`` / ``ops.ssd`` (the Pallas kernels in
    interpret mode) on the reference's own sweeps ``WKV_CASES`` and
    ``SSD_CASES``, at the same chunk;
  * the reference's token-level oracles ``ref.wkv6`` / ``ref.ssd``;
  * the reference models' ``_wkv_chunked`` / ``_ssd_chunked`` from a
    nonzero state, output and final state.

Tolerances: fp32 sums taken in another order than XLA's agree to a few
ulps of the largest value, so fp32 results are held to 2e-5 of
max(1, max |reference|); bf16 outputs are rounded once to bf16 by both
packages from fp32 arithmetic, so they may differ by one bf16 rounding,
2^-8 of max(1, max |reference|).  The CUDA kernels are held against the
plain versions by the ``cuda``-marked tests below (and chip_smoke.py
phase 9), which skip without a card.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import mamba2 as jmamba2
from repro.models import rwkv6 as jrwkv6
from repro_torch import kernels as tkernels
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_scan as twkv
from repro_torch.kernels import ssd as tssd
from _tf32 import mma

torch.set_num_threads(1)

# the reference's sweeps (tests/test_kernels.py)
WKV_CASES = [(2, 64, 16, 32), (3, 100, 16, 32), (1, 256, 32, 64),
             (4, 33, 8, 16)]
SSD_CASES = [(2, 64, 16, 8, 32), (3, 100, 32, 16, 32), (1, 256, 64, 64, 64)]
DTYPES = ["float32", "bfloat16"]
RTOL = {"float32": 2e-5, "bfloat16": 2.0 ** -8}


def _close(got, want, dtype="float32", what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, dtype=np.float32)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    bound = RTOL[dtype] * max(1.0, float(np.abs(want).max()))
    assert err <= bound, f"{what}: max abs err {err} > {bound}"


def _pair(a, dtype):
    """(jax array, torch tensor) of ``a`` in ``dtype`` (bf16 rounds the
    same numpy values the same way in both)."""
    if dtype == "bfloat16":
        return (jnp.asarray(a).astype(jnp.bfloat16),
                torch.from_numpy(a).to(torch.bfloat16))
    return jnp.asarray(a), torch.from_numpy(a)


def _wkv_inputs(BH, S, N, seed=0, lw_scale=1.0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((BH, S, N)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(lw_scale * rng.standard_normal((BH, S, N))).astype(
        np.float32)
    u = rng.standard_normal((BH, N)).astype(np.float32)
    return r, k, v, logw, u


def _ssd_inputs(BH, S, P, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BH, S, P)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((BH, S, N)).astype(np.float32)
              for _ in range(2))
    da = -np.abs(rng.standard_normal((BH, S, 1))).astype(np.float32)
    return x, Bm, Cm, da


@pytest.mark.parametrize("case", WKV_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_wkv6_matches_reference_kernel_and_oracle(case, dtype):
    BH, S, N, chunk = case
    r, k, v, logw, u = _wkv_inputs(BH, S, N, seed=1)
    (jr, tr), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in (r, k, v))
    got = tops.wkv6(tr, tk, tv, torch.from_numpy(logw), torch.from_numpy(u),
                    chunk=chunk)
    assert got.dtype == tr.dtype and got.shape == (BH, S, N)
    want = jops.wkv6(jr, jk, jv, jnp.asarray(logw), jnp.asarray(u),
                     chunk=chunk)
    _close(got, want, dtype, "vs reference ops.wkv6 (interpret)")
    if dtype == "float32":
        oracle = jref.wkv6(jr, jk, jv, jnp.asarray(logw), jnp.asarray(u))
        _close(tref.wkv6(tr, tk, tv, torch.from_numpy(logw),
                         torch.from_numpy(u)), oracle, dtype, "oracle")
        # the chunked form against the token-level recurrence: the
        # reference's own kernel-vs-oracle bound (tests/test_kernels.py)
        assert float(np.abs(got.numpy() - np.asarray(oracle)).max()) < 5e-4


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_ssd_matches_reference_kernel_and_oracle(case, dtype):
    BH, S, P, N, chunk = case
    x, Bm, Cm, da = _ssd_inputs(BH, S, P, N, seed=2)
    (jx, tx), (jb, tb), (jc, tc) = (_pair(a, dtype) for a in (x, Bm, Cm))
    got = tops.ssd(tx, tb, tc, torch.from_numpy(da), chunk=chunk)
    assert got.dtype == tx.dtype and got.shape == (BH, S, P)
    want = jops.ssd(jx, jb, jc, jnp.asarray(da), chunk=chunk)
    _close(got, want, dtype, "vs reference ops.ssd (interpret)")
    if dtype == "float32":
        oracle = jref.ssd(jx, jb, jc, jnp.asarray(da))
        _close(tref.ssd(tx, tb, tc, torch.from_numpy(da)), oracle, dtype,
               "oracle")
        assert float(np.abs(got.numpy() - np.asarray(oracle)).max()) < 5e-4


@pytest.mark.parametrize("S", [64, 77])
def test_wkv_chunked_with_state_matches_reference_model(S):
    """The model's entry: (B, S, H, N) in place, u (H, N), a nonzero
    state in and the final state out, at the model's chunk (32); S = 77
    leaves a ragged last chunk."""
    B, H, N = 2, 3, 16
    rng = np.random.default_rng(3)
    r, k, v = (rng.standard_normal((B, S, H, N)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((B, S, H, N))).astype(np.float32)
    u = rng.standard_normal((H, N)).astype(np.float32)
    s0 = rng.standard_normal((B, H, N, N)).astype(np.float32)
    jy, js = jrwkv6._wkv_chunked(*(jnp.asarray(a)
                                   for a in (r, k, v, logw, u, s0)))
    state = torch.from_numpy(s0.copy())
    ty = twkv.wkv6(*(torch.from_numpy(a) for a in (r, k, v, logw, u)),
                   state, chunk=32)
    _close(ty, jy, what="y")
    _close(state, js, what="final state (written in place)")


@pytest.mark.parametrize("S", [64, 77])
def test_ssd_chunked_with_state_matches_reference_model(S):
    """The model's entry: x (B, S, H, P), B/C (B, S, N) shared by the
    heads, da (B, S, H), a nonzero state in and the final state out, at
    zamba2-smoke's chunk (32)."""
    B, H, P, N = 2, 4, 16, 8
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, N)).astype(np.float32)
              for _ in range(2))
    da = -np.abs(rng.standard_normal((B, S, H))).astype(np.float32)
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    jy, jh = jmamba2._ssd_chunked(*(jnp.asarray(a)
                                    for a in (x, Bm, Cm, da, h0)), 32)
    h = torch.from_numpy(h0.copy())
    ty = tssd.ssd_scan(*(torch.from_numpy(a) for a in (x, Bm, Cm, da)), h,
                       chunk=32)
    _close(ty, jy, what="y")
    _close(h, jh, what="final state (written in place)")


def test_chunk_is_only_a_rounding_choice():
    """A chunk of 16 and one of 64 give the same scan (the kernels take
    their own chunk for that reason)."""
    B, S, H, N = 1, 90, 2, 16
    rng = np.random.default_rng(5)
    args = [torch.from_numpy(rng.standard_normal((B, S, H, N)).astype(
        np.float32)) for _ in range(3)]
    logw = -torch.exp(torch.from_numpy(rng.standard_normal(
        (B, S, H, N)).astype(np.float32)))
    u = torch.from_numpy(rng.standard_normal((H, N)).astype(np.float32))
    ys = [twkv.wkv6(*args, logw, u, torch.zeros(B, H, N, N), chunk=c)
          for c in (16, 64)]
    torch.testing.assert_close(ys[0], ys[1], rtol=0, atol=2e-5 * float(
        ys[1].abs().max()))


def test_wkv6_strong_decay_stable():
    """logw = -8 over a chunk of 64: a factored exp would overflow."""
    BH, S, N = 2, 128, 16
    r, k, v, _, _ = _wkv_inputs(BH, S, N, seed=6)
    logw = np.full((BH, S, N), -8.0, np.float32)
    y = tops.wkv6(*(torch.from_numpy(a) for a in (r, k, v, logw)),
                  torch.zeros(BH, N), chunk=64)
    assert bool(torch.isfinite(y).all())
    want = jops.wkv6(*(jnp.asarray(a) for a in (r, k, v, logw)),
                     jnp.zeros((BH, N)), chunk=64)
    _close(y, want, what="strong decay")


def test_cpu_wrappers_launch_nothing():
    twkv.reset_launch_counts()
    tssd.reset_launch_counts()
    r, k, v, logw, u = _wkv_inputs(2, 40, 16, seed=7)
    tops.wkv6(*(torch.from_numpy(a) for a in (r, k, v, logw, u)))
    tops.ssd(*(torch.from_numpy(a) for a in _ssd_inputs(2, 40, 16, 8)))
    # each module counts its backward kernel beside its forward
    assert twkv.launch_counts() == {"wkv6": 0, "wkv6_bwd_dstate": 0,
                                    "wkv6_bwd": 0}
    assert tssd.launch_counts() == {"ssd": 0, "ssd_bwd_dstate": 0,
                                    "ssd_bwd": 0}


def test_launch_counts_gather_every_kernel():
    tkernels.reset_launch_counts()
    assert tkernels.launch_counts() == {
        "compress": 0, "decompress": 0, "roundtrip": 0,
        "flash_attention": 0, "flash_attention_bwd": 0, "wkv6": 0,
        "wkv6_bwd_dstate": 0, "wkv6_bwd": 0, "ssd": 0, "ssd_bwd_dstate": 0,
        "ssd_bwd": 0, "im2col": 0, "col2im": 0, "pool": 0, "pool_bwd": 0}


def test_library_counts_only_successful_launches(monkeypatch):
    """A launch that returns a CUDA error raises with its message and is
    not counted; a clean one counts once (a stand-in for the ctypes
    library: nothing is built)."""
    monkeypatch.setattr(tbuild, "_COUNTS", [])
    lib = tbuild.Library("stand_in", "err", {"fwd": []}, kernels=("k",))
    rcs = iter([0, 700])
    lib._lib = type("Lib", (), {"fwd": staticmethod(lambda: next(rcs)),
                                "err": staticmethod(lambda rc: b"boom")})
    lib.launch("k", "fwd")
    with pytest.raises(RuntimeError, match=r"k kernel launch failed: CUDA "
                       r"error 700 \(boom\)"):
        lib.launch("k", "fwd")
    assert lib.launch_counts() == tbuild.launch_counts() == {"k": 1}
    tbuild.reset_launch_counts()
    assert lib.launch_counts() == {"k": 0}


@pytest.mark.parametrize("which,match", [
    ("wkv_shape", "one shape"), ("wkv_u", "u must be"),
    ("wkv_u_per_row", "u must be"),
    ("wkv_state", "state must be float32"), ("wkv_dtype", "float32 or"),
    ("ssd_shape", "do not match"), ("ssd_h", "h must be float32"),
    ("ssd_dtype", "float32 or"),
])
def test_wrappers_reject_bad_operands(which, match):
    z = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt)  # noqa
    with pytest.raises(ValueError, match=match):
        if which == "wkv_shape":
            twkv.wkv6(z(1, 4, 2, 8), z(1, 4, 2, 8), z(1, 4, 2, 8),
                      z(1, 5, 2, 8), z(2, 8), z(1, 2, 8, 8))
        elif which == "wkv_u":
            twkv.wkv6(*[z(1, 4, 2, 8)] * 4, z(3, 8), z(1, 2, 8, 8))
        elif which == "wkv_u_per_row":   # u is one (H, N) bonus per head
            twkv.wkv6(*[z(1, 4, 2, 8)] * 4, z(1, 2, 8), z(1, 2, 8, 8))
        elif which == "wkv_state":
            twkv.wkv6(*[z(1, 4, 2, 8)] * 4, z(2, 8),
                      z(1, 2, 8, 8, dt=torch.bfloat16))
        elif which == "wkv_dtype":
            twkv.wkv6(*[z(1, 4, 2, 8, dt=torch.float16)] * 3, z(1, 4, 2, 8),
                      z(2, 8), z(1, 2, 8, 8))
        elif which == "ssd_shape":
            tssd.ssd_scan(z(1, 4, 2, 8), z(1, 4, 8), z(1, 4, 8), z(1, 4, 3),
                          z(1, 2, 8, 8))
        elif which == "ssd_h":
            tssd.ssd_scan(z(1, 4, 2, 8), z(1, 4, 8), z(1, 4, 8), z(1, 4, 2),
                          z(1, 2, 8, 4))
        else:
            tssd.ssd_scan(z(1, 4, 2, 8, dt=torch.bfloat16), z(1, 4, 8),
                          z(1, 4, 8), z(1, 4, 2), z(1, 2, 8, 8))


# --- the CUDA kernels (skip without a card) ----------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", [dict(B=2, S=100, H=4, N=16),
                                  dict(B=3, S=70, H=5, N=64)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_wkv6_matches_plain_version(case, dtype):
    """B3 against the chunked plain version on the card, from a nonzero
    state (chip_smoke.py phase 9 adds the sweeps and the full width)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    B, S, H, N = case["B"], case["S"], case["H"], case["N"]
    g = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *s: torch.randn(*s, device="cuda", generator=g)  # noqa
    dt = getattr(torch, dtype)
    r, k, v = (rnd(B, S, H, N).to(dt) for _ in range(3))
    logw, u, s0 = -torch.exp(rnd(B, S, H, N)), rnd(H, N), rnd(B, H, N, N)
    state = s0.clone()
    twkv.reset_launch_counts()
    got = twkv.wkv6(r, k, v, logw, u, state)
    want, s_want = tref.wkv6_chunked(r, k, v, logw, u, s0, 32)
    torch.cuda.synchronize()
    assert twkv.launch_counts() == {"wkv6": 1, "wkv6_bwd_dstate": 0,
                                    "wkv6_bwd": 0}
    tol = 1e-4 if dtype == "float32" else 1e-2
    assert float((got.float() - want).abs().max()) <= \
        tol * float(want.abs().max())
    assert float((state - s_want).abs().max()) <= \
        tol * float(s_want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", [dict(B=2, S=100, H=8, P=16, N=16),
                                  dict(B=2, S=77, H=6, P=64, N=64)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_ssd_matches_plain_version(case, dtype):
    """B4 against the chunked plain version on the card, from a nonzero
    state, B and C shared by the heads."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    B, S, H, P, N = (case[k] for k in ("B", "S", "H", "P", "N"))
    g = torch.Generator(device="cuda").manual_seed(1)
    rnd = lambda *s: torch.randn(*s, device="cuda", generator=g)  # noqa
    dt = getattr(torch, dtype)
    x, Bm, Cm = rnd(B, S, H, P).to(dt), rnd(B, S, N).to(dt), \
        rnd(B, S, N).to(dt)
    da, h0 = -rnd(B, S, H).abs(), rnd(B, H, P, N)
    h = h0.clone()
    tssd.reset_launch_counts()
    got = tssd.ssd_scan(x, Bm, Cm, da, h)
    want, h_want = tref.ssd_chunked(x, Bm, Cm, da, h0, 128)
    torch.cuda.synchronize()
    assert tssd.launch_counts() == {"ssd": 1, "ssd_bwd_dstate": 0,
                                    "ssd_bwd": 0}
    tol = 1e-4 if dtype == "float32" else 1e-2
    assert float((got.float() - want).abs().max()) <= \
        tol * float(want.abs().max())
    assert float((h - h_want).abs().max()) <= tol * float(h_want.abs().max())


# --- the CUDA designs' arithmetic, emulated on the CPU ------------------------

def _wkv_subblock(r, k, v, logw, u, state, chunk=32, block=16):
    """WKV6 chunkwise as B3 (csrc/wkv6.cu) builds it, in f32 torch:
    r/k/v/logw (B, S, H, N), u (H, N), state (B, H, N, N).  Within a chunk
    the attention matrix A is built in blocks of ``block`` tokens: a key
    block strictly before a query block is one product over the channels,
      A[t][s] = sum_i (r_t e^{cum_prev_t - ref}) (k_s e^{ref - cum_s}),
    with ref = cum at the key block's last token (both exponents <= 0);
    pairwise exps only inside the diagonal blocks; the bonus u on the
    diagonal.  Returns (y, final state)."""
    B, S, H, N = r.shape
    pad = -S % chunk
    f = lambda a: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))  # noqa
    r, k, v, logw = (f(a).float().permute(0, 2, 1, 3) for a in (r, k, v,
                                                                 logw))
    ys = []
    for c0 in range(0, S + pad, chunk):
        rc, kc, vc, lw = (a[:, :, c0:c0 + chunk] for a in (r, k, v, logw))
        cum = torch.cumsum(lw, dim=2)
        cp = cum - lw
        A = torch.zeros(B, H, chunk, chunk)
        for q0 in range(0, chunk, block):
            tq = slice(q0, q0 + block)
            # the diagonal block pairwise, strictly below its diagonal
            diff = cp[:, :, tq, None, :] - cum[:, :, None, tq, :]
            low = torch.tril(torch.ones(block, block, dtype=torch.bool), -1)
            diff = torch.where(low[None, None, :, :, None], diff, -math.inf)
            A[:, :, tq, tq] = torch.einsum("bhti,bhsi,bhtsi->bhts",
                                           rc[:, :, tq], kc[:, :, tq],
                                           torch.exp(diff))
            for k0 in range(0, q0, block):
                ts = slice(k0, k0 + block)
                ref = cum[:, :, k0 + block - 1:k0 + block]
                rq = rc[:, :, tq] * torch.exp(cp[:, :, tq] - ref)
                ks = kc[:, :, ts] * torch.exp(ref - cum[:, :, ts])
                A[:, :, tq, ts] = rq @ ks.transpose(-1, -2)
        idx = torch.arange(chunk)
        A[:, :, idx, idx] = torch.einsum("bhti,bhti,hi->bht", rc, kc,
                                         u.float())
        y = (rc * torch.exp(cp)) @ state + A @ vc
        last = cum[:, :, -1:]
        state = torch.exp(last[:, :, 0])[..., None] * state + \
            (kc * torch.exp(last - cum)).transpose(-1, -2) @ vc
        ys.append(y)
    y = torch.cat(ys, dim=2).permute(0, 2, 1, 3)[:, :S]
    return y, state


@pytest.mark.parametrize("block", [8, 16])
@pytest.mark.parametrize("strong", [False, True])
def test_wkv_subblock_factorisation_matches_reference(block, strong):
    """B3's A by sub-blocks (16 tokens as designed, 8 as the kernel runs
    it) against the reference's token-level oracle and its model scan
    from a nonzero state; logw = -8 (strong decay) stays finite and
    exact, since no exponent is positive."""
    B, S, H, N = 2, 64, 2, 16
    rng = np.random.default_rng(11)
    r, k, v = (rng.standard_normal((B, S, H, N)).astype(np.float32)
               for _ in range(3))
    logw = (np.full((B, S, H, N), -8.0, np.float32) if strong else
            -np.exp(rng.standard_normal((B, S, H, N))).astype(np.float32))
    u = rng.standard_normal((H, N)).astype(np.float32)
    s0 = rng.standard_normal((B, H, N, N)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (r, k, v, logw, u)]
    y, s = _wkv_subblock(*t, torch.from_numpy(s0), block=block)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    jy, js = jrwkv6._wkv_chunked(*(jnp.asarray(a)
                                   for a in (r, k, v, logw, u, s0)))
    _close(y, jy, what="y vs the reference model scan")
    _close(s, js, what="state vs the reference model scan")
    # from a zero state, against the token-level oracle, (BH, S, N) rows
    y0, _ = _wkv_subblock(*t, torch.zeros(B, H, N, N), block=block)
    rows = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3).reshape(  # noqa
        B * H, S, N))
    oracle = jref.wkv6(rows(r), rows(k), rows(v), rows(logw),
                       jnp.asarray(np.tile(u, (B, 1))))
    _close(y0.permute(0, 2, 1, 3).reshape(B * H, S, N), oracle,
           what="y vs the token-level oracle")


@pytest.mark.parametrize("seed", [0, 3])
def test_bf16_wkv_is_one_rounding_from_fp32_not_within_the_sweep_bound(seed):
    """Why chip_smoke.py phase 9 holds bf16 scans to the oracle only on its
    own draws: the reference's sweep bound for bf16 WKV6 (5e-2 absolute)
    is less than one bf16 rounding of an output of 8 or more (2^-4).  The
    plain chunked version, rounded once to bf16, misses it against the
    bf16 oracle on these draws, yet every output is within one rounding
    (2^-8 relative) of the fp32 oracle, as a kernel's must be."""
    BH, S, N = 1, 256, 32
    rng = np.random.default_rng(seed)
    r, k, v = (torch.from_numpy(rng.standard_normal((BH, S, N)).astype(
        np.float32)).bfloat16() for _ in range(3))
    logw = -torch.exp(torch.from_numpy(rng.standard_normal(
        (BH, S, N)).astype(np.float32)))
    u = torch.from_numpy(rng.standard_normal((BH, N)).astype(np.float32))
    heads = lambda a: a.transpose(0, 1)[None]  # noqa: E731
    y, _ = tref.wkv6_chunked(heads(r), heads(k), heads(v), heads(logw), u,
                             torch.zeros(1, BH, N, N), 32)
    y = y.to(torch.bfloat16)[0].transpose(0, 1).float()
    want16 = tref.wkv6(r, k, v, logw, u).float()
    want32 = tref.wkv6(r.float(), k.float(), v.float(), logw, u)
    assert float((y - want16).abs().max()) > 5e-2
    bound = 2.0 ** -8 * want32.abs() + 1e-5 * want32.abs().max()
    assert float(((y - want32).abs() / bound).max()) <= 1.0


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("product", ["readout", "state"])
def test_3xtf32_holds_fp32_tolerance_and_tf32_does_not(seed, product):
    """The numerics argument of the scan kernels' products at N = 64 and a
    chunk of 32: (C x N)(N x N), the cross-chunk readout, and (N x C)(C x
    N), the state update, in 3xTF32 stay within 1e-4 of the largest
    value (chip_smoke.py's SCAN_RTOL for fp32), and plain TF32 does not."""
    rng = np.random.default_rng(seed)
    C, N = 32, 64
    decay = np.exp(-np.cumsum(np.exp(rng.standard_normal((C, N))), 0))
    if product == "readout":     # (r e^{cum_prev}) @ S
        a = (rng.standard_normal((C, N)) * decay).astype(np.float32)
        b = rng.standard_normal((N, N)).astype(np.float32)
    else:                        # (k e^{cum_C - cum})^T @ v
        a = (rng.standard_normal((C, N)) * decay[::-1]).T.astype(np.float32)
        b = rng.standard_normal((C, N)).astype(np.float32)
    want = a.astype(np.float64) @ b
    rel = {s: float(np.abs(mma(a, b, s) - want).max() / np.abs(want).max())
           for s in ("3xtf32", "tf32")}
    assert rel["3xtf32"] <= 1e-4 and rel["3xtf32"] < 1e-5, rel
    assert rel["tf32"] > 1e-4, rel


def test_library_query_counts_no_launch(monkeypatch):
    """A query (the kernels' occupancy) returns its value and counts no
    launch; a negative value is a CUDA error, raised with its message."""
    monkeypatch.setattr(tbuild, "_COUNTS", [])
    lib = tbuild.Library("stand_in", "err", {"ctas": []}, kernels=("k",))
    rcs = iter([3, -700])
    lib._lib = type("Lib", (), {"ctas": staticmethod(lambda: next(rcs)),
                                "err": staticmethod(lambda rc: b"boom")})
    assert lib.query("ctas") == 3
    with pytest.raises(RuntimeError, match=r"ctas failed: CUDA error 700 "
                       r"\(boom\)"):
        lib.query("ctas")
    assert lib.launch_counts() == {"k": 0}
