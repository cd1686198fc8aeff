"""The chunk scans' backward in two passes (kernels/ref.py
``wkv6_chunk_dstates`` / ``ssd_chunk_dstates``, pass 1, and
``wkv6_chunk_grads`` / ``ssd_chunk_grads``, pass 2: the plain versions of
csrc/wkv6_bwd.cu and csrc/ssd_bwd.cu, whose composition is
``*_chunked_backward``) against the JAX reference's autodiff of its own
chunk scans (``models/rwkv6.py:_wkv_chunked``,
``models/mamba2.py:_ssd_chunked``), with the same numpy inputs.

Pass 1 gives, for every chunk c, the gradient of the state at chunk c's
start: it must be ``jax.vjp`` with respect to the state of the reference
run on tokens [c C, S) from the forward's state at c C, with the same
cotangents on y and on the final state.  Pass 2 takes every chunk on its
own: its gradients must be ``jax.vjp`` of the reference run on that
chunk's tokens alone, from that chunk's start state, with pass 1's
gradient after the chunk as the final state's cotangent.  The wrappers
(kernels/rwkv6_scan.py, kernels/ssd.py) take these plain versions on the
CPU and launch nothing.

Tolerances: each gradient within 2e-5 of its max |value|, the bound of
tests/test_torch_recurrent_train.py (fp32, sums in another order than
XLA's autodiff).  Log decays go down to -8 for WKV6; SSD's decays stay
where the reference's gradient is finite (chunk sums well below 88).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba2 as jmamba2
from repro.models import rwkv6 as jrwkv6
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_scan as twkv
from repro_torch.kernels import build as tbuild
from repro_torch.kernels import ssd as tssd

torch.set_num_threads(1)

SCAN_RTOL = 2e-5
C = 32   # the kernels' chunk, and the reference's WKV6 chunk


def _rel(got, want) -> float:
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _wkv_inputs(B, S, H, N, seed):
    rng = np.random.default_rng(seed)
    r, k, v, dy = (rng.standard_normal((B, S, H, N)).astype(np.float32)
                   for _ in range(4))
    logw = np.clip(-np.exp(rng.standard_normal((B, S, H, N))) * 2.0,
                   -8.0, 0.0).astype(np.float32)
    u = rng.standard_normal((H, N)).astype(np.float32)
    s0, ds = (rng.standard_normal((B, H, N, N)).astype(np.float32)
              for _ in range(2))
    return (r, k, v, logw, u, s0), dy, ds


def _ssd_inputs(B, S, H, P, N, seed, scale):
    rng = np.random.default_rng(seed)
    x, dy = (rng.standard_normal((B, S, H, P)).astype(np.float32)
             for _ in range(2))
    Bm, Cm = (rng.standard_normal((B, S, N)).astype(np.float32)
              for _ in range(2))
    da = -rng.uniform(0.0, scale, (B, S, H)).astype(np.float32)
    h0, dh = (rng.standard_normal((B, H, P, N)).astype(np.float32)
              for _ in range(2))
    return (x, Bm, Cm, da, h0), dy, dh


def _t(arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


def _tokens(arrays, lo, hi):
    """The (B, S, ...) arrays cut to tokens [lo, hi); others as they are."""
    return [a[:, lo:hi] for a in arrays]


def _wkv_state(ins, t0):
    """The reference's state after tokens [0, t0) (state0 at t0 = 0)."""
    r, k, v, logw, u, s0 = ins
    if t0 == 0:
        return jnp.asarray(s0)
    return jrwkv6._wkv_chunked(*_j(_tokens((r, k, v, logw), 0, t0)),
                               jnp.asarray(u), jnp.asarray(s0))[1]


def _ssd_state(ins, t0):
    x, Bm, Cm, da, h0 = ins
    if t0 == 0:
        return jnp.asarray(h0)
    return jmamba2._ssd_chunked(*_j(_tokens((x, Bm, Cm, da), 0, t0)),
                                jnp.asarray(h0), C)[1]


@pytest.mark.parametrize("S", [50, 100])
def test_wkv6_pass1_gives_the_state_gradient_at_every_chunk(S):
    """dstate at chunk c's start (dstate0 for c = 0, pass 1's entry c - 1
    after) against jax.vjp with respect to the state of ``_wkv_chunked``
    on tokens [c C, S); the last entry is the final state's cotangent."""
    ins, dy, ds = _wkv_inputs(2, S, 3, 16, seed=S)
    r, k, v, logw, u, s0 = ins
    dstates, ds0 = tref.wkv6_chunk_dstates(*_t((r, logw, dy, ds)), chunk=C)
    nc = -(-S // C)
    assert tuple(dstates.shape) == (2, 3, nc, 16, 16)
    assert torch.equal(dstates[:, :, -1], torch.from_numpy(ds))
    for c in range(nc):
        def suffix(state, c=c):
            return jrwkv6._wkv_chunked(
                *_j(_tokens((r, k, v, logw), c * C, S)), jnp.asarray(u),
                state)
        _, vjp = jax.vjp(suffix, _wkv_state(ins, c * C))
        (want,) = vjp((jnp.asarray(dy[:, c * C:]), jnp.asarray(ds)))
        got = ds0 if c == 0 else dstates[:, :, c - 1]
        assert np.isfinite(np.asarray(want)).all()
        assert _rel(got, want) <= SCAN_RTOL, (c, _rel(got, want))


@pytest.mark.parametrize("scale", [0.1, 2.0])
def test_ssd_pass1_gives_the_state_gradient_at_every_chunk(scale):
    """The same for SSD at a ragged S = 100 and chunk 32, da from -U(0,
    scale) (chunk sums below 88: the reference's gradient is finite)."""
    S = 100
    ins, dy, dh = _ssd_inputs(2, S, 3, 8, 6, seed=int(10 * scale),
                              scale=scale)
    x, Bm, Cm, da, h0 = ins
    dstates, dh0 = tref.ssd_chunk_dstates(*_t((Cm, da, dy, dh)), chunk=C)
    nc = -(-S // C)
    assert tuple(dstates.shape) == (2, 3, nc, 8, 6)
    assert torch.equal(dstates[:, :, -1], torch.from_numpy(dh))
    for c in range(nc):
        def suffix(state, c=c):
            return jmamba2._ssd_chunked(
                *_j(_tokens((x, Bm, Cm, da), c * C, S)), state, C)
        _, vjp = jax.vjp(suffix, _ssd_state(ins, c * C))
        (want,) = vjp((jnp.asarray(dy[:, c * C:]), jnp.asarray(dh)))
        got = dh0 if c == 0 else dstates[:, :, c - 1]
        assert np.isfinite(np.asarray(want)).all()
        assert _rel(got, want) <= SCAN_RTOL, (c, _rel(got, want))


def test_wkv6_pass2_takes_every_chunk_on_its_own():
    """Pass 2's gradients of chunk c (and its part of du) against jax.vjp
    of ``_wkv_chunked`` on chunk c's tokens alone, from the chunk's start
    state, with pass 1's gradient after the chunk on the final state."""
    S = 80
    ins, dy, ds = _wkv_inputs(2, S, 3, 16, seed=7)
    r, k, v, logw, u, s0 = ins
    tins = _t(ins)
    states = tref.wkv6_chunk_states(*tins[1:4], tins[5], chunk=C)
    dstates, _ = tref.wkv6_chunk_dstates(*_t((r, logw, dy, ds)), chunk=C)
    got = tref.wkv6_chunk_grads(*tins[:5], states, dstates,
                                torch.from_numpy(dy), chunk=C)
    for c in range(-(-S // C)):
        lo, hi = c * C, min(S, (c + 1) * C)

        def chunk(r_, k_, v_, lw_, u_, c=c):
            return jrwkv6._wkv_chunked(r_, k_, v_, lw_, u_,
                                       _wkv_state(ins, c * C))
        _, vjp = jax.vjp(chunk, *_j(_tokens((r, k, v, logw), lo, hi)),
                         jnp.asarray(u))
        want = vjp((jnp.asarray(dy[:, lo:hi]),
                    jnp.asarray(dstates[:, :, c].numpy())))
        for name, g, w in zip(("r", "k", "v", "logw"), got[:4], want[:4]):
            assert _rel(g[:, lo:hi], w) <= SCAN_RTOL, (c, name)
        assert _rel(got[4][:, :, c].sum(0), want[4]) <= SCAN_RTOL, (c, "u")


def test_ssd_pass2_takes_every_chunk_on_its_own():
    """The same for SSD: dx, dda and each head's dB and dC (summed over the
    heads) of chunk c against jax.vjp of ``_ssd_chunked`` on chunk c
    alone."""
    S = 80
    ins, dy, dh = _ssd_inputs(2, S, 3, 8, 6, seed=8, scale=1.0)
    x, Bm, Cm, da, h0 = ins
    tins = _t(ins)
    states = tref.ssd_chunk_states(tins[0], tins[1], tins[3], tins[4],
                                   chunk=C)
    dstates, _ = tref.ssd_chunk_dstates(*_t((Cm, da, dy, dh)), chunk=C)
    dx, dB, dC, dda = tref.ssd_chunk_grads(*tins[:4], states, dstates,
                                           torch.from_numpy(dy), chunk=C)
    assert tuple(dB.shape) == tuple(dC.shape) == (2, S, 3, 6)
    for c in range(-(-S // C)):
        lo, hi = c * C, min(S, (c + 1) * C)

        def chunk(x_, B_, C_, da_, c=c):
            return jmamba2._ssd_chunked(x_, B_, C_, da_,
                                        _ssd_state(ins, c * C), C)
        _, vjp = jax.vjp(chunk, *_j(_tokens((x, Bm, Cm, da), lo, hi)))
        want = vjp((jnp.asarray(dy[:, lo:hi]),
                    jnp.asarray(dstates[:, :, c].numpy())))
        for name, g, w in zip(("x", "B", "C", "da"),
                              (dx, dB.sum(2), dC.sum(2), dda), want):
            assert np.isfinite(np.asarray(w)).all(), name
            assert _rel(g[:, lo:hi], w) <= SCAN_RTOL, (c, name)


def test_cpu_pass_wrappers_take_the_plain_versions():
    """On the CPU each pass's wrapper is its plain version (bitwise) and
    launches nothing; the passes composed as the CUDA route composes them
    give ``*_chunked_backward``'s gradients bitwise."""
    twkv.reset_launch_counts()
    tssd.reset_launch_counts()
    ins, dy, ds = _wkv_inputs(2, 70, 3, 8, seed=9)
    r, k, v, logw, u, s0 = tins = _t(ins)
    dy_, ds_ = _t((dy, ds))
    dstates, ds0 = twkv.wkv6_backward_dstates(r, logw, dy_, ds_)
    want = tref.wkv6_chunk_dstates(r, logw, dy_, ds_, 32)
    assert torch.equal(dstates, want[0]) and torch.equal(ds0, want[1])
    states = tref.wkv6_chunk_states(k, v, logw, s0, 32)
    grads = twkv.wkv6_backward_chunks(r, k, v, logw, u, states, dstates, dy_)
    composed = (*grads[:4], grads[4].sum((0, 2)), ds0)
    for g, w in zip(composed, twkv.wkv6_backward(*tins, dy_, ds_)):
        assert torch.equal(g, w)

    ins, dy, dh = _ssd_inputs(2, 70, 3, 8, 6, seed=10, scale=1.0)
    x, Bm, Cm, da, h0 = tins = _t(ins)
    dy_, dh_ = _t((dy, dh))
    dstates, dh0 = tssd.ssd_backward_dstates(Cm, da, dy_, dh_)
    want = tref.ssd_chunk_dstates(Cm, da, dy_, dh_, 32)
    assert torch.equal(dstates, want[0]) and torch.equal(dh0, want[1])
    states = tref.ssd_chunk_states(x, Bm, da, h0, 32)
    dx, dB, dC, dda = tssd.ssd_backward_chunks(x, Bm, Cm, da, states,
                                               dstates, dy_)
    for g, w in zip((dx, dB.sum(2), dC.sum(2), dda, dh0),
                    tssd.ssd_backward(*tins, dy_, dh_)):
        assert torch.equal(g, w)
    assert twkv.launch_counts() == {"wkv6": 0, "wkv6_bwd_dstate": 0,
                                    "wkv6_bwd": 0}
    assert tssd.launch_counts() == {"ssd": 0, "ssd_bwd_dstate": 0,
                                    "ssd_bwd": 0}
    # operands of another shape are refused before any kernel could read
    # past them
    with pytest.raises(ValueError, match="wkv6_backward_chunks"):
        twkv.wkv6_backward_chunks(r, k[:, :8], v, logw, u, states, dstates,
                                  dy_)
    with pytest.raises(ValueError, match="ssd_backward_chunks"):
        tssd.ssd_backward_chunks(x, Bm, Cm, da[:, :8], states, dstates, dy_)


@pytest.mark.parametrize("kind", ["wkv6", "ssd"])
def test_backward_operand_checks_are_shared(kind):
    """Both backward wrappers take their operands through one check
    (kernels/build.py): float32 only, sizes up to the kernels' 64, the
    card's state tensors of the exact shape; contiguous copies come
    back."""
    dims = ({"head size": 64} if kind == "wkv6" else
            {"head_dim": 64, "d_state": 64})
    t = torch.zeros(4, 6).t()
    (got,) = tbuild.bwd_operands(kind, (t,), dims, 64)
    assert got.is_contiguous() and torch.equal(got, t)
    with pytest.raises(ValueError, match="fp32 only"):
        tbuild.bwd_operands(kind, (t.bfloat16(),), dims, 64)
    over = dict(dims, **{next(iter(dims)): 65})
    with pytest.raises(ValueError, match=" and ".join(dims) + " <= 64"):
        tbuild.bwd_operands(kind, (t,), over, 64)
    want = (1, 2, 3, 4, 4)
    tbuild.check_states(kind, torch.zeros(want), want,
                           torch.device("cpu"), "states")
    for bad in (None, torch.zeros(1, 2, 3, 4, 5),
                torch.zeros(want, dtype=torch.float64)):
        with pytest.raises(ValueError, match="on the card reads states"):
            tbuild.check_states(kind, bad, want, torch.device("cpu"),
                                   "states")


# ---------------------------------------------------------------------------
# the CUDA kernels (skip without a card)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(1, 20), (2, 100), (2, 256)])
def test_cuda_pass1_matches_plain_version(B, S):
    """Each backward's pass 1 alone on the card (one launch each) against
    its plain version: every state gradient and the one at the start."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    ins, dy, ds = _wkv_inputs(B, S, 3, 64, seed=S)
    r, logw, dy_, ds_ = (t.cuda() for t in _t((ins[0], ins[3], dy, ds)))
    twkv.reset_launch_counts()
    got = twkv.wkv6_backward_dstates(r, logw, dy_, ds_)
    torch.cuda.synchronize()
    assert twkv.launch_counts() == {"wkv6": 0, "wkv6_bwd_dstate": 1,
                                    "wkv6_bwd": 0}
    want = tref.wkv6_chunk_dstates(r, logw, dy_, ds_, 32)
    for g, w in zip(got, want):
        assert _rel(g.cpu(), w.cpu().numpy()) <= 1e-4

    ins, dy, dh = _ssd_inputs(B, S, 4, 64, 64, seed=S, scale=1.0)
    Cm, da, dy_, dh_ = (t.cuda() for t in _t((ins[2], ins[3], dy, dh)))
    tssd.reset_launch_counts()
    got = tssd.ssd_backward_dstates(Cm, da, dy_, dh_)
    torch.cuda.synchronize()
    assert tssd.launch_counts() == {"ssd": 0, "ssd_bwd_dstate": 1,
                                    "ssd_bwd": 0}
    want = tref.ssd_chunk_dstates(Cm, da, dy_, dh_, 32)
    for g, w in zip(got, want):
        assert _rel(g.cpu(), w.cpu().numpy()) <= 1e-4


@pytest.mark.cuda
def test_cuda_backward_attrs_report_each_pass():
    """Each pass's occupancy query: registers, shared memory, threads a
    CTA (WKV6's pass 1 eight warps, the rest four) and at least 8 warps
    resident on an SM for pass 2."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    for mod, threads1 in ((twkv, 256), (tssd, 128)):
        for which, threads in ((1, threads1), (2, 128)):
            a = mod.bwd_attrs(which)
            assert a["threads"] == threads, (mod.__name__, which, a)
            assert a["ctas_per_sm"] > 0 and a["registers"] > 0 and \
                a["smem_bytes"] > 0, (mod.__name__, which, a)
        a = mod.bwd_attrs(2)
        assert a["ctas_per_sm"] * a["threads"] // 32 >= 8, a
