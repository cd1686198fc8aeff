"""Training the recurrent families in the port (rwkv6-3b, zamba2-2.7b)
against the JAX reference: the chunk scans' backward (kernels/ref.py
``wkv6_chunked_backward`` / ``ssd_chunked_backward``, the plain versions
of csrc/wkv6_bwd.cu and csrc/ssd_bwd.cu, whose two passes
tests/test_torch_scan_bwd.py holds one at a time) and their autograd
functions (kernels/rwkv6_scan.py ``WKV6``, kernels/ssd.py ``SSDScan``),
the losses and gradients of models/lm.py, remat, the single-pod step
through launch/train.py, and serving after a training step.  The reference
differentiates its own jnp chunk scans (``models/rwkv6.py:_wkv_chunked``,
``models/mamba2.py:_ssd_chunked``); the same numpy inputs and the
reference's own params (carried over with models/convert.py) go to both.

A deliberate difference: the reference builds SSD's intra-chunk decay as
``where(mask, exp(diff), 0)``, which overflows above the diagonal once a
chunk's decay sums past about 88, so its gradient of da is NaN there
(0 * inf), at zamba2-2.7b's published chunk of 128 too.  The port masks
in log space before the exp; its gradient stays finite and is held to a
float64 autograd of the token-level recurrence.

Tolerances (fp32, sums in another order than XLA's autodiff): each scan
gradient within 2e-5 of its max |value| (measured on the CPU: 9.4e-6 for
WKV6 with log decays down to -8, 7.8e-7 for SSD); against float64, 2e-5
(measured 3.0e-6); the autograd functions bitwise their plain backward
and within 1e-5 of torch autograd of the plain forwards; losses within 2e-6
relative and each gradient leaf within 1e-4 of its max |value| (the
frontends' bounds, tests/test_torch_frontends.py); remat bitwise; the
trainer's losses as ``TRAIN_RTOL`` says; served tokens exactly, their
logits within 2e-5 of max(1, max |reference|) (tests/test_torch_rwkv6.py's
bound).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JTrainConfig
from repro.configs.registry import get_smoke_config as jsmoke
from repro.configs.shapes import ShapeConfig as JShape
from repro.core import steps as jsteps
from repro.data.pipeline import TokenPipeline as JPipe
from repro.launch import train as jtrain
from repro.launch.mesh import make_host_mesh
from repro.models import lm as jlm
from repro.models import mamba2 as jmamba2
from repro.models import rwkv6 as jrwkv6
from repro.runtime import sharding as shd
from repro_torch.configs.base import TrainConfig as TTrainConfig
from repro_torch.configs.registry import get_smoke_config as tsmoke
from repro_torch.core import steps as tsteps
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_scan as twkv
from repro_torch.kernels import ssd as tssd
from repro_torch.launch import train as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.models import zamba2 as tzamba2
from repro_torch.models.common import unflatten_tree
from repro_torch.models.convert import params_from_numpy, params_to_numpy

torch.set_num_threads(1)

ARCHS = ["rwkv6-3b", "zamba2-2.7b"]
SCAN_RTOL = 2e-5
F64_RTOL = 2e-5
FN_RTOL = 1e-5
LOSS_RTOL = 2e-6
GRAD_RTOL = 1e-4
SERVE_RTOL = 2e-5
#: the trainer's losses, port against reference, relative: step 1 starts
#: from the same params, step 2 follows one AdamW update, which carries
#: the gradients' ulps into every weight.  The reference's own spread at
#: this size (its params0 moved by 1e-7 relative, measured on the CPU):
#: 2.0e-7 of a loss (rwkv6 at step 2, zamba2 at step 1), two ulps of
#: 4.86; the port measured 9.8e-8 against the reference at both steps.
#: 1e-6 is five times that spread and far below a wrong gradient's effect.
TRAIN_RTOL = 1e-6


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _rel(got, want) -> float:
    got, want = _np(got), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _leaves(tree):
    if isinstance(tree, dict):
        return [(k + "/" + p if p else k, x) for k in sorted(tree)
                for p, x in _leaves(tree[k])]
    return [("", tree)]


def _wkv_inputs(B, S, H, N, seed, strong=True):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, N)).astype(np.float32)
               for _ in range(3))
    scale = 2.0 if strong else 0.5
    logw = np.clip(-np.exp(rng.standard_normal((B, S, H, N))) * scale,
                   -8.0, 0.0).astype(np.float32)
    u = rng.standard_normal((H, N)).astype(np.float32)
    s0 = rng.standard_normal((B, H, N, N)).astype(np.float32)
    dy = rng.standard_normal((B, S, H, N)).astype(np.float32)
    ds = rng.standard_normal((B, H, N, N)).astype(np.float32)
    return (r, k, v, logw, u, s0), dy, ds


def _ssd_inputs(B, S, H, P, N, seed, da):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    Bm, Cm = (rng.standard_normal((B, S, N)).astype(np.float32)
              for _ in range(2))
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dh = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return (x, Bm, Cm, da(rng, (B, S, H)).astype(np.float32), h0), dy, dh


def _uniform(scale):
    return lambda rng, shape: -rng.uniform(0.0, scale, shape)


def _t(arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _jax_vjp(fn, inputs, cotangents):
    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in inputs))
    return [np.asarray(g) for g in vjp(tuple(jnp.asarray(c)
                                             for c in cotangents))]


# ---------------------------------------------------------------------------
# (a)-(c): the scans' backward against the reference's autodiff
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [50, 96])
def test_wkv6_backward_matches_jax_grad(S):
    """All six gradients (r, k, v, logw, u, state0) at S = 50 (a ragged
    last chunk) and 96, with log decays down to -8, against jax.vjp of
    the reference's ``_wkv_chunked`` (its chunk, 32) with cotangents on y
    and on the final state."""
    ins, dy, ds = _wkv_inputs(2, S, 3, 16, seed=S)
    want = _jax_vjp(jrwkv6._wkv_chunked, ins, (dy, ds))
    got = tref.wkv6_chunked_backward(*_t(ins), *_t((dy, ds)), chunk=32)
    for name, g, w in zip(("r", "k", "v", "logw", "u", "state0"), got, want):
        assert np.isfinite(w).all(), name
        assert _rel(g, w) <= SCAN_RTOL, (name, _rel(g, w))


@pytest.mark.parametrize("scale", [0.1, 4.0])
def test_ssd_backward_matches_jax_grad_where_finite(scale):
    """All five gradients (x, B, C, da, h0) at a ragged S = 50, chunk 16,
    da from -U(0, scale) (chunk sums well below 88, where the reference's
    gradient is finite), against jax.vjp of ``_ssd_chunked``."""
    ins, dy, dh = _ssd_inputs(2, 50, 3, 8, 6, seed=int(scale * 10),
                              da=_uniform(scale))
    want = _jax_vjp(lambda *a: jmamba2._ssd_chunked(*a, 16), ins, (dy, dh))
    got = tref.ssd_chunked_backward(*_t(ins), *_t((dy, dh)), chunk=16)
    for name, g, w in zip(("x", "B", "C", "da", "h0"), got, want):
        assert np.isfinite(w).all(), name
        assert _rel(g, w) <= SCAN_RTOL, (name, _rel(g, w))


def _ssd_tokens_f64(x, Bm, Cm, da, h0):
    """The SSD recurrence token by token in float64 (no chunk, no exp of
    a positive number): h = e^{da_t} h + x_t B_t, y_t = C_t . h."""
    h, ys = h0, []
    for t in range(x.shape[1]):
        h = torch.exp(da[:, t])[..., None, None] * h + torch.einsum(
            "bhp,bn->bhpn", x[:, t], Bm[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t], h))
    return torch.stack(ys, dim=1), h


def _softplus_dt(rng, shape):
    # zamba2's da = -softplus(dt_raw + dt_bias) exp(A_log) at A_log = 0,
    # dt_bias = 0 (its init), dt_raw ~ N(0, 1)
    return -np.log1p(np.exp(rng.standard_normal(shape)))


@pytest.mark.parametrize("case", [
    dict(S=64, chunk=16, da=_uniform(20.0), seed=1),
    dict(S=256, chunk=128, da=_softplus_dt, seed=2)],
    ids=["chunk16-U20", "published-chunk128-softplus"])
def test_ssd_gradient_is_finite_past_the_reference_overflow(case):
    """The deliberate difference (ROADMAP §C): where a chunk's decay sums
    past about 88 (the second case is zamba2-2.7b's published chunk of
    128 with dt = softplus(N(0, 1)): chunk sums up to 97.5), the reference's
    gradient of da is not finite; the port's is, for every input, and
    agrees with a float64 autograd of the token-level recurrence."""
    ins, dy, dh = _ssd_inputs(1, case["S"], 2, 4, 4, seed=case["seed"],
                              da=case["da"])
    chunk = case["chunk"]
    sums = -ins[3].reshape(1, -1, chunk, 2).sum(2)
    assert sums.max() > 88.0
    want = _jax_vjp(lambda *a: jmamba2._ssd_chunked(*a, chunk), ins,
                    (dy, dh))
    assert not np.isfinite(want[3]).all()           # the reference's dda
    got = tref.ssd_chunked_backward(*_t(ins), *_t((dy, dh)), chunk=chunk)
    f64 = [t.double().requires_grad_(True) for t in _t(ins)]
    y, h = _ssd_tokens_f64(*f64)
    oracle = torch.autograd.grad(
        (y * torch.from_numpy(dy).double()).sum()
        + (h * torch.from_numpy(dh).double()).sum(), f64)
    for name, g, w in zip(("x", "B", "C", "da", "h0"), got, oracle):
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g, w.detach().numpy()) <= F64_RTOL, name
    # the port's forward is the reference's value, bit for bit in the mask
    yt, ht = tref.ssd_chunked(*_t(ins), chunk)
    yj, hj = jmamba2._ssd_chunked(*(jnp.asarray(a) for a in ins), chunk)
    assert _rel(yt, yj) <= SCAN_RTOL and _rel(ht, hj) <= SCAN_RTOL


# ---------------------------------------------------------------------------
# (d): the autograd functions on the CPU
# ---------------------------------------------------------------------------

def test_autograd_functions_match_autograd_of_the_plain_forwards():
    """WKV6.apply and SSDScan.apply on CPU tensors: both outputs against
    the plain forwards, the gradients against torch autograd through
    them and bitwise the plain backward; the state passed in is not
    written."""
    ins, dy, ds = _wkv_inputs(2, 70, 3, 8, seed=5)
    leaves = [t.requires_grad_(True) for t in _t(ins)]
    s_in = leaves[5].detach().clone()
    y, s = twkv.WKV6.apply(*leaves, 32)
    y_ref, s_ref = tref.wkv6_chunked(*leaves, 32)
    assert torch.equal(y, y_ref) and torch.equal(s, s_ref)
    assert torch.equal(leaves[5].detach(), s_in)
    cot = _t((dy, ds))
    got = torch.autograd.grad((y * cot[0]).sum() + (s * cot[1]).sum(), leaves)
    want = torch.autograd.grad((y_ref * cot[0]).sum()
                               + (s_ref * cot[1]).sum(), leaves)
    plain = tref.wkv6_chunked_backward(*_t(ins), *cot, chunk=32)
    for g, w, p in zip(got, want, plain):
        assert torch.equal(g, p)
        assert _rel(g, w.detach().numpy()) <= FN_RTOL

    ins, dy, dh = _ssd_inputs(2, 70, 3, 8, 6, seed=6, da=_uniform(1.0))
    leaves = [t.requires_grad_(True) for t in _t(ins)]
    h_in = leaves[4].detach().clone()
    y, h = tssd.SSDScan.apply(*leaves, 32)
    y_ref, h_ref = tref.ssd_chunked(*leaves, 32)
    assert torch.equal(y, y_ref) and torch.equal(h, h_ref)
    assert torch.equal(leaves[4].detach(), h_in)
    cot = _t((dy, dh))
    got = torch.autograd.grad((y * cot[0]).sum() + (h * cot[1]).sum(), leaves)
    want = torch.autograd.grad((y_ref * cot[0]).sum()
                               + (h_ref * cot[1]).sum(), leaves)
    plain = tref.ssd_chunked_backward(*_t(ins), *cot, chunk=32)
    for g, w, p in zip(got, want, plain):
        assert torch.equal(g, p)
        assert _rel(g, w.detach().numpy()) <= FN_RTOL
    # only y used: the final state's cotangent is None, not a zero tensor
    y, _ = twkv.WKV6.apply(*[t.detach().requires_grad_(True)
                             for t in _t(_wkv_inputs(1, 40, 2, 8, 7)[0])], 32)
    y.sum().backward()


def test_cpu_backward_wrappers_launch_nothing():
    twkv.reset_launch_counts()
    tssd.reset_launch_counts()
    ins, dy, _ = _wkv_inputs(1, 40, 2, 8, seed=8)
    twkv.wkv6_backward(*_t(ins), torch.from_numpy(dy))
    ins, dy, _ = _ssd_inputs(1, 40, 2, 8, 8, seed=8, da=_uniform(1.0))
    tssd.ssd_backward(*_t(ins), torch.from_numpy(dy))
    assert twkv.launch_counts() == {"wkv6": 0, "wkv6_bwd_dstate": 0,
                                    "wkv6_bwd": 0}
    assert tssd.launch_counts() == {"ssd": 0, "ssd_bwd_dstate": 0,
                                    "ssd_bwd": 0}
    w = _t(_wkv_inputs(1, 8, 1, 4, seed=9)[0])
    with pytest.raises(ValueError, match="chunk_states"):
        twkv.wkv6(*w, chunk_states=torch.zeros(1, 1, 1, 4, 4))


# ---------------------------------------------------------------------------
# (e), (f): losses and gradients of the models
# ---------------------------------------------------------------------------

def _bind(arch, seed=0):
    jc, tc = jsmoke(arch), tsmoke(arch)
    jp = jlm.init_params(jc, jax.random.PRNGKey(seed), 1, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jp, tc, tp


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _port_loss_and_grads(cfg, params, toks):
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in _leaves(params)}
    loss, metrics = tlm.loss_fn(cfg, unflatten_tree(leaves),
                                {"tokens": torch.from_numpy(toks)}, 1)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), metrics, dict(zip(leaves, grads))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_reference(arch, remat):
    """lm.loss_fn and the gradient of every parameter leaf against
    jax.value_and_grad of the reference's lm.loss_fn (S = 100: ragged
    scan chunks; zamba2's shared block through the flash path)."""
    jc, jp, tc, tp = _bind(arch)
    jc, tc = jc.replace(remat=remat), tc.replace(remat=remat)
    toks = _tokens(jc, 2, 100, seed=3)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jlm.loss_fn(jc, p, {"tokens": jnp.asarray(toks)}, 1),
        has_aux=True)(jp)
    tl, tm, tg = _port_loss_and_grads(tc, tp, toks)
    assert abs(float(tl) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert abs(float(tm["ce_loss"]) - float(jm["ce_loss"])) <= \
        LOSS_RTOL * abs(float(jl))
    assert float(tm["aux_loss"]) == 0.0
    jgl = dict(_leaves(jg))
    assert sorted(jgl) == sorted(tg)
    for path, g in tg.items():
        want = np.asarray(jgl[path])
        assert np.isfinite(want).all(), path
        err = float(np.abs(_np(g) - want).max())
        assert err <= GRAD_RTOL * max(float(np.abs(want).max()), 1e-8), path


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_recomputes_the_same_gradients(arch):
    """Checkpointed layers recompute their forward in the backward; the
    training forward writes no state, so the recompute reads what the
    first pass read and the gradients are bitwise those without remat."""
    cfg = tsmoke(arch)
    params = tlm.init_params(cfg, 0, device="cpu")
    toks = _tokens(cfg, 2, 64, seed=4)
    runs = [_port_loss_and_grads(cfg.replace(remat=remat), params, toks)
            for remat in (False, True)]
    assert torch.equal(runs[0][0], runs[1][0])
    for path, g in runs[0][2].items():
        assert torch.equal(g, runs[1][2][path]), path


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_gives_the_loss_features(arch):
    """lm.forward_train of the recurrent families: the final normed
    features (no aux loss, no prefix), whose head and loss are
    lm.loss_fn's."""
    cfg = tsmoke(arch)
    params = tlm.init_params(cfg, 1, device="cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 40, seed=5))
    with torch.no_grad():
        x, aux, prefix = tlm.forward_train(cfg, params, {"tokens": toks}, 1)
        loss, _ = tlm.loss_fn(cfg, params, {"tokens": toks}, 1)
    want, _ = tzamba2._chunked_ce(cfg, x, params["lm_head"], toks, 1)
    assert x.shape == (2, 40, cfg.d_model) and prefix == 0
    assert float(aux) == 0.0 and torch.equal(loss, want)


# ---------------------------------------------------------------------------
# (g), (h): the trainer, and serving after a training step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_matches_reference_trainer(arch, tmp_path, monkeypatch):
    """``launch/train.py --smoke --steps 2 --device cpu`` against the
    reference's ``launch/train.py --smoke --steps 2``: the same pipeline
    batches, the port started from the reference's initial state
    (params and AdamW moments), the two losses within TRAIN_RTOL."""
    want = jtrain.main(["--arch", arch, "--smoke", "--steps", "2",
                        "--ckpt-dir", str(tmp_path / "ref"),
                        "--ckpt-every", "100"])
    jc = jsmoke(arch)
    mesh = make_host_mesh()
    with mesh, shd.use_mesh(mesh):
        jf = jsteps.make_single_pod_step(jc, JTrainConfig(total_steps=2),
                                         mesh)
        state0 = jax.tree.map(np.asarray, jax.jit(jf.init_state)(
            jax.random.PRNGKey(0)))
    real = tsteps.make_single_pod_step

    def from_reference(*args, **kwargs):
        fns = real(*args, **kwargs)
        return dataclasses.replace(fns, init_state=lambda seed: (
            params_from_numpy(state0, device="cpu")))
    monkeypatch.setattr(tlaunch.steps_mod, "make_single_pod_step",
                        from_reference)
    res = tlaunch.run(tlaunch.parser().parse_args(
        ["--arch", arch, "--smoke", "--steps", "2", "--ckpt-dir",
         str(tmp_path / "port"), "--ckpt-every", "0", "--device", "cpu"]))
    assert res.end_step == 2 and res.runner_stats["failures"] == 0
    assert len(want) == len(res.losses) == 2
    for got, w in zip(res.losses, want):
        assert abs(got - w) <= TRAIN_RTOL * abs(w), (res.losses, want)
    for row in res.metrics:
        assert np.isfinite(row["grad_norm"]) and row["aux_loss"] == 0.0


def _greedy(lm_mod, cfg, params, prompt, steps, jax_side):
    """Prefill, then ``steps`` greedy decode steps: (tokens, logits)."""
    B, S = prompt.shape
    if jax_side:
        cache = lm_mod.init_cache(cfg, B, S + steps, 1, jnp.float32)
        logits, cache = lm_mod.serve_prefill(
            cfg, params, {"tokens": jnp.asarray(prompt)}, 1, cache)
    else:
        cache = lm_mod.init_cache(cfg, B, S + steps, 1, torch.float32,
                                  device="cpu")
        with torch.no_grad():
            logits, cache = lm_mod.serve_prefill(
                cfg, params, {"tokens": torch.from_numpy(prompt)}, 1, cache)
    toks, all_logits = [], []
    for j in range(steps):
        all_logits.append(_np(logits))
        tok = np.argmax(_np(logits), axis=-1).astype(np.int32)
        toks.append(tok)
        if jax_side:
            logits, cache = lm_mod.serve_step(
                cfg, params, jnp.asarray(tok), jnp.asarray(S + j, jnp.int32),
                1, cache)
        else:
            with torch.no_grad():
                logits, cache = lm_mod.serve_step(
                    cfg, params, torch.from_numpy(tok), S + j, 1, cache)
    return np.stack(toks, 1), all_logits


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_after_a_training_step_matches_reference(arch):
    """One single-pod train step in the port (the params updated in place
    by AdamW), then greedy serving of the trained params in both
    packages: the same tokens, logits within SERVE_RTOL.  Training leaves
    no state behind that serving would read."""
    cfg = tsmoke(arch).replace(microbatch=2)
    fns = tsteps.make_single_pod_step(cfg, TTrainConfig(lr=1e-2,
                                                        total_steps=4),
                                      device="cpu")
    state = fns.init_state(3)
    before = [t.clone() for _, t in _leaves(state["params"])]
    batch = JPipe(jsmoke(arch), JShape("s", 64, 4, "train"), seed=1).batch(0)
    state, metrics = fns.train_step(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    moved = [not torch.equal(a, b) for a, (_, b) in
             zip(before, _leaves(state["params"]))]
    assert all(moved)
    trained = params_to_numpy(state["params"])
    prompt = _tokens(cfg, 2, 20, seed=6)
    got, got_logits = _greedy(tlm, cfg, state["params"], prompt, 6, False)
    want, want_logits = _greedy(jlm, jsmoke(arch), jax.tree.map(
        jnp.asarray, trained), prompt, 6, True)
    np.testing.assert_array_equal(got, want)
    for g, w in zip(got_logits, want_logits):
        err = float(np.abs(g - w).max())
        assert err <= SERVE_RTOL * max(1.0, float(np.abs(w).max()))


# ---------------------------------------------------------------------------
# the CUDA kernels (skip without a card)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(1, 20), (2, 20), (2, 100), (2, 256)])
def test_cuda_wkv6_backward_matches_plain_version(B, S):
    """B3's backward against ``ref.wkv6_chunked_backward`` on the card
    (chip_smoke.py phase 24 adds the training shape and strong decays),
    through WKV6.apply: one forward launch writing the chunk states and
    one launch of each backward pass; S = 20 is one ragged chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    ins, dy, ds = _wkv_inputs(B, S, 3, 64, seed=S, strong=False)
    leaves = [t.cuda().requires_grad_(True) for t in _t(ins)]
    twkv.reset_launch_counts()
    y, s = twkv.WKV6.apply(*leaves, 32)
    cot = [t.cuda() for t in _t((dy, ds))]
    got = torch.autograd.grad((y * cot[0]).sum() + (s * cot[1]).sum(), leaves)
    torch.cuda.synchronize()
    assert twkv.launch_counts() == {"wkv6": 1, "wkv6_bwd_dstate": 1,
                                    "wkv6_bwd": 1}
    want = tref.wkv6_chunked_backward(*[t.detach() for t in leaves], *cot,
                                      chunk=32)
    for g, w in zip(got, want):
        assert _rel(g.cpu(), w.cpu().numpy()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(1, 20), (2, 20), (2, 100), (2, 256)])
def test_cuda_ssd_backward_matches_plain_version(B, S):
    """B4's backward against ``ref.ssd_chunked_backward`` on the card,
    through SSDScan.apply; S = 20 is one ragged chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    ins, dy, dh = _ssd_inputs(B, S, 4, 64, 64, seed=S, da=_uniform(1.0))
    leaves = [t.cuda().requires_grad_(True) for t in _t(ins)]
    tssd.reset_launch_counts()
    y, h = tssd.SSDScan.apply(*leaves, 32)
    cot = [t.cuda() for t in _t((dy, dh))]
    got = torch.autograd.grad((y * cot[0]).sum() + (h * cot[1]).sum(), leaves)
    torch.cuda.synchronize()
    assert tssd.launch_counts() == {"ssd": 1, "ssd_bwd_dstate": 1,
                                    "ssd_bwd": 1}
    want = tref.ssd_chunked_backward(*[t.detach() for t in leaves], *cot,
                                     chunk=32)
    for g, w in zip(got, want):
        assert _rel(g.cpu(), w.cpu().numpy()) <= 1e-4
