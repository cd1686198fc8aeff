"""The port's optimizers (repro_torch/optim) against the JAX reference on
random nested trees, over several steps, from the same numpy params and
gradients.

Tolerance: 1e-6 relative per leaf after 5 steps (fp32; the bias
corrections' ``pow``, sqrt and the global norm's sums may round one ulp
apart from XLA's, and the update divides by sqrt(v), which magnifies an
ulp in v early on).  AdamW's step updates its params and moments in place.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro_torch import optim as toptim
from repro_torch.models.convert import params_from_numpy

torch.set_num_threads(1)
RTOL = 1e-6
STEPS = 5


def _tree(rng, scale=1.0):
    return {"embed": (scale * rng.standard_normal((7, 5))).astype(np.float32),
            "layers": {"w": (scale * rng.standard_normal((2, 5, 3))
                             ).astype(np.float32),
                       "b": (scale * rng.standard_normal((2, 3))
                             ).astype(np.float32)},
            "norm": (scale * rng.standard_normal((5,))).astype(np.float32)}


def _grads(seed, scale):
    rng = np.random.default_rng(seed)
    return [_tree(rng, scale) for _ in range(STEPS)]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [np.asarray(tree.detach().numpy() if isinstance(tree, torch.Tensor)
                       else tree, np.float32)]


def _close(got, want):
    for a, b in zip(_leaves(got), _leaves(want)):
        err = float(np.abs(a - b).max())
        assert err <= RTOL * max(float(np.abs(b).max()), 1e-30), err


def _run(jopt, topt, gscale, lr_scales=(1.0,) * STEPS):
    p0 = _tree(np.random.default_rng(0))
    gs = _grads(1, gscale)
    jp, js = jax.tree.map(jnp.asarray, p0), None
    tp = params_from_numpy(p0, device="cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for g, ls in zip(gs, lr_scales):
        jp, js = jopt.step(jp, jax.tree.map(jnp.asarray, g), js,
                           jnp.float32(ls))
        tp, ts = topt.step(tp, params_from_numpy(g, device="cpu"), ts,
                           torch.tensor(ls, dtype=torch.float32))
    return jp, js, tp, ts


@pytest.mark.parametrize("clip,gscale", [(None, 1.0), (1.0, 1.0),
                                         (100.0, 1.0), (0.5, 10.0)])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_adamw_matches_reference(clip, gscale, wd):
    jopt = joptim.adamw(3e-3, 0.9, 0.95, 1e-8, wd, grad_clip=clip)
    topt = toptim.adamw(3e-3, 0.9, 0.95, 1e-8, wd, grad_clip=clip)
    jp, js, tp, ts = _run(jopt, topt, gscale,
                          lr_scales=(0.1, 0.5, 1.0, 0.7, 0.3))
    _close(tp, jp)
    _close(ts["m"], js["m"])
    _close(ts["v"], js["v"])
    assert int(ts["count"]) == int(js["count"]) == STEPS
    assert ts["count"].dtype == torch.int32
    assert all(x.dtype == torch.float32 for x in _leaves_t(ts["m"]))


def _leaves_t(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_t(tree[k])]
    return [tree]


def test_adam_matches_reference():
    jp, _, tp, _ = _run(joptim.adam(1e-2), toptim.adam(1e-2), 1.0)
    _close(tp, jp)


@pytest.mark.parametrize("momentum,nesterov", [(0.0, False), (0.9, False),
                                               (0.9, True)])
def test_sgd_matches_reference(momentum, nesterov):
    jp, js, tp, ts = _run(joptim.sgd(0.05, momentum, nesterov),
                          toptim.sgd(0.05, momentum, nesterov), 1.0)
    _close(tp, jp)
    assert int(ts["count"]) == int(js["count"])
    if momentum:
        _close(ts["mu"], js["mu"])


@pytest.mark.parametrize("clip", [None, 0.5])
def test_adamw_updates_params_and_moments_in_place(clip):
    """adamw's step writes the new params and moments into the tensors it
    was given and returns those tensors."""
    opt = toptim.adamw(3e-3, 0.9, 0.95, 1e-8, 0.1, grad_clip=clip)
    params = params_from_numpy(_tree(np.random.default_rng(0)),
                               device="cpu")
    leaves = _leaves_t(params)
    before = [x.clone() for x in leaves]
    state = opt.init(params)
    moments = _leaves_t(state["m"]) + _leaves_t(state["v"])
    g = params_from_numpy(_grads(2, 3.0)[0], device="cpu")
    new_p, new_s = opt.step(params, g, state, 0.5)
    assert all(a is b for a, b in zip(_leaves_t(new_p), leaves))
    assert all(a is b for a, b in
               zip(_leaves_t(new_s["m"]) + _leaves_t(new_s["v"]), moments))
    assert all(not torch.equal(a, b) for a, b in zip(leaves, before))
    assert int(new_s["count"]) == 1


def test_global_norm_matches_reference():
    t = _tree(np.random.default_rng(4), 3.0)
    want = float(joptim.global_norm(jax.tree.map(jnp.asarray, t)))
    got = float(toptim.global_norm(params_from_numpy(t, device="cpu")))
    assert abs(got - want) <= 1e-6 * want


@pytest.mark.parametrize("warmup,total", [(0, 10), (3, 10), (10, 10),
                                          (2, 1000)])
def test_cosine_schedule_matches_reference(warmup, total):
    js = joptim.cosine_schedule(3e-4, warmup, total)
    ts = toptim.cosine_schedule(3e-4, warmup, total)
    for step in range(0, total + 3):
        want = float(js(jnp.int32(step)))
        got = float(ts(torch.tensor(step, dtype=torch.int32)))
        assert abs(got - want) <= 1e-6 * max(abs(want), 1e-12), step
    assert float(ts(0)) > 0
