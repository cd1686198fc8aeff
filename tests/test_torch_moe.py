"""The port's MoE FFN (models/moe.py) against the JAX reference
(``repro.models.moe``) on the smoke configs of both moe archs
(granite-moe: 8 experts top-2; deepseek-moe: 8 experts top-2 plus a shared
expert), from the same numpy inputs and weights.

Routing is held bitwise: the dispatch mask (which token lands in which
expert's which capacity slot) on the grouped branch (S = 256: 256-token
groups with capacity 80) and the dropless one (one group of all B*S
tokens), with forced top-k ties (a zero router: every probability equal;
duplicated router columns) and with ``route_dtype="bfloat16"``.  The
combine weights are the router's probabilities, so they and the aux loss
are held to fp32 tolerances: combine within 1e-6 absolute (measured on
the CPU: 3.0e-8), aux within 1e-6 relative (measured: equal), outputs
within 2e-5 of max(1, max |reference|) (measured 1.2e-7), and each
gradient leaf within 1e-4 of its max |value| against ``jax.grad``
(measured 7.0e-7).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jsmoke
from repro.models import moe as jmoe
from repro_torch.configs.registry import get_smoke_config as tsmoke
from repro_torch.models import moe as tmoe

torch.set_num_threads(1)

ARCHS = ["granite-moe-3b-a800m", "deepseek-moe-16b"]
COMBINE_ATOL = 1e-6
AUX_RTOL = 1e-6
OUT_RTOL = 2e-5
GRAD_RTOL = 1e-4


def _cfgs(arch, **moe_over):
    jc, tc = jsmoke(arch), tsmoke(arch)
    if moe_over:
        jc = jc.replace(moe=dataclasses.replace(jc.moe, **moe_over))
        tc = tc.replace(moe=dataclasses.replace(tc.moe, **moe_over))
    return jc, tc


def _weights(cfg, seed=0):
    """The MoE params of one layer, drawn with numpy at the reference's
    init scales (a 0.02 router, 1/sqrt(fan_in) experts)."""
    rng = np.random.default_rng(seed)
    specs = tmoe.moe_specs(cfg, 1)
    out = {}
    for k, s in specs.items():
        std = 0.02 if s.init == "small" else s.shape[-2] ** -0.5
        out[k] = (rng.standard_normal(s.shape) * std).astype(np.float32)
    return out


def _x(cfg, shape, seed=1):
    return np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)


def _route_both(jc, tc, router, xg, dropless):
    jcmb, jdis, jaux = jmoe._route(jc, jnp.asarray(router), jnp.asarray(xg),
                                   dropless)
    with torch.no_grad():
        tcmb, tdis, taux = tmoe._route(tc, torch.from_numpy(router),
                                       torch.from_numpy(xg), dropless)
    return (np.asarray(jcmb, np.float32), np.asarray(jdis), float(jaux),
            tcmb.float().numpy(), tdis.numpy(), float(taux))


def _check_route(jc, tc, router, xg, dropless):
    jcmb, jdis, jaux, tcmb, tdis, taux = _route_both(jc, tc, router, xg,
                                                     dropless)
    assert tdis.shape == jdis.shape
    assert np.array_equal(tdis, jdis), "routing differs"
    assert float(np.abs(tcmb - jcmb).max()) <= COMBINE_ATOL
    assert abs(taux - jaux) <= AUX_RTOL * abs(jaux)
    return jdis


# (B, S) -> the grouped branch (S = 256) or the dropless one
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("B,S", [(2, 256), (3, 40), (8, 1)])
def test_route_matches_reference(arch, B, S):
    jc, tc = _cfgs(arch)
    w = _weights(tc)
    x = _x(tc, (B, S))
    xg, dropless = tmoe.group_tokens(torch.from_numpy(x))
    assert dropless == (S % tmoe.GROUP != 0)
    dis = _check_route(jc, tc, w["router"], xg.numpy(), dropless)
    G = xg.shape[-2]
    cap = tmoe.capacity(tc, G, dropless)
    assert dis.shape[-1] == cap == (G if dropless else 80)
    # every token routed to at most top_k slots; a dropless group drops
    # nothing, and no slot holds two tokens
    per_tok = dis.sum(axis=(-2, -1))
    assert per_tok.max() <= tc.moe.top_k
    if dropless:
        assert (per_tok == tc.moe.top_k).all()
    assert dis.sum(axis=-3).max() <= 1


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_tokens_like_the_reference(arch):
    """A router that sends every token to the same experts overflows their
    capacity in the grouped branch: the same tokens are dropped."""
    jc, tc = _cfgs(arch)
    w = _weights(tc)
    router = np.zeros_like(w["router"])
    router[:, 0] = 1.0
    router[:, 1] = 0.5
    x = np.abs(_x(tc, (1, 256))) + 0.1
    xg = x.reshape(1, 1, 256, tc.d_model)
    dis = _check_route(jc, tc, router, xg, False)
    kept = dis.sum(axis=(-2, -1))[0, 0]
    assert (kept < tc.moe.top_k).any(), "nothing was dropped"


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tie", ["zero_router", "duplicate_columns"])
@pytest.mark.parametrize("dropless", [False, True])
def test_route_ties_pick_the_lower_expert_first(arch, tie, dropless):
    jc, tc = _cfgs(arch)
    w = _weights(tc)
    router = w["router"].copy()
    if tie == "zero_router":
        router[:] = 0.0                     # every probability 1/E
    else:
        router[:, 5] = router[:, 2]         # experts 2 and 5 always tie
        router[:, 7] = router[:, 2]
        router[:, 2] += 0.05                # and often win
    shape = (1, 1, 256) if not dropless else (1, 1, 24)
    xg = _x(tc, shape, seed=3)
    dis = _check_route(jc, tc, router, xg, dropless)
    if tie == "zero_router":
        chosen = dis.any(axis=-1)[0, 0]                     # (G, E)
        assert chosen[:, :tc.moe.top_k].all() if dropless else \
            chosen[:, :tc.moe.top_k].any(axis=0).all()
        assert not chosen[:, tc.moe.top_k:].any()
    # torch.topk gives no order for ties; the port's stable sort must
    vals, idx = tmoe._top_k(torch.full((4, 8), 0.125), 3)
    assert idx.tolist() == [[0, 1, 2]] * 4


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("B,S", [(2, 256), (3, 40)])
def test_route_in_bfloat16(arch, B, S):
    jc, tc = _cfgs(arch, route_dtype="bfloat16")
    w = _weights(tc)
    xg, dropless = tmoe.group_tokens(torch.from_numpy(_x(tc, (B, S))))
    jcmb, jdis, jaux, tcmb, tdis, taux = _route_both(
        jc, tc, w["router"], xg.numpy(), dropless)
    assert np.array_equal(tdis, jdis)
    # combine holds the gates rounded to bf16 once
    assert float(np.abs(tcmb - jcmb).max()) <= 2.0 ** -8 * float(
        np.abs(jcmb).max())
    assert abs(taux - jaux) <= AUX_RTOL * abs(jaux)


def _ffn_loss_jax(jc, p, x, probe):
    y, aux = jmoe.moe_ffn(jc, p, x, 1)
    return jnp.sum(y * probe) + aux, (y, aux)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("B,S", [(2, 256), (2, 24)])
def test_moe_ffn_outputs_and_gradients_match_reference(arch, B, S):
    jc, tc = _cfgs(arch)
    w = _weights(tc, seed=4)
    x = _x(tc, (B, S), seed=5)
    probe = np.random.default_rng(6).standard_normal(x.shape).astype(
        np.float32)
    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(
        _ffn_loss_jax, argnums=(1, 2), has_aux=True)(
        jc, {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x),
        jnp.asarray(probe))
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in w.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, taux = tmoe.moe_ffn(tc, tp, tx, 1)
    loss = (ty * torch.from_numpy(probe)).sum() + taux
    grads = torch.autograd.grad(loss, [tx] + [tp[k] for k in sorted(tp)])
    want_y = np.asarray(jy)
    err = float(np.abs(ty.detach().numpy() - want_y).max())
    assert err <= OUT_RTOL * max(1.0, float(np.abs(want_y).max())), err
    assert abs(float(taux.detach()) - float(jaux)) <= \
        AUX_RTOL * abs(float(jaux))
    wants = [np.asarray(jgx)] + [np.asarray(jgp[k]) for k in sorted(tp)]
    for name, g, want in zip(["x"] + sorted(tp), grads, wants):
        err = float(np.abs(g.numpy() - want).max())
        assert err <= GRAD_RTOL * max(float(np.abs(want).max()), 1e-8), name
    assert float(np.abs(wants[sorted(tp).index("router") + 1]).max()) > 0


def test_specs_match_reference_shapes():
    for arch in ARCHS:
        jc, tc = _cfgs(arch)
        js = jmoe.moe_specs(jc, 1, prefix_layers=(3,))
        ts = tmoe.moe_specs(tc, 1, prefix_layers=(3,))
        assert sorted(js) == sorted(ts)
        for k in js:
            assert js[k].shape == ts[k].shape and js[k].init == ts[k].init
            assert js[k].axes == ts[k].axes
        assert not tmoe.use_ep(tc, 1) and tmoe.use_ep(tc, 4) == \
            jmoe.use_ep(jc, 4)


def test_capacity_of_the_published_configs():
    """Capacity at G = 256 in Python floats, as the reference computes
    it: granite 1.25 * 8 * 256 / 40 = 64, deepseek 1.25 * 6 * 256 / 64 =
    30."""
    from repro_torch.configs.registry import get_config
    assert tmoe.capacity(get_config("granite-moe-3b-a800m"), 256) == 64
    assert tmoe.capacity(get_config("deepseek-moe-16b"), 256) == 30
    assert tmoe.capacity(get_config("deepseek-moe-16b"), 8, True) == 8
