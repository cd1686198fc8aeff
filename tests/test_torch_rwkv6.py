"""The port's ssm family (models/rwkv6.py and the ssm branch of
models/lm.py) against the JAX reference, from the reference's own params
(``lm.init_params(PRNGKey)``, carried over with convert.params_from_numpy)
and the same numpy token batches, on the CPU (where the chunk scan takes
its plain chunked version at the reference's chunk, 32).

Tolerance: fp32 products summed in another order than XLA's agree to a
few ulps per layer; logits and every state leaf are held to 2e-5 of
max(1, max |reference|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.configs.registry import get_smoke_config as jsmoke
from repro.models import lm as jlm
from repro.models import rwkv6 as jrwkv6
from repro_torch.configs.registry import get_config as tget
from repro_torch.configs.registry import get_smoke_config as tsmoke
from repro_torch.models import lm as tlm
from repro_torch.models import rwkv6 as trwkv6
from repro_torch.models.common import iter_specs
from repro_torch.models.convert import params_from_numpy, params_to_numpy

torch.set_num_threads(1)

ARCH = "rwkv6-3b"
RTOL = 2e-5


def _close(got, want, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    bound = RTOL * max(1.0, float(np.abs(want).max()))
    assert err <= bound, f"{what}: max abs err {err} > {bound}"


def _bind(seed=0):
    jc, tc = jsmoke(ARCH), tsmoke(ARCH)
    jp = jlm.init_params(jc, jax.random.PRNGKey(seed), 1, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jp, tc, tp


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def _close_state(tstate, jstate, what):
    assert isinstance(tstate, trwkv6.RWKVState)
    for name, t, j in zip(tstate._fields, tstate, jstate):
        assert t.dtype == torch.float32, name
        _close(t, j, f"{what} {name}")


@pytest.mark.parametrize("S", [64, 70])
def test_serve_prefill_and_step_match_reference(S):
    """Prefill (S = 70 leaves a ragged last chunk) then six decode steps:
    logits and the whole state after each."""
    jc, jp, tc, tp = _bind()
    toks = _tokens(jc, (2, S), seed=1)
    jst = jlm.init_cache(jc, 2, 96, 1, jnp.float32)
    tst = tlm.init_cache(tc, 2, 96, 1, torch.float32, device="cpu")
    jl, jst = jlm.serve_prefill(jc, jp, {"tokens": jnp.asarray(toks)}, 1, jst)
    with torch.no_grad():
        tl, out = tlm.serve_prefill(tc, tp, {"tokens": torch.from_numpy(toks)},
                                    1, tst)
    assert out is tst                      # the state is written in place
    _close(tl, jl, "prefill logits")
    _close_state(tst, jst, "prefill")
    for j in range(6):
        step = _tokens(jc, (2,), seed=10 + j)
        jl, jst = jlm.serve_step(jc, jp, jnp.asarray(step),
                                 jnp.asarray(S + j, jnp.int32), 1, jst)
        with torch.no_grad():
            tl, _ = tlm.serve_step(tc, tp, torch.from_numpy(step), S + j, 1,
                                   tst)
        _close(tl, jl, f"step {j} logits")
    _close_state(tst, jst, "after decode")


def test_rwkv_state_carries_context():
    """The port of tests/test_model_invariants.py::
    test_rwkv_state_carries_context: two prefills with the state carried
    == one prefill of the whole sequence (the reference's 2e-3), and the
    port's split run equals the reference's split run (2e-5)."""
    jc, jp, tc, tp = _bind()
    toks = _tokens(jc, (1, 64), seed=7)
    with torch.no_grad():
        full, _ = tlm.serve_prefill(
            tc, tp, {"tokens": torch.from_numpy(toks)}, 1,
            tlm.init_cache(tc, 1, 64, 1, torch.float32, device="cpu"))
        st = tlm.init_cache(tc, 1, 64, 1, torch.float32, device="cpu")
        tlm.serve_prefill(tc, tp, {"tokens": torch.from_numpy(toks[:, :32])},
                          1, st)
        part, _ = tlm.serve_prefill(
            tc, tp, {"tokens": torch.from_numpy(toks[:, 32:])}, 1, st)
    np.testing.assert_allclose(full.numpy(), part.numpy(), atol=2e-3)
    js = jlm.init_cache(jc, 1, 64, 1, dtype=jnp.float32)
    _, js = jlm.serve_prefill(jc, jp, {"tokens": jnp.asarray(toks[:, :32])},
                              1, js)
    jpart, _ = jlm.serve_prefill(jc, jp, {"tokens": jnp.asarray(toks[:, 32:])},
                                 1, js)
    _close(part, jpart, "split prefill logits")


def test_wkv_step_and_group_norm_match_reference():
    from repro.models import rwkv6 as jrwkv6
    rng = np.random.default_rng(2)
    B, H, N = 2, 3, 16
    r, k, v = (rng.standard_normal((B, H, N)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((B, H, N))).astype(np.float32)
    u = rng.standard_normal((H, N)).astype(np.float32)
    s0 = rng.standard_normal((B, H, N, N)).astype(np.float32)
    jy, js = jrwkv6._wkv_step(*(jnp.asarray(a)
                                for a in (r, k, v, logw, u, s0)))
    state = torch.from_numpy(s0.copy())
    ty, out = trwkv6._wkv_step(*(torch.from_numpy(a)
                                 for a in (r, k, v, logw, u)), state)
    assert out is state
    _close(ty, jy, "step y")
    _close(state, js, "step state")
    g = rng.standard_normal((H, N)).astype(np.float32)
    y = rng.standard_normal((B, 5, H, N)).astype(np.float32)
    _close(trwkv6._group_norm(torch.from_numpy(y), torch.from_numpy(g)),
           jrwkv6._group_norm(jnp.asarray(y), jnp.asarray(g)), "group_norm")


def test_last_pos_is_refused_word_for_word():
    jc, jp, tc, tp = _bind()
    toks = _tokens(jc, (2, 8))
    with pytest.raises(ValueError) as j:
        jlm.serve_prefill(jc, jp, {"tokens": jnp.asarray(toks)}, 1,
                          jlm.init_cache(jc, 2, 8, 1, jnp.float32),
                          last_pos=jnp.asarray([3, 7], jnp.int32))
    with pytest.raises(ValueError) as t:
        tlm.serve_prefill(tc, tp, {"tokens": torch.from_numpy(toks)}, 1,
                          tlm.init_cache(tc, 2, 8, 1, device="cpu"),
                          last_pos=torch.tensor([3, 7], dtype=torch.int32))
    assert str(t.value) == str(j.value)


def test_init_params_and_state_shapes():
    jc, tc = jsmoke(ARCH), tsmoke(ARCH)
    jshapes = jax.tree.map(
        lambda a: tuple(a.shape),
        jax.eval_shape(lambda: jlm.init_params(jc, jax.random.PRNGKey(0), 1)))
    p = tlm.init_params(tc, seed=0, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), params_to_numpy(p)) == \
        jshapes
    jst = jlm.init_cache(jc, 3, 16, 1, jnp.bfloat16)
    tst = tlm.init_cache(tc, 3, 16, 1, torch.bfloat16, device="cpu")
    for t, j in zip(tst, jst):      # f32 whatever the cache dtype
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
        assert j.dtype == jnp.float32 and not bool(t.any())
    assert tlm.cache_axes_tree(tc, 1) == jlm.cache_axes_tree(jc, 1)


def test_full_config_widths_and_count():
    cfg = tget(ARCH)
    assert (cfg.n_layers, cfg.d_model, cfg.d_model // cfg.rwkv.head_size,
            cfg.rwkv.head_size, cfg.d_ff, cfg.vocab_size) == \
        (32, 2560, 40, 64, 8960, 65536)
    n = sum(int(np.prod(s.shape))
            for _, s in iter_specs(tlm.param_specs(cfg, 1)))
    jshapes = jax.eval_shape(lambda: jlm.init_params(
        jget(ARCH), jax.random.PRNGKey(0), 1))
    assert n == sum(a.size for a in jax.tree.leaves(jshapes))
    assert n == 3_099_609_600          # about 3.1 B, 12.4 GB in fp32


def test_forward_train_raises_naming_the_roadmap():
    """It raised naming ROADMAP A17 until rwkv6 training was ported (the
    name is kept): the training forward's features (from the zero state,
    no state written), at a ragged S, are bitwise the serving forward's
    from a zero state (held above through the logits) and within 5e-5 of
    max(1, max |reference|) of the reference's ``_rwkv_forward`` from
    ``init_state`` (measured 2.6e-5: the final norm scales the features
    to about 4, and the per-head group norm over 16 channels amplifies
    the ulps the logits' small head hides)."""
    jc, jp, tc, tp = _bind()
    toks = _tokens(jc, (2, 70), seed=3)
    jx, _ = jlm._rwkv_forward(jc, jp, jnp.asarray(toks), jrwkv6.init_state(
        jc, 2, 1, stacked=jc.n_layers), 1, False)
    with torch.no_grad():
        tx, aux, prefix = tlm.forward_train(
            tc, tp, {"tokens": torch.from_numpy(toks)}, 1)
        sx = tlm._rwkv_forward(tc, tp, torch.from_numpy(toks), tlm.init_cache(
            tc, 2, 70, 1, torch.float32, device="cpu"), 1, False)
    assert prefix == 0 and float(aux) == 0.0
    assert torch.equal(tx, sx)
    jx = np.asarray(jx)
    err = float(np.abs(tx.numpy() - jx).max())
    assert err <= 5e-5 * max(1.0, float(np.abs(jx).max())), err
