"""The port's hybrid family (models/mamba2.py, models/zamba2.py and the
hybrid branch of models/lm.py) against the JAX reference, from the
reference's own params (carried over with convert.params_from_numpy) and
the same numpy token batches, on the CPU (the SSD scan takes its plain
chunked version at the config's chunk; the shared attention block the
blocked torch path of the flash backend).

Tolerance: fp32 products summed in another order than XLA's agree to a
few ulps per layer; logits, Mamba states and KV rows are held to 2e-5 of
max(1, max |reference|), KV positions exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.configs.registry import get_smoke_config as jsmoke
from repro.models import lm as jlm
from repro.models import common as jcommon
from repro.models import mamba2 as jmamba2
from repro.models import zamba2 as jzamba2
from repro_torch.configs.registry import get_config as tget
from repro_torch.configs.registry import get_smoke_config as tsmoke
from repro_torch.models import lm as tlm
from repro_torch.models import mamba2 as tmamba2
from repro_torch.models import zamba2 as tzamba2
from repro_torch.models.common import iter_specs
from repro_torch.models.convert import params_from_numpy, params_to_numpy

torch.set_num_threads(1)

ARCH = "zamba2-2.7b"
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


def _close_cache(tcache, jcache, what):
    assert isinstance(tcache, tzamba2.ZambaCache)
    for part in ("mamba", "kv"):
        tp_, jp_ = getattr(tcache, part), getattr(jcache, part)
        for name, t, j in zip(tp_._fields, tp_, jp_):
            if name == "positions":
                np.testing.assert_array_equal(t.numpy(), np.asarray(j))
            else:
                _close(t, j, f"{what} {part}.{name}")


@pytest.mark.parametrize("S", [40, 70])
def test_prefill_then_decode_matches_reference(S):
    """A prefill (S = 70: two full SSD chunks and a ragged one; 40 is
    shorter than attn_chunk) then six decode steps at per-slot positions:
    logits after each, then every leaf of the nested cache."""
    jc, jp, tc, tp = _bind()
    B, T = 2, 96
    toks = _tokens(jc, (B, S), seed=1)
    jcache = jlm.init_cache(jc, B, T, 1, jnp.float32)
    tcache = tlm.init_cache(tc, B, T, 1, torch.float32, device="cpu")
    jl, jcache = jlm.serve_prefill(jc, jp, {"tokens": jnp.asarray(toks)}, 1,
                                   jcache)
    with torch.no_grad():
        tl, out = tlm.serve_prefill(tc, tp, {"tokens": torch.from_numpy(toks)},
                                    1, tcache)
    assert out is tcache                  # written in place
    _close(tl, jl, "prefill logits")
    _close_cache(tcache, jcache, "prefill")
    pos = np.full(B, S, np.int32)
    for j in range(6):
        step = _tokens(jc, (B,), seed=10 + j)
        jl, jcache = jlm.serve_step(jc, jp, jnp.asarray(step),
                                    jnp.asarray(pos), 1, jcache)
        with torch.no_grad():
            tl, _ = tlm.serve_step(tc, tp, torch.from_numpy(step),
                                   torch.from_numpy(pos), 1, tcache)
        _close(tl, jl, f"decode step {j} logits")
        pos = pos + 1
    _close_cache(tcache, jcache, "after decode")


def test_mamba2_block_both_branches_match_reference():
    """One mamba2 layer: a chunked prompt from a nonzero state, then a
    single token; output and state after each."""
    jc, jp, tc, tp = _bind()
    rng = np.random.default_rng(3)
    jlp = jax.tree.map(lambda a: a[0], jp["backbone"])
    tlp = {k: v[0] for k, v in tp["backbone"].items()}
    st0 = jmamba2.init_state(jc, 2)
    conv = rng.standard_normal(st0.conv.shape).astype(np.float32)
    h = rng.standard_normal(st0.h.shape).astype(np.float32)
    jst = jmamba2.MambaState(conv=jnp.asarray(conv), h=jnp.asarray(h))
    tst = tmamba2.MambaState(conv=torch.from_numpy(conv.copy()),
                             h=torch.from_numpy(h.copy()))
    for S, single in ((37, False), (1, True)):
        x = rng.standard_normal((2, S, jc.d_model)).astype(np.float32)
        jy, jst = jmamba2.block(jc, jlp, jnp.asarray(x), jst, 1, single)
        with torch.no_grad():
            ty, out = tmamba2.block(tc, tlp, torch.from_numpy(x), tst, 1,
                                    single)
        assert out is tst
        _close(ty, jy, f"block y (S={S})")
        _close(tst.conv, jst.conv, f"conv state (S={S})")
        _close(tst.h, jst.h, f"ssd state (S={S})")


def test_prompt_shorter_than_the_conv_window_is_refused():
    _, _, tc, tp = _bind()
    cache = tlm.init_cache(tc, 1, 8, 1, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="d_conv - 1"):
        tlm.serve_prefill(tc, tp, {"tokens": torch.zeros(1, 2,
                                                         dtype=torch.int32)},
                          1, cache)


def test_init_params_cache_and_axes_match_reference():
    jc, tc = jsmoke(ARCH), tsmoke(ARCH)
    jshapes = jax.tree.map(
        lambda a: tuple(a.shape),
        jax.eval_shape(lambda: jlm.init_params(jc, jax.random.PRNGKey(0), 1)))
    p = tlm.init_params(tc, seed=0, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), params_to_numpy(p)) == \
        jshapes
    jcache = jlm.init_cache(jc, 3, 24, 1, jnp.bfloat16)
    tcache = tlm.init_cache(tc, 3, 24, 1, torch.bfloat16, device="cpu")
    jl = jax.tree.leaves(jcache)
    tl = [t for part in tcache for t in part]
    assert [tuple(t.shape) for t in tl] == [a.shape for a in jl]
    assert [str(t.dtype).split(".")[-1] for t in tl] == \
        [str(a.dtype) for a in jl]
    assert tlm.cache_axes_tree(tc, 1) == jlm.cache_axes_tree(jc, 1)
    assert tzamba2.n_attn_apps(tc) == 2


def test_convert_roundtrips_the_shared_block():
    """shared.attn and shared.ffn are nested two deep; the converter
    carries them both ways unchanged."""
    jc = jsmoke(ARCH)
    jp = jax.tree.map(np.asarray,
                      jlm.init_params(jc, jax.random.PRNGKey(1), 1))
    back = params_to_numpy(params_from_numpy(jp, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    assert sorted(back["shared"]) == ["attn", "ffn", "ln1", "ln2"]
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)


def test_full_config_widths_and_count():
    cfg = tget(ARCH)
    s = cfg.ssm
    assert (cfg.n_layers, cfg.d_model, s.d_inner(cfg.d_model),
            s.n_heads(cfg.d_model), s.head_dim, s.d_state) == \
        (54, 2560, 5120, 80, 64, 64)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
            tzamba2.n_attn_apps(cfg)) == (32, 32, 80, 10240, 9)
    n = sum(int(np.prod(sp.shape))
            for _, sp in iter_specs(tlm.param_specs(cfg, 1)))
    jshapes = jax.eval_shape(lambda: jlm.init_params(
        jget(ARCH), jax.random.PRNGKey(0), 1))
    assert n == sum(a.size for a in jax.tree.leaves(jshapes))
    assert 2.3e9 < n < 2.5e9           # about 2.4 B, 9.6 GB in fp32


def test_forward_train_raises_naming_the_roadmap():
    """It raised naming ROADMAP A17 until zamba2 training was ported (the
    name is kept): the training forward's features (no cache, the shared
    block's train mode) against the reference's ``_run(mode="train")``
    and final norm, at a ragged S."""
    jc, jp, tc, tp = _bind()
    toks = _tokens(jc, (2, 70), seed=3)
    jx, _ = jzamba2._run(jc, jp, jnp.take(jp["embed"], jnp.asarray(toks),
                                          axis=0), 1, "train")
    jx = jcommon.rms_norm(jx, jp["final_norm"], jc.rms_eps)
    with torch.no_grad():
        tx, aux, prefix = tlm.forward_train(
            tc, tp, {"tokens": torch.from_numpy(toks)}, 1)
    assert prefix == 0 and float(aux) == 0.0
    _close(tx, jx, "training features")
