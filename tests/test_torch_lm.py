"""The port's dense LM (models/common, attention, transformer, lm, convert)
against the JAX reference, from the reference's own params
(``lm.init_params(PRNGKey)``, carried over with convert.params_from_numpy)
and the same numpy token batches.

Configs: ``tiny-lm``, ``qwen2-smoke`` (QKV bias, GQA) and
``h2o-danube-smoke`` (sliding window 64, ring cache), under the ``auto``,
``flash`` and ``reference`` attention backends.  Tolerance: fp32 products
summed in another order than XLA's agree to a few ulps per layer; features
and logits are held to 2e-5 of max(1, max |reference|), cache K/V
likewise, cache positions exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jsmoke
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro_torch.configs.registry import ARCH_IDS as TARCHS
from repro_torch.configs.registry import get_config as tget
from repro_torch.configs.registry import get_smoke_config as tsmoke
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models.convert import params_from_numpy, params_to_numpy

torch.set_num_threads(1)

ARCHS = ["tiny-lm", "qwen2-7b", "h2o-danube-3-4b"]
BACKENDS = ["auto", "flash", "reference"]
RTOL = 2e-5


def _close(got, want, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    bound = RTOL * max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    assert err <= bound, f"{what}: max abs err {err} > {bound}"


def _bind(arch, backend):
    jc = jsmoke(arch).replace(attention_backend=backend)
    tc = tsmoke(arch).replace(attention_backend=backend)
    jp = jlm.init_params(jc, jax.random.PRNGKey(0), 1, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jp, tc, tp


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_forward_train_features_match_reference(arch, backend):
    jc, jp, tc, tp = _bind(arch, backend)
    toks = _tokens(jc, (2, 96))     # 96 > attn_chunk: the chunked path
    want, _, _ = jlm.transformer.forward_train(
        jc, jp, {"tokens": jnp.asarray(toks)}, 1)
    with torch.no_grad():
        got, aux, prefix = tlm.forward_train(
            tc, tp, {"tokens": torch.from_numpy(toks)}, 1)
    assert prefix == 0 and float(aux) == 0.0
    _close(got, want, f"{arch}/{backend} features")


def test_windowed_reference_backend_with_ragged_last_chunk():
    """h2o-danube-smoke at S=150 (not a multiple of attn_chunk=64, window
    slab 64 + 64 < S): the port's reference backend equals the flash
    backends of both packages.  The reference's own reference backend
    differs there (ROADMAP §C: its last slab is clamped by dynamic_slice
    while the mask keeps the unclamped positions)."""
    jc, jp, tc, tp = _bind("h2o-danube-3-4b", "flash")
    toks = _tokens(jc, (2, 150), seed=1)
    want, _, _ = jlm.transformer.forward_train(
        jc, jp, {"tokens": jnp.asarray(toks)}, 1)
    with torch.no_grad():
        for be in ("flash", "reference"):
            got, _, _ = tlm.forward_train(
                tc.replace(attention_backend=be), tp,
                {"tokens": torch.from_numpy(toks)}, 1)
            _close(got, want, f"port {be} vs reference flash")


# (arch, slots, prefill width, prompt lengths, cache max_len)
SERVE_CASES = {
    "tiny-lm": (3, 20, (20, 13, 7), 48),
    "qwen2-7b": (3, 20, (20, 13, 7), 48),
    # prefill wider than the 64-row ring: the pad-then-roll placement,
    # then decode writes wrap around the ring
    "h2o-danube-3-4b": (2, 80, (80, 70), 100),
}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_serve_prefill_and_decode_match_reference(arch, backend):
    jc, jp, tc, tp = _bind(arch, backend)
    B, P, lens, max_len = SERVE_CASES[arch]
    toks = _tokens(jc, (B, P), seed=2)
    for i, n in enumerate(lens):
        toks[i, n:] = 0                       # left-aligned prompts
    last = np.asarray(lens, np.int32) - 1
    jcache = jlm.init_cache(jc, B, max_len, 1, jnp.float32)
    tcache = tlm.init_cache(tc, B, max_len, 1, torch.float32, device="cpu")
    jl, jcache = jlm.serve_prefill(jc, jp, {"tokens": jnp.asarray(toks)}, 1,
                                   jcache, last_pos=jnp.asarray(last))
    with torch.no_grad():
        tl, tcache = tlm.serve_prefill(
            tc, tp, {"tokens": torch.from_numpy(toks)}, 1, tcache,
            last_pos=torch.from_numpy(last))
    _close(tl, jl, "prefill logits")
    np.testing.assert_array_equal(tcache.positions.numpy(),
                                  np.asarray(jcache.positions))
    _close(tcache.k, jcache.k, "prefill cache k")
    _close(tcache.v, jcache.v, "prefill cache v")

    # per-slot positions: each slot continues from its own prompt length
    pos = last + 1
    for j in range(6):
        step = _tokens(jc, (B,), seed=10 + j)
        jl, jcache = jlm.serve_step(jc, jp, jnp.asarray(step),
                                    jnp.asarray(pos), 1, jcache)
        with torch.no_grad():
            tl, tcache = tlm.serve_step(tc, tp, torch.from_numpy(step),
                                        torch.from_numpy(pos), 1, tcache)
        _close(tl, jl, f"decode step {j} logits")
        pos = pos + 1
    np.testing.assert_array_equal(tcache.positions.numpy(),
                                  np.asarray(jcache.positions))
    _close(tcache.k, jcache.k, "decoded cache k")
    _close(tcache.v, jcache.v, "decoded cache v")


def test_idle_slot_and_all_masked_rows_are_finite():
    """An idle slot decodes at a stale position over reset rows, as the
    engine's idle slots do, and matches the reference; a query whose mask
    is all false gets the reference's uniform softmax, not NaN."""
    jc, jp, tc, tp = _bind("qwen2-7b", "auto")
    jcache = jlm.init_cache(jc, 2, 16, 1, jnp.float32)
    tcache = tlm.init_cache(tc, 2, 16, 1, torch.float32, device="cpu")
    # slot 1 sits at position 20 over an empty cache: its one valid row is
    # the one it writes now, at 20 % 16
    pos = np.asarray([0, 20], np.int32)
    step = np.asarray([3, 5], np.int32)
    jl, _ = jlm.serve_step(jc, jp, jnp.asarray(step), jnp.asarray(pos), 1,
                           jcache)
    with torch.no_grad():
        tl, _ = tlm.serve_step(tc, tp, torch.from_numpy(step),
                               torch.from_numpy(pos), 1, tcache)
    assert torch.isfinite(tl).all()
    _close(tl, jl, "logits")
    from repro_torch.models import attention as tattn
    q = torch.randn(1, 1, 2, 2, 16)
    kv = torch.randn(1, 8, 2, 16)
    out = tattn._attend(q, kv, kv, torch.zeros(1, 1, 8, dtype=torch.bool))
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[0, 0, :, 0], kv[0].mean(0))


def test_common_numerics_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    g = rng.standard_normal((16,)).astype(np.float32)
    _close(tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(g)),
           jcommon.rms_norm(jnp.asarray(x), jnp.asarray(g)), "rms_norm")
    for pos in (np.arange(5, dtype=np.int32),         # (S,): prefill
                np.asarray([[3], [17]], np.int32)):     # (B, 1): decode
        xx = x if pos.ndim == 1 else x[:, :1]
        _close(tcommon.apply_rope(torch.from_numpy(xx),
                                  torch.from_numpy(pos), 1e6),
               jcommon.apply_rope(jnp.asarray(xx), jnp.asarray(pos), 1e6),
               "apply_rope")
    w1, w2 = (rng.standard_normal((16, 24)).astype(np.float32)
              for _ in range(2))
    w3 = rng.standard_normal((24, 16)).astype(np.float32)
    h = x[:, :, 0]
    _close(tcommon.swiglu(*(torch.from_numpy(a) for a in (h, w1, w2, w3))),
           jcommon.swiglu(*(jnp.asarray(a) for a in (h, w1, w2, w3))),
           "swiglu")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_shapes_and_counts(arch):
    cfg = tsmoke(arch)
    jc = jsmoke(arch)
    jshapes = jax.tree.map(
        lambda a: tuple(a.shape),
        jax.eval_shape(lambda: jlm.init_params(jc, jax.random.PRNGKey(0), 1)))
    p = tlm.init_params(cfg, seed=0, device="cpu")
    tshapes = jax.tree.map(lambda t: tuple(t.shape), params_to_numpy(p))
    assert tshapes == jshapes
    n = sum(a.size for a in jax.tree.leaves(params_to_numpy(p)))
    assert n == cfg.param_count() + cfg.d_model  # + the final norm
    # zeros/ones/normal inits as specified; the same seed draws the same
    assert float(p["layers"]["ln1"].min()) == 1.0
    again = tlm.init_params(cfg, seed=0, device="cpu")
    assert torch.equal(p["embed"], again["embed"])
    std = float(p["layers"]["ffn"]["w_in"].std())
    assert abs(std - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5


def test_qwen2_full_config_counts():
    cfg = tget("qwen2-7b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == \
        (28, 3584, 28, 4, 128, 18944, 152064)
    assert cfg.param_count() == 7_615_612_928
    assert TARCHS[:3] == ["zamba2-2.7b", "paligemma-3b", "h2o-danube-3-4b"]


def test_convert_nested_roundtrip():
    jc = jsmoke("qwen2-7b")
    jp = jax.tree.map(np.asarray,
                      jlm.init_params(jc, jax.random.PRNGKey(1), 1))
    back = params_to_numpy(params_from_numpy(jp, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_kernel_resolved_prefill_launches_the_kernel_wrapper(
        arch, backend, monkeypatch):
    """Where ``auto`` resolves to the kernel (CUDA tensors), every layer's
    full-sequence attention of the flash backend goes through the kernel
    wrapper, and no other path: the reference backend never calls it."""
    from repro_torch.kernels import ops as tops
    from repro_torch.kernels import ref as tref
    calls = []

    def kernel(q, k, v, causal=True, window=None):
        calls.append(tuple(q.shape))
        return tref.blocked_attention(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(tops, "default_attention_impl", lambda x: "kernel")
    monkeypatch.setattr(tops, "flash_attention", kernel)
    _, _, tc, tp = _bind(arch, backend)
    toks = torch.from_numpy(_tokens(tc, (2, 40)))
    cache = tlm.init_cache(tc, 2, 48, 1, torch.float32, device="cpu")
    with torch.no_grad():
        logits, _ = tlm.serve_prefill(tc, tp, {"tokens": toks}, 1, cache)
    assert bool(torch.isfinite(logits).all())
    want = 0 if backend == "reference" else tc.n_layers
    assert len(calls) == want, (backend, calls)


@pytest.mark.parametrize("arch,match", [
    ("deepseek-moe-16b", "A17"), ("rwkv6-3b", "A17"),
    ("zamba2-2.7b", "A17"), ("paligemma-3b", "A17"),
])
def test_unported_families_raise(arch, match):
    """Every case raised naming ROADMAP A17 before A17 was ported (the ids
    are kept): the moe and vlm families now build their params, the
    recurrent ones (ssm, hybrid) also train.  Each: the reference's tree
    and shapes, and the convert round trip of the reference's own params
    bit for bit; for the recurrent ones, a training forward that gives
    finite features (tests/test_torch_frontends.py and
    tests/test_torch_recurrent_train.py hold what they compute)."""
    cfg = tsmoke(arch)
    if cfg.family in ("ssm", "hybrid"):
        p = tlm.init_params(cfg, seed=0, device="cpu")
        with torch.no_grad():
            x, aux, prefix = tlm.forward_train(cfg, p, {"tokens": torch.zeros(
                1, 8, dtype=torch.int32)}, 1)
        assert x.shape == (1, 8, cfg.d_model) and prefix == 0
        assert bool(torch.isfinite(x).all()) and float(aux) == 0.0
    jc = jsmoke(arch)
    jshapes = jax.tree.map(
        lambda a: tuple(a.shape),
        jax.eval_shape(lambda: jlm.init_params(jc, jax.random.PRNGKey(0), 1)))
    p = tlm.init_params(cfg, seed=0, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), params_to_numpy(p)) == \
        jshapes
    assert ("moe" in p.get("layers", {})) == (cfg.family == "moe")
    assert ("frontend_proj" in p) == (cfg.family == "vlm")
    jp = jax.tree.map(np.asarray, jlm.init_params(jc, jax.random.PRNGKey(1),
                                                  1))
    back = params_to_numpy(params_from_numpy(jp, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)


def test_tp_and_device_policy(monkeypatch):
    """tp > 1 (A16) gives the reference's padded shapes; the default
    device is the card, with no fallback."""
    cfg = tsmoke("qwen2-7b")
    want = jax.tree.map(lambda s: tuple(s.shape),
                        jlm.abstract_params(jsmoke("qwen2-7b"), 2))
    got = jax.tree.map(lambda s: tuple(s.shape), tlm.param_specs(cfg, tp=2),
                       is_leaf=lambda s: hasattr(s, "axes"))
    assert got == want
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlm.init_params(cfg, seed=0)
