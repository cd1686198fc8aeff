"""The moe, vlm and audio transformer families of the port
(models/transformer.py, models/attention.py's prefix-LM mask, models/lm.py)
against the JAX reference, from the reference's own params
(``lm.init_params(PRNGKey)``, carried over with models/convert.py) and the
same numpy batches, on the smoke configs of granite-moe-3b-a800m,
deepseek-moe-16b (MoE; S = 256 takes the 256-token grouped routing with
capacity, shorter inputs the dropless group), paligemma-3b (vlm: patch
prefix, prefix-LM attention, gelu-tanh FFN, sqrt(d)-scaled embeddings)
and hubert-xlarge (audio: frames, mask_embed, non-causal encoder).

Tolerances (fp32, the port's sums in another order than XLA's):
features, logits and cache K/V within 2e-5 of max(1, max |reference|)
(measured on the CPU: 1.3e-6), losses within 2e-6 relative (measured
9.8e-8), each gradient leaf within 1e-4 of its max |value| against
``jax.grad`` (measured 1.6e-6), two single-pod train steps as
tests/test_torch_lm_train.py holds them; cache positions and served
tokens exactly.
"""
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
from repro.launch.mesh import make_host_mesh
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.models import transformer as jtr
from repro.runtime import sharding as shd
from repro.serve import ServeEngine as JEngine
from repro.serve import ServeSpec as JSpec
from repro.serve import make_requests as jmake
from repro_torch.configs.base import TrainConfig as TTrainConfig
from repro_torch.configs.registry import get_smoke_config as tsmoke
from repro_torch.core import steps as tsteps
from repro_torch.launch import train as tlaunch
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models import transformer as ttr
from repro_torch.models.common import index_tree, unflatten_tree
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import ServeEngine as TEngine
from repro_torch.serve import ServeRequest as TRequest
from repro_torch.serve import ServeSpec as TSpec

torch.set_num_threads(1)

MOE = ["granite-moe-3b-a800m", "deepseek-moe-16b"]
ARCHS = MOE + ["paligemma-3b", "hubert-xlarge"]
RTOL = 2e-5
LOSS_RTOL = 2e-6
GRAD_RTOL = 1e-4


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, what="", rtol=RTOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    bound = rtol * max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    assert err <= bound, f"{what}: max abs err {err} > {bound}"


def _bind(arch, backend="auto"):
    jc = jsmoke(arch).replace(attention_backend=backend)
    tc = tsmoke(arch).replace(attention_backend=backend)
    jp = jlm.init_params(jc, jax.random.PRNGKey(0), 1, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jp, tc, tp


def _batch(cfg, B, S, seed=0, n_patches=16, with_mask=True):
    """numpy batch of the family's inputs: S positions in all (vlm:
    n_patches patch embeddings, then S - n_patches tokens)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"patch_embeds": rng.standard_normal(
                    (B, n_patches, cfg.d_model)).astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab_size,
                                       (B, S - n_patches)).astype(np.int32)}
    if cfg.family == "audio":
        b = {"frames": rng.standard_normal((B, S, cfg.d_model)).astype(
                 np.float32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                 np.int32)}
        if with_mask:
            b["mask"] = rng.random((B, S)) < 0.25
        return b
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _leaves(tree):
    if isinstance(tree, dict):
        return [(k + "/" + p if p else k, x) for k in sorted(tree)
                for p, x in _leaves(tree[k])]
    return [("", tree)]


# ---------------------------------------------------------------------------
# frontends and the prefix-LM mask
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,with_mask", [
    ("paligemma-3b", True), ("hubert-xlarge", True),
    ("hubert-xlarge", False), ("granite-moe-3b-a800m", True)])
def test_embed_inputs_match_reference(arch, with_mask):
    jc, jp, tc, tp = _bind(arch)
    b = _batch(jc, 2, 40, seed=1, with_mask=with_mask)
    jx, jprefix = jtr.embed_inputs(jc, jp, _j(b), 1)
    with torch.no_grad():
        tx, tprefix = ttr.embed_inputs(tc, tp, _t(b), 1)
    assert tprefix == jprefix == (16 if jc.family == "vlm" else 0)
    _close(tx, jx, "embedded inputs")
    if jc.family == "audio" and with_mask:
        m = b["mask"]
        assert np.array_equal(_np(tx)[m], np.broadcast_to(
            _np(tp["mask_embed"]), (int(m.sum()), tc.d_model)))


@pytest.mark.parametrize("arch,key", [("paligemma-3b", "patch_embeds"),
                                      ("hubert-xlarge", "frames")])
def test_missing_frontend_input_is_a_value_error(arch, key):
    cfg = tsmoke(arch)
    p = tlm.init_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match=key):
        ttr.embed_inputs(cfg, p, {"tokens": torch.zeros(
            1, 4, dtype=torch.int32)}, 1)
    # the serving engine passes tokens only: its first prefill fails
    engine = TEngine(cfg, p, TSpec(slots=2, max_len=16, prefill_len=8))
    with pytest.raises(ValueError, match=key):
        engine.run([TRequest(0, np.arange(4, dtype=np.int32), 2)])


@pytest.mark.parametrize("backend", ["auto", "flash", "reference"])
@pytest.mark.parametrize("S,prefix", [(40, 16), (150, 100), (150, 0)])
def test_prefix_lm_attention_matches_reference(backend, S, prefix):
    """paligemma-smoke's first attention layer (MQA, hd 16, attn_chunk 64)
    with a prefix-LM mask: full_attention, and prefill_attention with its
    cache write; S = 150 takes the chunked path of the reference backend
    (and three query blocks of the blocked path)."""
    jc, jp, tc, tp = _bind("paligemma-3b", backend)
    x = np.random.default_rng(2).standard_normal((2, S, jc.d_model)).astype(
        np.float32)
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tl = index_tree(tp["layers"]["attn"], 0)
    pos = np.arange(S, dtype=np.int32)
    want = jattn.full_attention(jc, jl, jnp.asarray(x), jnp.asarray(pos), 1,
                                prefix)
    jcache = jattn.init_cache(jc, 2, S + 4, 1, jnp.float32)
    wpre, jcache = jattn.prefill_attention(jc, jl, jnp.asarray(x),
                                           jnp.asarray(pos), 1, jcache,
                                           prefix)
    with torch.no_grad():
        got = tattn.full_attention(tc, tl, torch.from_numpy(x),
                                   torch.from_numpy(pos), 1, prefix)
        tcache = tattn.init_cache(tc, 2, S + 4, 1, torch.float32,
                                  device="cpu")
        gpre, tcache = tattn.prefill_attention(
            tc, tl, torch.from_numpy(x), torch.from_numpy(pos), 1, tcache,
            prefix)
    _close(got, want, "full_attention")
    _close(gpre, wpre, "prefill_attention")
    _close(tcache.k, jcache.k, "cache k")
    np.testing.assert_array_equal(tcache.positions.numpy(),
                                  np.asarray(jcache.positions))
    if prefix:   # the prefix is visible: it differs from the causal mask
        causal = tattn.full_attention(tc, tl, torch.from_numpy(x),
                                      torch.from_numpy(pos), 1, 0)
        assert float((causal - got)[:, :prefix].abs().max()) > 1e-4


def test_gelu_ffn_is_the_tanh_approximation():
    rng = np.random.default_rng(3)
    h, w1, w2 = (rng.standard_normal(s).astype(np.float32)
                 for s in ((4, 5, 16), (16, 32), (16, 32)))
    w3 = rng.standard_normal((32, 16)).astype(np.float32)
    want = jcommon.swiglu(*(jnp.asarray(a) for a in (h, w1, w2, w3)),
                          act="gelu")
    args = [torch.from_numpy(a) for a in (h, w1, w2, w3)]
    got = tcommon.swiglu(*args, act="gelu")
    _close(got, want, "gelu swiglu")
    # the erf form is another function: far outside the tolerance
    g = torch.matmul(args[0], args[1])
    erf = torch.matmul(torch.nn.functional.gelu(g) * torch.matmul(
        args[0], args[2]), args[3])
    assert float((erf - got).abs().max()) > 1e-4
    _close(tcommon.swiglu(*args), jcommon.swiglu(
        *(jnp.asarray(a) for a in (h, w1, w2, w3))), "silu swiglu")


# ---------------------------------------------------------------------------
# forward, loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("backend", ["auto", "reference"])
def test_forward_train_matches_reference(arch, backend):
    jc, jp, tc, tp = _bind(arch, backend)
    b = _batch(jc, 2, 256, seed=4)
    jx, jaux, jprefix = jtr.forward_train(jc, jp, _j(b), 1)
    with torch.no_grad():
        tx, taux, tprefix = tlm.forward_train(tc, tp, _t(b), 1)
    assert tprefix == jprefix
    _close(tx, jx, "features")
    assert abs(float(taux) - float(jaux)) <= LOSS_RTOL * abs(float(jaux))
    assert (float(taux) > 0) == (jc.family == "moe")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_reference(arch, remat):
    jc, jp, tc, tp = _bind(arch)
    jc, tc = jc.replace(remat=remat), tc.replace(remat=remat)
    b = _batch(jc, 2, 256, seed=5)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jlm.loss_fn(jc, p, _j(b), 1), has_aux=True)(jp)
    leaves = {k: v.requires_grad_(True) for k, v in _leaves(tp)}
    tl, tm = tlm.loss_fn(tc, unflatten_tree(leaves), _t(b), 1)
    tg = [torch.zeros_like(x) if g is None else g for x, g in zip(
        leaves.values(), torch.autograd.grad(tl, list(leaves.values()),
                                             allow_unused=True))]
    for key, got, want in (("loss", tl, jl), ("ce", tm["ce_loss"],
                                              jm["ce_loss"]),
                           ("aux", tm["aux_loss"], jm["aux_loss"])):
        assert abs(float(got.detach()) - float(want)) <= \
            LOSS_RTOL * abs(float(want)), key
    jgl = dict(_leaves(jg))
    assert sorted(jgl) == sorted(leaves)
    for (path, _), g in zip(leaves.items(), tg):
        want = np.asarray(jgl[path])
        err = float(np.abs(_np(g) - want).max())
        assert err <= GRAD_RTOL * max(float(np.abs(want).max()), 1e-8), path
    # the input side receives gradient (tests/test_models_smoke.py's probe)
    probe = "frontend_proj" if tc.family == "audio" else "embed"
    assert float(np.abs(_np(tg[list(leaves).index(probe)])).max()) > 0


def test_vlm_loss_counts_only_the_text():
    """The vlm targets start at the prefix: the patch positions and the
    last position carry no loss, so changing a token's label there (the
    first text token is never a target) leaves the loss unchanged."""
    _, _, tc, tp = _bind("paligemma-3b")
    b = _t(_batch(tc, 1, 48, seed=6))
    labels, mask = ttr._labels_and_mask(tc, b, 1, 48, 16, "cpu")
    assert mask[0, :16].sum() == 0 and mask[0, 16:47].all() and mask[0, 47] == 0
    assert torch.equal(labels[0, 16:47], b["tokens"][0, 1:].long())


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

# (arch, slots, prefill width in positions, last positions, cache max_len)
SERVE_CASES = {
    "granite-moe-3b-a800m": (2, 256, (255, 130), 270),   # grouped routing
    "deepseek-moe-16b": (3, 20, (19, 12, 6), 40),        # dropless
    "paligemma-3b": (3, 40, (39, 30, 20), 60),           # 16 patches first
}


@pytest.mark.parametrize("arch", list(SERVE_CASES))
@pytest.mark.parametrize("backend", ["auto", "reference"])
def test_serve_prefill_and_decode_match_reference(arch, backend):
    jc, jp, tc, tp = _bind(arch, backend)
    B, P, last, max_len = SERVE_CASES[arch]
    b = _batch(jc, B, P, seed=7)
    last = np.asarray(last, np.int32)
    jcache = jlm.init_cache(jc, B, max_len, 1, jnp.float32)
    tcache = tlm.init_cache(tc, B, max_len, 1, torch.float32, device="cpu")
    jl, jcache = jlm.serve_prefill(jc, jp, _j(b), 1, jcache,
                                   last_pos=jnp.asarray(last))
    with torch.no_grad():
        tl, tcache = tlm.serve_prefill(tc, tp, _t(b), 1, tcache,
                                       last_pos=torch.from_numpy(last))
    _close(tl, jl, "prefill logits")
    np.testing.assert_array_equal(tcache.positions.numpy(),
                                  np.asarray(jcache.positions))
    _close(tcache.k, jcache.k, "prefill cache k")
    pos = last + 1
    for j in range(4):
        step = np.random.default_rng(20 + j).integers(
            0, jc.vocab_size, B).astype(np.int32)
        jl, jcache = jlm.serve_step(jc, jp, jnp.asarray(step),
                                    jnp.asarray(pos), 1, jcache)
        with torch.no_grad():
            tl, tcache = tlm.serve_step(tc, tp, torch.from_numpy(step),
                                        torch.from_numpy(pos), 1, tcache)
        _close(tl, jl, f"decode step {j} logits")
        pos = pos + 1
    _close(tcache.v, jcache.v, "decoded cache v")


def test_encoder_prefill_matches_reference():
    jc, jp, tc, tp = _bind("hubert-xlarge")
    b = _batch(jc, 2, 48, seed=8)
    jcache = jlm.init_cache(jc, 2, 48, 1, jnp.float32)
    tcache = tlm.init_cache(tc, 2, 48, 1, torch.float32, device="cpu")
    jl, _ = jlm.serve_prefill(jc, jp, _j(b), 1, jcache)
    with torch.no_grad():
        tl, _ = tlm.serve_prefill(tc, tp, _t(b), 1, tcache)
    _close(tl, jl, "encoder logits")


@pytest.mark.parametrize("arch,fields,n,plen,max_new", [
    ("granite-moe-3b-a800m", dict(slots=2, max_len=272, prefill_len=256),
     3, 256, 6),
    ("deepseek-moe-16b", dict(slots=3, max_len=48, prefill_len=16), 7, 16,
     6),
])
def test_moe_engine_matches_reference_tokens(arch, fields, n, plen,
                                             max_new):
    jc, jp, tc, tp = _bind(arch)
    reqs = jmake(n, rate=0.0, prompt_len=plen, max_new=max_new,
                 vocab_size=jc.vocab_size, seed=1)
    jdone = JEngine(jc, jp, JSpec(max_new=max_new, **fields)).run(reqs)
    tdone = TEngine(tc, tp, TSpec(max_new=max_new, **fields)).run(
        [TRequest(r.rid, r.prompt.copy(), r.max_new, r.arrival)
         for r in reqs])
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    for t, j in zip(tdone, jdone):
        assert t.out == j.out and t.truncated == j.truncated, t.rid


@pytest.mark.parametrize("arch,want", [
    ("granite-moe-3b-a800m", "layers"), ("deepseek-moe-16b", "layers"),
    ("paligemma-3b", 0), ("hubert-xlarge", "layers")])
def test_kernel_resolved_prefill_routes_each_family(arch, want, monkeypatch):
    """Where ``auto`` resolves to the kernel (CUDA tensors), moe and audio
    prefills call the flash kernel wrapper once per layer (hubert
    non-causal), and a vlm prefill never does: its prefix-LM mask takes
    the blocked path, the reference's rule."""
    from repro_torch.kernels import ops as tops
    from repro_torch.kernels import ref as tref
    calls = []

    def kernel(q, k, v, causal=True, window=None):
        calls.append(causal)
        return tref.blocked_attention(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(tops, "default_attention_impl", lambda x: "kernel")
    monkeypatch.setattr(tops, "flash_attention", kernel)
    _, _, tc, tp = _bind(arch)
    cache = tlm.init_cache(tc, 2, 64, 1, torch.float32, device="cpu")
    with torch.no_grad():
        logits, _ = tlm.serve_prefill(tc, tp, _t(_batch(tc, 2, 40)), 1,
                                      cache)
    assert bool(torch.isfinite(logits).all())
    n = tc.n_layers if want == "layers" else 0
    assert calls == [tc.causal] * n, calls


# ---------------------------------------------------------------------------
# invariants (tests/test_model_invariants.py) in the port
# ---------------------------------------------------------------------------

def _logits_all(cfg, p, batch):
    x, _, _ = tlm.forward_train(cfg, p, batch, 1)
    return ttr.lm_head(cfg, p, x)


@pytest.mark.parametrize("arch", MOE)
def test_causality(arch):
    """Perturbing a future token leaves past logits unchanged (48 tokens:
    the dropless group routes each token on its own)."""
    cfg = tsmoke(arch)
    p = tlm.init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(_batch(cfg, 1, 48, seed=9)["tokens"])
    toks2 = toks.clone()
    toks2[0, 40] = (toks2[0, 40] + 1) % cfg.vocab_size
    with torch.no_grad():
        la = _logits_all(cfg, p, {"tokens": toks})
        lb = _logits_all(cfg, p, {"tokens": toks2})
    assert float((la[:, :40] - lb[:, :40]).abs().max()) < 1e-5
    assert float((la[:, 40:] - lb[:, 40:]).abs().max()) > 1e-5


def test_encoder_is_not_causal():
    cfg = tsmoke("hubert-xlarge")
    p = tlm.init_params(cfg, 0, device="cpu")
    frames = torch.randn(1, 32, cfg.d_model,
                         generator=torch.Generator().manual_seed(4))
    frames2 = frames.clone()
    frames2[0, 30] += 1.0
    with torch.no_grad():
        x, _, _ = tlm.forward_train(cfg, p, {"frames": frames}, 1)
        x2, _, _ = tlm.forward_train(cfg, p, {"frames": frames2}, 1)
    assert float((x[:, :30] - x2[:, :30]).abs().max()) > 1e-6


def test_federated_client_stack_is_dense_only():
    cfg = tsmoke("granite-moe-3b-a800m")
    with pytest.raises(ValueError, match="dense family only"):
        ttr.forward_train_clients(cfg, {}, torch.zeros(1, 1, 4,
                                                       dtype=torch.int32))


# ---------------------------------------------------------------------------
# training: the single-pod step and the trainer entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "paligemma-3b",
                                  "hubert-xlarge"])
def test_single_pod_steps_match_reference(arch):
    """Two steps, microbatch 2, of make_single_pod_step from the
    reference's params0 and the pipeline's batches (patches and frames
    included)."""
    jc = jsmoke(arch).replace(microbatch=2)
    tc = tsmoke(arch).replace(microbatch=2)
    kw = dict(lr=3e-4, warmup_steps=2, total_steps=10)
    mesh = make_host_mesh()
    with mesh, shd.use_mesh(mesh):
        jf = jsteps.make_single_pod_step(jc, JTrainConfig(**kw), mesh)
        jstate = jf.init_state(jax.random.PRNGKey(0))
        jstep = jax.jit(jf.train_step)
        tf = tsteps.make_single_pod_step(tc, TTrainConfig(**kw),
                                         device="cpu")
        tstate = params_from_numpy(jax.tree.map(np.asarray, jstate),
                                   device="cpu")
        pipe = JPipe(jc, JShape("s", 64, 4, "train"), seed=0)
        for i in range(2):
            batch = pipe.batch(i)
            jstate, jm = jstep(jstate, _j(batch))
            tstate, tm = tf.train_step(tstate, batch)
            for key in ("loss", "grad_norm", "lr_scale"):
                want = float(jm[key])
                assert abs(float(tm[key]) - want) <= 1e-5 * abs(want), key
            assert abs(float(tm["ce_loss"] + tm["aux_loss"])
                       - float(tm["loss"])) <= 1e-6 * float(tm["loss"])
    lr = kw["lr"]
    for (path, got), (_, want) in zip(_leaves(tstate["params"]),
                                      _leaves(jstate["params"])):
        want = np.asarray(want)
        err = float(np.abs(_np(got) - want).max())
        assert err <= 2e-5 * float(np.abs(want).max()) + 1e-3 * lr, path


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-moe-16b",
                                  "paligemma-3b", "hubert-xlarge"])
def test_trainer_runs_each_family_on_the_cpu(arch, tmp_path):
    res = tlaunch.run(tlaunch.parser().parse_args(
        ["--arch", arch, "--smoke", "--steps", "2", "--ckpt-dir",
         str(tmp_path), "--ckpt-every", "5", "--device", "cpu"]))
    assert res.end_step == 2 and res.runner_stats["failures"] == 0
    for row in res.metrics:
        assert np.isfinite(row["loss"]) and set(row) >= {"ce_loss",
                                                         "aux_loss"}
        assert (row["aux_loss"] > 0) == (arch in MOE)


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_roundtrip_of_each_new_family(arch):
    """models/convert.py is generic over nested dicts: the moe subtree,
    frontend_proj and mask_embed come across bit for bit, both ways."""
    from repro_torch.models.convert import params_to_numpy
    jp = jax.tree.map(np.asarray, jlm.init_params(
        jsmoke(arch), jax.random.PRNGKey(3), 1))
    back = params_to_numpy(params_from_numpy(jp, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for (path, a), (_, b) in zip(_leaves(back), _leaves(jp)):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    keys = {p for p, _ in _leaves(jp)}
    want = {"granite-moe-3b-a800m": "layers/moe/router",
            "deepseek-moe-16b": "layers/moe/ws_out",
            "paligemma-3b": "frontend_proj",
            "hubert-xlarge": "mask_embed"}[arch]
    assert want in keys
