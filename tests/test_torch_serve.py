"""The port's serving plane (repro_torch.serve, repro_torch.launch.serve)
against the JAX reference: the same requests through both engines give
the same token ids, truncation flags and finish order (from the
reference's params); the load generator and the report are numpy and
match bit for bit; the engine's own contracts (one input shape per call
kind, recycled slot == fresh slot, truncation flagged) hold; ServeSpec
rejects what the reference rejects, with the same messages.

Greedy decoding compares argmax ids, so the logits only need to agree to
well within the gap between the two best tokens (tests/test_torch_lm.py
holds them to 2e-5).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.spec import SpecError as JSpecError
from repro.configs.registry import get_smoke_config as jsmoke
from repro.launch import serve as jlaunch
from repro.models import lm as jlm
from repro.serve import ServeEngine as JEngine
from repro.serve import ServeRequest as JRequest
from repro.serve import ServeSpec as JSpec
from repro.serve import make_requests as jmake
from repro.serve import poisson_arrivals as jarrivals
from repro.serve import report as jreport
from repro_torch import serve as tserve
from repro_torch.api import cli as tcli
from repro_torch.api.spec import SpecError as TSpecError
from repro_torch.configs.registry import get_smoke_config as tsmoke
from repro_torch.launch import serve as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import ServeEngine as TEngine
from repro_torch.serve import ServeRequest as TRequest
from repro_torch.serve import ServeSpec as TSpec

torch.set_num_threads(1)


def _bind(arch, backend="auto"):
    jc = jsmoke(arch).replace(attention_backend=backend)
    tc = tsmoke(arch).replace(attention_backend=backend)
    jp = jlm.init_params(jc, jax.random.PRNGKey(0), 1, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, jp, tc, tp


def _as_torch_requests(reqs):
    return [TRequest(r.rid, r.prompt.copy(), r.max_new, r.arrival)
            for r in reqs]


# (arch, backend, spec fields, n requests, prompt_len, max_new)
ENGINE_CASES = [
    ("tiny-lm", "auto", dict(slots=3, max_len=48, prefill_len=16), 7, 16, 6),
    ("tiny-lm", "reference", dict(slots=3, max_len=48, prefill_len=16),
     7, 16, 6),
    ("qwen2-7b", "auto", dict(slots=3, max_len=48, prefill_len=16), 7, 16, 6),
    # positions past the 64-row window: decode writes wrap the ring
    ("h2o-danube-3-4b", "auto", dict(slots=2, max_len=100, prefill_len=40),
     5, 40, 30),
    # a 12-position budget truncates long prompts mid-generation
    ("qwen2-7b", "auto", dict(slots=2, max_len=12, prefill_len=8), 4, 8, 8),
    # the recurrent families force-feed every prompt through decode steps
    ("rwkv6-3b", "auto", dict(slots=3, max_len=48, prefill_len=16), 7, 16, 6),
    ("zamba2-2.7b", "auto", dict(slots=3, max_len=48, prefill_len=16),
     5, 16, 6),
]


@pytest.mark.parametrize("arch,backend,fields,n,plen,max_new", ENGINE_CASES)
def test_engine_matches_reference_tokens(arch, backend, fields, n, plen,
                                         max_new):
    jc, jp, tc, tp = _bind(arch, backend)
    reqs = jmake(n, rate=0.0, prompt_len=plen, max_new=max_new,
                 vocab_size=jc.vocab_size, seed=1)
    jdone = JEngine(jc, jp, JSpec(max_new=max_new, **fields)).run(reqs)
    eng = TEngine(tc, tp, TSpec(max_new=max_new, **fields))
    tdone = eng.run(_as_torch_requests(reqs))
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    for t, j in zip(tdone, jdone):
        assert t.out == j.out, f"rid {t.rid}"
        assert t.truncated == j.truncated
    # one input shape per call kind; recurrent families never prefill
    used = ("prefill", "decode", "reset") if eng.is_transformer else \
        ("decode", "reset")
    assert {k: len(v) for k, v in eng.call_shapes.items() if v} == \
        {k: 1 for k in used}, eng.call_shapes


@pytest.mark.parametrize("rate", [0.0, 5.0])
def test_loadgen_is_bitwise_the_reference(rate):
    np.testing.assert_array_equal(tserve.poisson_arrivals(16, rate, 3),
                                  jarrivals(16, rate, 3))
    a = tserve.make_requests(9, rate, 32, 5, 128, seed=4)
    b = jmake(9, rate, 32, 5, 128, seed=4)
    for x, y in zip(a, b):
        assert (x.rid, x.max_new, x.arrival) == (y.rid, y.max_new, y.arrival)
        assert x.prompt.dtype == y.prompt.dtype
        np.testing.assert_array_equal(x.prompt, y.prompt)


def test_report_matches_reference():
    def done(cls):
        out = []
        for i in range(5):
            r = cls(i, np.zeros(3, np.int32), 4, arrival=0.1 * i)
            r.out = list(range(4 - i % 2))
            r.truncated = bool(i % 2)
            r.t_admit, r.t_first, r.t_done = 0.2 * i, 0.3 * i + 0.1, 0.5 * i + 1
            out.append(r)
        return out
    a, b = tserve.report(done(TRequest)), jreport(done(JRequest))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k] or (math.isnan(a[k]) and math.isnan(b[k])), k


def test_one_input_shape_per_call_kind_under_open_loop_load():
    _, _, tc, tp = _bind("tiny-lm")
    eng = TEngine(tc, tp, TSpec(slots=3, max_len=48, prefill_len=16,
                                max_new=5))
    done = eng.run(tserve.make_requests(8, rate=200.0, prompt_len=16,
                                        max_new=5, vocab_size=tc.vocab_size,
                                        seed=2))
    assert sorted(r.rid for r in done) == list(range(8))
    assert all(len(r.out) == 5 and not r.truncated for r in done)
    assert all(r.t_admit <= r.t_first <= r.t_done for r in done)
    assert {k: len(v) for k, v in eng.call_shapes.items()} == \
        {"prefill": 1, "decode": 1, "reset": 1}
    assert eng.call_shapes["prefill"] == {((3, 16), (3,))}
    assert eng.call_shapes["decode"] == {((3,), (3,))}


def test_ttft_of_a_prefilled_request_includes_the_prefill():
    """The first token exists once the prefill wave has run: with a clock
    that the wave advances by 10 s, TTFT is at least 10 s.  (The reference
    stamps the wave's start instead; ROADMAP section C.)"""
    _, _, tc, tp = _bind("tiny-lm")
    eng = TEngine(tc, tp, TSpec(slots=2, max_len=32, prefill_len=8,
                                max_new=2))
    t = [0.0]
    prefill = eng._prefill

    def slow_prefill(*a):
        t[0] += 10.0
        return prefill(*a)
    eng._prefill = slow_prefill
    done = eng.run(tserve.make_requests(2, 0.0, 8, 2, tc.vocab_size, seed=0),
                   clock=lambda: t[0])
    assert len(eng.call_seconds["prefill"]) == 1
    assert all(r.t_first - r.arrival >= 10.0 for r in done)
    assert tserve.report(done)["ttft_p50_s"] >= 10.0


@pytest.mark.parametrize("backend", ["reference", "auto"])
def test_recycled_slot_matches_fresh_slot(backend):
    """A recycled slot (rows reset, position restarted at 0, prompt
    force-fed through decode) generates what a fresh slot generates, and
    its neighbours do not leak into it."""
    _, _, tc, tp = _bind("tiny-lm", backend)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, tc.vocab_size, 11).astype(np.int32)
    other = rng.integers(0, tc.vocab_size, 9).astype(np.int32)
    spec = TSpec(slots=2, max_len=48, prefill_len=16, max_new=6)
    reqs = [TRequest(0, prompt.copy(), 4), TRequest(1, other, 6),
            TRequest(2, prompt.copy(), 4)]
    done = {r.rid: r for r in TEngine(tc, tp, spec).run(reqs)}
    assert done[0].out == done[2].out
    alone = TEngine(tc, tp, spec).run([TRequest(0, prompt.copy(), 4)])
    assert alone[0].out == done[0].out


def test_truncation_is_flagged():
    _, _, tc, tp = _bind("tiny-lm")
    spec = TSpec(slots=1, max_len=12, prefill_len=8, max_new=64)
    rng = np.random.default_rng(2)
    req = TRequest(0, rng.integers(0, tc.vocab_size, 8).astype(np.int32), 64)
    done = TEngine(tc, tp, spec).run([req])
    assert done[0].truncated
    assert 0 < len(done[0].out) < 64


@pytest.mark.parametrize("fields", [
    dict(slots=0), dict(max_len=1), dict(prefill_len=0),
    dict(max_len=8, prefill_len=9), dict(max_new=0), dict(dtype="float16"),
])
def test_serve_spec_rejects_like_the_reference(fields):
    with pytest.raises(JSpecError) as j:
        JSpec(**fields).validate()
    with pytest.raises(TSpecError) as t:
        TSpec(**fields).validate()
    assert str(t.value) == str(j.value)


def test_serve_spec_strict_fields_and_roundtrip():
    spec = TSpec(slots=2, max_len=32)
    assert TSpec.from_dict(spec.to_dict()) == spec
    assert spec.to_dict() == JSpec(slots=2, max_len=32).to_dict()
    with pytest.raises(TSpecError) as t:
        TSpec.from_dict({"slots": 2, "batch": 3})
    with pytest.raises(JSpecError) as j:
        JSpec.from_dict({"slots": 2, "batch": 3})
    assert str(t.value) == str(j.value)


def test_launch_serve_matches_reference_launcher(monkeypatch):
    """The launcher end to end on the CPU: the reference's flags give the
    reference's requests, and from the reference's params the same
    tokens."""
    argv = ["--arch", "qwen2-7b", "--smoke", "--requests", "6", "--slots",
            "3", "--prompt-len", "12", "--max-new", "5", "--seed", "3"]
    jdone = jlaunch.main(argv)
    cfg = jsmoke("qwen2-7b")
    jp = jlm.init_params(cfg, jax.random.PRNGKey(3), 1, jnp.float32)
    monkeypatch.setattr(
        tlaunch.lm, "init_params",
        lambda *a, **k: params_from_numpy(jax.tree.map(np.asarray, jp),
                                          device="cpu"))
    eng, tdone, rep = tlaunch.run(argv + ["--device", "cpu"])
    assert [(r.rid, r.out, r.truncated) for r in tdone] == \
        [(r.rid, r.out, r.truncated) for r in jdone]
    assert rep["requests"] == 6 and rep["tokens"] == 30
    assert {k: len(v) for k, v in eng.call_shapes.items()} == \
        {"prefill": 1, "decode": 1, "reset": 1}


def test_launch_serve_main_runs_on_cpu_with_random_params():
    done = tlaunch.main(["--device", "cpu", "--arch", "h2o-danube-3-4b",
                         "--smoke", "--requests", "3", "--slots", "2",
                         "--prompt-len", "10", "--max-new", "3"])
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert all(len(r.out) == 3 for r in done)


def test_launch_serve_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.run(["--arch", "qwen2-7b", "--smoke"])


def test_prototype_server_matches_reference():
    """The prototype Server (right-aligned first wave, shared position
    counter, pending-deque handoff) gives the reference prototype's tokens
    from the same params."""
    cfg = jsmoke("qwen2-7b")
    rng = np.random.default_rng(5)
    mk = lambda cls: [cls(i, rng_prompts[i], 4) for i in range(5)]  # noqa
    rng_prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in (6, 9, 4, 7, 5)]
    js = jlaunch.Server(cfg, batch_slots=2, max_len=40, seed=0)
    ts = tlaunch.Server(tsmoke("qwen2-7b"), batch_slots=2, max_len=40,
                        seed=0, device="cpu")
    ts.params = params_from_numpy(jax.tree.map(np.asarray, js.params),
                                  device="cpu")
    jdone, jsteps = js.run(mk(jlaunch.Request))
    tdone, tsteps = ts.run(mk(tlaunch.Request))
    assert tsteps == jsteps
    assert [(r.rid, r.out, r.truncated) for r in tdone] == \
        [(r.rid, r.out, r.truncated) for r in jdone]


def test_checkpoint_serving_is_not_ported_yet(capsys):
    """Checkpoint serving is ported (A15): the loader, the
    ``serve_from_checkpoint`` entry and the CLI's ``serve`` subcommand
    refuse a directory without a checkpoint with the reference's error
    (tests/test_torch_loader.py serves real checkpoints)."""
    from repro.serve import load_checkpoint as jload
    with pytest.raises(JSpecError) as want:
        jload("some/dir")
    for call in (lambda: tserve.load_checkpoint("some/dir", device="cpu"),
                 lambda: tserve.serve_from_checkpoint(
                     "some/dir", TSpec(), [], device="cpu")):
        with pytest.raises(TSpecError) as e:
            call()
        assert str(e.value) == str(want.value)
    assert tserve.LoadedCheckpoint.__dataclass_fields__.keys() == {
        "spec", "spec_hash", "step", "params", "model"}
    with pytest.raises(SystemExit) as e:
        tcli.main(["serve", "--resume-from", "some/dir", "--device", "cpu"])
    assert str(e.value) == f"spec error: {want.value}"
    # the LM facade is the same object the launcher and engine use
    assert tlaunch.lm is tlm


# --- the recurrent families (ssm: rwkv6, hybrid: zamba2) ---------------------

RECURRENT = ["rwkv6-3b", "zamba2-2.7b"]


def _tree_leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for sub in tree for t in _tree_leaves(sub)]


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_engine_force_feeds_and_never_prefills(arch):
    """Prompts that fit the prefill width, all admitted at once: an
    attention family would prefill them in one wave; a recurrent one
    force-feeds them through decode steps (call_shapes["prefill"] stays
    empty), as the reference's _can_prefill rules."""
    _, _, tc, tp = _bind(arch)
    eng = TEngine(tc, tp, TSpec(slots=3, max_len=40, prefill_len=16,
                                max_new=4))
    done = eng.run(tserve.make_requests(3, 0.0, 16, 4, tc.vocab_size,
                                        seed=3))
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert eng.call_shapes["prefill"] == set()
    assert eng.call_seconds["prefill"] == []
    assert eng.call_shapes["decode"] == {((3,), (3,))}


@pytest.mark.parametrize("arch", RECURRENT)
def test_recycled_slot_nested_state_is_zeroed_bitwise(arch):
    """After a run has filled every slot's state, resetting one slot sets
    each of its leaves (zamba2: conv and SSD state, KV rows and positions
    nested two deep) to the init_cache state bit for bit, and leaves the
    other slots untouched."""
    _, _, tc, tp = _bind(arch)
    spec = TSpec(slots=3, max_len=40, prefill_len=16, max_new=4)
    eng = TEngine(tc, tp, spec)
    eng.run(tserve.make_requests(5, 0.0, 16, 4, tc.vocab_size, seed=4))
    before = [t.clone() for t in _tree_leaves(eng.cache)]
    eng._reset(np.array([False, True, False]))
    fresh = _tree_leaves(tlm.init_cache(tc, 3, 40, 1, torch.float32,
                                        device="cpu"))
    axes = _tree_leaves_axes(tlm.cache_axes_tree(tc, 1))
    assert len(axes) == len(fresh) == len(before)
    for got, old, new, ax in zip(_tree_leaves(eng.cache), before, fresh,
                                 axes):
        b = ax.index("cache_batch")
        row = lambda t, i: t.select(b, i)  # noqa: E731
        assert torch.equal(row(got, 1), row(new, 1))
        assert bool(row(old, 1).ne(row(new, 1)).any()), "slot 1 was empty"
        for i in (0, 2):
            assert torch.equal(row(got, i), row(old, i))


def _tree_leaves_axes(tree):
    if isinstance(tree, tuple) and all(
            isinstance(a, (str, type(None))) for a in tree):
        return [tree]
    return [a for sub in tree for a in _tree_leaves_axes(sub)]


def test_prototype_server_matches_reference_rwkv6():
    """The prototype Server on rwkv6-smoke: its first wave prefills through
    lm.serve_prefill (the chunk scan), and a recycled slot force-feeds its
    prompt into the carried state; the same tokens as the reference."""
    cfg = jsmoke("rwkv6-3b")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (6, 40, 4, 7, 5)]
    mk = lambda cls: [cls(i, p.copy(), 4) for i, p in enumerate(prompts)]  # noqa
    js = jlaunch.Server(cfg, batch_slots=2, max_len=64, seed=0)
    ts = tlaunch.Server(tsmoke("rwkv6-3b"), batch_slots=2, max_len=64,
                        seed=0, device="cpu")
    ts.params = params_from_numpy(jax.tree.map(np.asarray, js.params),
                                  device="cpu")
    jdone, jsteps = js.run(mk(jlaunch.Request))
    tdone, tsteps = ts.run(mk(tlaunch.Request))
    assert tsteps == jsteps
    assert [(r.rid, r.out, r.truncated) for r in tdone] == \
        [(r.rid, r.out, r.truncated) for r in jdone]


def test_launch_serve_defaults_to_rwkv6_like_the_reference():
    assert tlaunch.parse_args([]).arch == "rwkv6-3b"
    eng, done, rep = tlaunch.run(["--device", "cpu", "--smoke", "--requests",
                                  "3", "--slots", "2", "--prompt-len", "10",
                                  "--max-new", "3"])
    assert eng.cfg.name == "rwkv6-smoke"
    assert rep["requests"] == 3 and rep["tokens"] == 9
    assert eng.call_shapes["prefill"] == set()


@pytest.mark.parametrize("arch", RECURRENT)
def test_prefill_routes_each_layer_through_the_scan_kernel_wrapper(
        arch, monkeypatch):
    """Every layer's chunk scan of a prompt goes through the kernel
    wrapper (which launches the CUDA kernel for CUDA tensors), once per
    layer; zamba2's shared attention goes through the flash kernel
    wrapper once per application.  A decode step calls neither."""
    from repro_torch.kernels import ops as tops
    from repro_torch.kernels import ref as tref
    from repro_torch.kernels import rwkv6_scan as twkv
    from repro_torch.kernels import ssd as tssd
    calls = {"wkv6": 0, "ssd": 0, "flash_attention": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(twkv, "wkv6", counted("wkv6", twkv.wkv6))
    monkeypatch.setattr(tssd, "ssd_scan", counted("ssd", tssd.ssd_scan))
    monkeypatch.setattr(tops, "default_attention_impl", lambda x: "kernel")
    monkeypatch.setattr(tops, "flash_attention", counted(
        "flash_attention", lambda q, k, v, causal=True, window=None:
        tref.blocked_attention(q, k, v, causal=causal, window=window)))
    _, _, tc, tp = _bind(arch)
    toks = torch.from_numpy(np.random.default_rng(8).integers(
        0, tc.vocab_size, (2, 40)).astype(np.int32))
    cache = tlm.init_cache(tc, 2, 48, 1, torch.float32, device="cpu")
    with torch.no_grad():
        logits, _ = tlm.serve_prefill(tc, tp, {"tokens": toks}, 1, cache)
    assert bool(torch.isfinite(logits).all())
    if arch == "rwkv6-3b":
        want = {"wkv6": tc.n_layers, "ssd": 0, "flash_attention": 0}
    else:
        want = {"wkv6": 0, "ssd": tc.n_layers,
                "flash_attention": tc.n_layers // tc.attn_every}
    assert calls == want
    with torch.no_grad():
        tlm.serve_step(tc, tp, toks[:, 0], 40, 1, cache)
    assert calls == want
