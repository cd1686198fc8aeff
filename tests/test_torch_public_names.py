"""The public names of the reference that the port's files carry, against
the JAX reference on the same numpy inputs, and a guard that keeps the
gap from regrowing unseen.

  * The device-free runtime modules ``runtime/straggler.py`` and
    ``runtime/hlo.py``: bitwise on the inputs of the reference's own tests
    (tests/test_fault.py, tests/test_sharding.py).
  * The torch forms of the aggregation weights (bitwise: exact small
    integers, correctly rounded division) and of the Eq. 4 / Algorithm 1
    averages (1e-6 relative: the sum over the stack in another order).
  * The package re-exports, ``global_test_set``, the codec helpers
    (``fake_quantize``/``error_bound`` bitwise; the scalar polyline
    references and ``roundtrip_error`` exactly), ``cross_tier_bits``, the
    CNN/logreg helpers and ``softmax_cross_entropy`` (2e-6 relative: fp32
    sums in another order), ``param_bytes`` and the ``SimEnv`` views.
  * The coverage guard: every public top-level function, class and method
    of each reference module whose file the port has exists in the port,
    or is listed in ``NOT_PORTED`` with the ROADMAP item that will bring
    it (A16: the mesh and sharding; A17: recurrent training).
"""
import ast
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress import polyline as jpoly
from repro.compress import quantize as jq
from repro.compress import transport as jtr
from repro.core import aggregation as jagg
from repro.core.simulation import SimConfig as JSimConfig
from repro.core.simulation import SimEnv as JSimEnv
from repro.configs.registry import get_smoke_config as jsmoke
from repro.data import federated as jfed
from repro.models import cnn as jcnn
from repro.models import common as jcommon
from repro.models import lm as jlm
from repro.runtime import hlo as jhlo
from repro.runtime import straggler as jstr
from repro_torch import core as tcore
from repro_torch import data as tdata
from repro_torch.compress import polyline as tpoly
from repro_torch.compress import quantize as tq
from repro_torch.compress import transport as ttr
from repro_torch.configs.registry import get_smoke_config as tsmoke
from repro_torch.core import aggregation as tagg
from repro_torch.core.simulation import SimConfig as TSimConfig
from repro_torch.core.simulation import SimEnv as TSimEnv
from repro_torch.data import federated as tfed
from repro_torch.models import cnn as tcnn
from repro_torch.models import common as tcommon
from repro_torch.models import lm as tlm
from repro_torch.models.convert import params_from_numpy
from repro_torch.runtime import hlo as thlo
from repro_torch.runtime import straggler as tstr

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1] / "src"
FP32_RTOL = 2e-6

#: reference names the port does not have yet, each with the ROADMAP
#: item that brings it; a whole file is listed by its path alone
NOT_PORTED = {
    "launch/dryrun.py": "A16",
    "launch/mesh.py": "A16",
    "runtime/sharding.py": "A16",
    "api/spec.py:MeshSpec.from_name": "A16",
    "core/steps.py:None_shape": "A16",
    "core/steps.py:opt_axes_like": "A16",
    "launch/train.py:build": "A16",
    "models/common.py:axes_from_specs": "A16",
    "models/common.py:shapes_from_specs": "A16",
    "models/common.py:shardings_from_specs": "A16",
    "models/lm.py:abstract_cache": "A16",
    "models/lm.py:abstract_params": "A16",
    "models/lm.py:anchor_params": "A16",
    "models/lm.py:input_axes": "A16",
    "models/lm.py:input_specs": "A16",
    "models/lm.py:param_axes": "A16",
    "models/zamba2.py:loss_fn": "A17",
    "models/zamba2.py:_chunked_ce": "A17",
    "models/lm.py:_rwkv_loss": "A17",
}


def _public_names(path: Path):
    """Top-level functions and classes not starting with ``_``, and the
    public methods of those classes (``Class.method``)."""
    out = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and \
                not node.name.startswith("_"):
            out.append(node.name)
            if isinstance(node, ast.ClassDef):
                out += [f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, ast.FunctionDef)
                        and not m.name.startswith("_")]
    return out


def _has(module, dotted: str) -> bool:
    obj = module
    for part in dotted.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


def _port_module(rel: str):
    mod = rel[:-3].replace("/", ".")
    if mod.endswith(".__init__"):
        mod = mod[:-len(".__init__")]
    return importlib.import_module("repro_torch." + mod)


def test_every_public_reference_name_is_ported_or_listed():
    missing = {}
    for ref in sorted((ROOT / "repro").rglob("*.py")):
        rel = ref.relative_to(ROOT / "repro").as_posix()
        if not (ROOT / "repro_torch" / rel).exists():
            missing[rel] = None
            continue
        port = _port_module(rel)
        for name in _public_names(ref):
            if not _has(port, name):
                missing[f"{rel}:{name}"] = None
    unlisted = sorted(k for k in missing if k not in NOT_PORTED)
    assert not unlisted, f"reference names the port lacks, not listed " \
        f"with a ROADMAP item: {unlisted}"
    # every entry of the list is still missing (ported names leave it)
    for key, item in NOT_PORTED.items():
        assert item in ("A16", "A17"), (key, item)
        rel, _, name = key.partition(":")
        if not name:
            assert not (ROOT / "repro_torch" / rel).exists(), key
            continue
        assert (ROOT / "repro" / rel).exists(), key
        assert not _has(_port_module(rel), name), \
            f"{key} is ported now: take it off NOT_PORTED"


def test_port_imports_no_jax_or_reference():
    bad = []
    for path in sorted((ROOT / "repro_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            bad += [f"{path}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


# ---------------------------------------------------------------------------
# runtime/straggler.py and runtime/hlo.py
# ---------------------------------------------------------------------------

def _fleet(mod, n_workers, n_tiers, lat):
    fp = mod.FleetProfiler(n_workers)
    for w in range(n_workers):
        for _ in range(5):
            fp.observe(w, lat(w))
    tm = fp.build_tier_map(n_tiers)
    return fp.latencies(), tm, mod.sync_plan(tm)


@pytest.mark.parametrize("n_workers,n_tiers,lat", [
    (8, 4, lambda w: 0.1 * (w + 1)),                 # tests/test_fault.py
    (7, 3, lambda w: 0.05 + 0.3 * ((w * 5) % 7)),
])
def test_straggler_bitwise(n_workers, n_tiers, lat):
    jl, jtm, jplan = _fleet(jstr, n_workers, n_tiers, lat)
    tl, ttm, tplan = _fleet(tstr, n_workers, n_tiers, lat)
    assert np.array_equal(jl, tl) and jl.dtype == tl.dtype
    assert np.array_equal(jtm.tier_of, ttm.tier_of)
    assert all(np.array_equal(a, b) for a, b in zip(jtm.members, ttm.members))
    assert tplan == jplan
    assert tplan["relative_rates"][0] == 1.0


def test_worker_profile_window_matches_reference():
    j, t = jstr.WorkerProfile(0), tstr.WorkerProfile(0)
    for i in range(140):
        j.observe(0.01 * (i % 13), window=128)
        t.observe(0.01 * (i % 13), window=128)
    assert t.step_times == j.step_times and len(t.step_times) == 128
    assert t.latency == j.latency
    assert tstr.WorkerProfile(1).latency == 0.0


#: tests/test_sharding.py's sample, plus a tuple all-gather, an async
#: start/done pair and an all-to-all
HLO_SAMPLE = """
ENTRY %main {
  %ag = bf16[2,512,128]{2,1,0} all-gather(%p0), replica_groups=[32,16]<=[512], dimensions={0}
  %ar = f32[1024]{0} all-reduce(%p1), replica_groups={{0,1,2,3}}, to_apply=%add
  %rs = f32[64,32]{1,0} reduce-scatter(%p2), replica_groups=[4,4]<=[16], dimensions={0}
  %cp = s8[100]{0} collective-permute(%p3), source_target_pairs={{0,1}}
}
"""
HLO_MORE = HLO_SAMPLE + """
  %t = (f32[8,16]{1,0}, s8[4]{0}) all-gather(%a, %b), replica_groups={{0,1}}, dimensions={0}
  %s = f32[256]{0} all-reduce-start(%p4), replica_groups=[2,8]<=[16]
  %d = f32[256]{0} all-reduce-done(%s)
  %x = bf16[4,64]{1,0} all-to-all(%p5), replica_groups={{0,1,2,3}}
"""


@pytest.mark.parametrize("text", [HLO_SAMPLE, HLO_MORE])
def test_hlo_parser_bitwise(text):
    assert thlo.count_collectives(text) == jhlo.count_collectives(text)
    assert thlo.collective_bytes(text) == jhlo.collective_bytes(text)
    assert list(thlo.iter_collectives(text)) == \
        list(jhlo.iter_collectives(text))
    for s in ("bf16[2,512,128]", "pred[7]", "f64[]", "u4[3]", "nonsense"):
        assert thlo._shape_bytes(s) == jhlo._shape_bytes(s)


def test_hlo_sample_estimate_is_the_reference_tests():
    b = thlo.collective_bytes(HLO_SAMPLE)
    want = ((16 - 1) / 16 * 2 * 512 * 128 * 2 + 2 * 3 / 4 * 1024 * 4
            + 3 / 4 * 64 * 32 * 4 + 100)
    assert abs(b - want) / b < 0.01
    assert thlo.__name__ == "repro_torch.runtime.hlo"


# ---------------------------------------------------------------------------
# core: aggregation and re-exports
# ---------------------------------------------------------------------------

COUNTS = ([0, 0, 0], [3, 1, 0, 7], [5], [2, 2], [0, 4])


@pytest.mark.parametrize("counts", COUNTS)
def test_cross_tier_weights_bitwise(counts):
    want = np.asarray(jagg.cross_tier_weights(jnp.asarray(counts)))
    got = tagg.cross_tier_weights(counts)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(tagg.cross_tier_weights(
        torch.tensor(counts)).numpy(), want)
    assert np.array_equal(got.numpy(), tagg.cross_tier_weights_host(counts))


@pytest.mark.parametrize("ns", ([16., 20., 0., 0.], [1., 2., 3.], [0., 0.],
                                [7, 0, 9]))
def test_client_and_uniform_weights_bitwise(ns):
    want = np.asarray(jagg.client_weights(jnp.asarray(ns)))
    assert np.array_equal(tagg.client_weights(ns).numpy(), want)
    for m in (1, 3, 5):
        assert np.array_equal(tagg.uniform_weights(m).numpy(),
                              np.asarray(jagg.uniform_weights(m)))


def _stacked(seed, m):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((m, 3, 5)).astype(np.float32),
            "b": rng.standard_normal((m, 7)).astype(np.float32)}


@pytest.mark.parametrize("fn,weights", [
    ("intra_tier_average", [10., 20., 0., 5.]),
    ("global_model", [3, 0, 5, 1]),
    ("global_model", [0, 0, 0, 0]),
])
def test_tier_and_global_averages_match_reference(fn, weights):
    stacked = _stacked(4, len(weights))
    want = getattr(jagg, fn)({k: jnp.asarray(v) for k, v in stacked.items()},
                             jnp.asarray(weights))
    got = getattr(tagg, fn)(params_from_numpy(stacked, "cpu"), weights)
    for k in stacked:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)


def test_intra_tier_average_padding_is_exactly_neutral():
    stacked = _stacked(5, 4)
    full = tagg.intra_tier_average(params_from_numpy(stacked, "cpu"),
                                   [10., 20., 0., 5.])
    live = tagg.intra_tier_average(
        {k: torch.from_numpy(v[[0, 1, 3]]) for k, v in stacked.items()},
        [10., 20., 5.])
    assert all(torch.equal(full[k], live[k]) for k in stacked)


def test_core_and_data_reexports():
    import repro.core as jcore
    import repro.data as jdata
    for name in ("cross_tier_weights", "global_model", "intra_tier_average",
                 "uniform_weights", "weighted_average", "EngineConfig",
                 "Outcome", "ServerStrategy", "run_engine", "run_strategy",
                 "TierMap", "assign_tiers", "theory"):
        assert hasattr(jcore, name) and hasattr(tcore, name), name
    assert tcore.weighted_average is tagg.weighted_average
    assert tcore.theory.__name__ == "repro_torch.core.theory"
    assert tdata.global_test_set is tfed.global_test_set
    assert hasattr(jdata, "global_test_set")


@pytest.mark.parametrize("kwargs", [
    dict(task="image", n_clients=5, image_hw=6),
    dict(task="features", n_clients=4, n_features=16, n_classes=3),
    dict(task="tokens", n_clients=3, vocab_size=9, seq_len=5)])
def test_global_test_set_bitwise(kwargs):
    jd = jfed.make_federated(samples_per_client=30, seed=3, **kwargs)
    td = tfed.make_federated(samples_per_client=30, seed=3, **kwargs)
    for a, b in zip(jfed.global_test_set(jd), tfed.global_test_set(td)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# compress
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("n", [1, 255, 256, 700])
def test_fake_quantize_and_error_bound_bitwise(bits, n):
    x = (np.random.default_rng(n).standard_normal(n) * 3).astype(np.float32)
    x[::17] = 0.0
    shape = (n,) if n % 5 else (5, n // 5)
    x = x.reshape(shape)
    want = np.asarray(jq.fake_quantize(jnp.asarray(x), bits))
    got = tq.fake_quantize(torch.from_numpy(x), bits)
    assert got.shape == x.shape and np.array_equal(got.numpy(), want)
    eb = tq.error_bound(torch.from_numpy(x), bits).numpy()
    assert np.array_equal(eb, np.asarray(jq.error_bound(jnp.asarray(x),
                                                        bits)))
    blocks = np.pad(x.reshape(-1), (0, -n % 256)).reshape(-1, 256)
    err = np.abs(np.pad(got.numpy().reshape(-1) - x.reshape(-1),
                        (0, -n % 256))).reshape(-1, 256).max(1)
    # the codec's bound, up to one fp32 rounding of the dequantized value
    ulp = np.spacing(np.abs(blocks).max(1))
    assert (err <= eb + ulp).all() and len(eb) == len(blocks)


@pytest.mark.parametrize("precision", [2, 4, 6])
def test_polyline_scalar_references_match(precision):
    rng = np.random.default_rng(precision)
    vals = np.concatenate([rng.standard_normal(300) * 10, [0.0, -0.0, 1e-9,
                                                          -5.5, 5.5]])
    vals = vals.astype(np.float32)
    enc = tpoly.encode_values_ref(vals, precision)
    assert enc == jpoly.encode_values_ref(vals, precision)
    assert enc == tpoly.encode_values(vals, precision)
    dec = tpoly.decode_values_ref(enc, precision)
    assert np.array_equal(dec, jpoly.decode_values_ref(enc, precision))
    assert np.array_equal(dec, tpoly.decode_values(enc, precision))
    assert tpoly.encode_values_ref(np.zeros(0), precision) == ""


def test_polyline_roundtrip_error_matches_reference():
    rng = np.random.default_rng(9)
    tree = {"w": rng.standard_normal((4, 6)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}
    for precision in (3, 4):
        want = jpoly.roundtrip_error({k: jnp.asarray(v)
                                      for k, v in tree.items()}, precision)
        assert tpoly.roundtrip_error(tree, precision) == want
        assert tpoly.roundtrip_error(params_from_numpy(tree, "cpu"),
                                     precision) == want
        assert want <= 0.5 * 10 ** -precision + 1e-6


@pytest.mark.parametrize("spec", ["quantize8", "quantize16", "quantize:16",
                                  "polyline:4", "none"])
def test_cross_tier_bits_matches_reference(spec):
    try:
        want = jtr.cross_tier_bits(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            ttr.cross_tier_bits(spec)
        assert str(got.value) == str(e)
        return
    assert ttr.cross_tier_bits(spec) == want
    assert ttr.cross_tier_bits(ttr.get_codec(spec)) == want


# ---------------------------------------------------------------------------
# models: cnn and common
# ---------------------------------------------------------------------------

def _close(got, want, rtol=FP32_RTOL):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    err = float(np.abs(got - want).max())
    assert err <= rtol * max(1.0, float(np.abs(want).max())), err


@pytest.mark.parametrize("kind,kw,xshape", [
    ("logreg", dict(n_features=12, n_classes=3), (9, 12)),
    ("cnn", dict(in_shape=(8, 8, 3), n_classes=10), (6, 8, 8, 3)),
])
def test_make_model_loss_and_accuracy_match_reference(kind, kw, xshape):
    jp, japply = jcnn.make_model(kind, jax.random.PRNGKey(0), **kw)
    tp0, tapply = tcnn.make_model(kind, torch.Generator().manual_seed(0),
                                  **kw)
    assert {k: tuple(v.shape) for k, v in tp0.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(1)
    x = rng.standard_normal(xshape).astype(np.float32)
    y = rng.integers(0, kw["n_classes"], xshape[0]).astype(np.int32)
    _close(tapply(tp, torch.from_numpy(x)), japply(jp, jnp.asarray(x)))
    batch = {"x": x, "y": y}
    _close(tcnn.ce_loss(tapply, tp, {k: torch.from_numpy(v)
                                     for k, v in batch.items()}),
           jcnn.ce_loss(japply, jp, {k: jnp.asarray(v)
                                     for k, v in batch.items()}))
    assert float(tcnn.accuracy(tapply, tp, torch.from_numpy(x),
                               torch.from_numpy(y))) == \
        float(jcnn.accuracy(japply, jp, jnp.asarray(x), jnp.asarray(y)))
    with pytest.raises(ValueError):
        tcnn.make_model("mlp", torch.Generator())


def test_logreg_apply_is_the_clients_form_unbatched():
    """The same function (a 2-D product, not a batched one: last-bit
    differences)."""
    rng = np.random.default_rng(2)
    p = {"w": torch.from_numpy(rng.standard_normal((5, 2)).astype(
        np.float32)), "b": torch.from_numpy(rng.standard_normal(2).astype(
            np.float32))}
    x = torch.from_numpy(rng.standard_normal((4, 5)).astype(np.float32))
    many = tcnn.logreg_apply_clients({k: v[None] for k, v in p.items()},
                                     x[None])[0]
    _close(tcnn.logreg_apply(p, x), many.numpy())


@pytest.mark.parametrize("arch", ["qwen2-7b", "granite-moe-3b-a800m",
                                  "deepseek-moe-16b", "paligemma-3b",
                                  "hubert-xlarge", "rwkv6-3b", "zamba2-2.7b"])
@pytest.mark.parametrize("bytes_per_el", [2, 4])
def test_param_bytes_matches_reference(arch, bytes_per_el):
    want = jcommon.param_bytes(jlm.param_specs(jsmoke(arch), 1),
                               bytes_per_el)
    assert tcommon.param_bytes(tlm.param_specs(tsmoke(arch), 1),
                               bytes_per_el) == want


@pytest.mark.parametrize("masked,vocab", [(False, None), (True, None),
                                          (True, 50), (False, 60)])
def test_softmax_cross_entropy_matches_reference(masked, vocab):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 7, 64)).astype(np.float32) * 4
    labels = rng.integers(0, vocab or 64, (3, 7)).astype(np.int32)
    mask = rng.random((3, 7)) < 0.6 if masked else None
    want = jcommon.softmax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask), vocab)
    got = tcommon.softmax_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask), vocab)
    _close(got, want)


# ---------------------------------------------------------------------------
# core/simulation.py SimEnv views
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def envs():
    kw = dict(n_clients=8, n_tiers=2, samples_per_client=20, image_hw=8,
              clients_per_round=3, n_unstable=3)
    return JSimEnv(JSimConfig(**kw)), TSimEnv(TSimConfig(**kw), device="cpu")


def test_simenv_dropout_time_client_batch_and_n_samples(envs):
    jenv, tenv = envs
    assert tenv.dropout_time == jenv.dropout_time
    assert len(tenv.dropout_time) == 3
    ids = np.array([5, 0, 3])
    jb, tb = jenv.client_batch(ids), tenv.client_batch(ids)
    assert sorted(tb) == sorted(jb) == ["mask", "x", "y"]
    for k in jb:
        want = np.asarray(jb[k])
        assert tb[k].device.type == "cpu"
        assert np.array_equal(tb[k].numpy().astype(want.dtype), want), k
    assert np.array_equal(tenv.n_samples(ids).numpy(),
                          np.asarray(jenv.n_samples(ids)))
