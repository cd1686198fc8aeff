"""The port's models, client update, aggregation and data plane against
the JAX reference, from the same numpy inputs and the reference's own
``params0`` (converted with repro_torch.models.convert).

Tolerances: forward passes and losses are fp32 products summed in another
order than XLA's, so they agree to ~1e-6 relative; a client update runs
many Adam steps, and Adam's first step maps a near-zero gradient to
+-lr whatever its rounding, so updates are compared by the relative L2
norm of their difference to how far the update moved the weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core.clients import make_client_update as jmake_update
from repro.core.simulation import SimConfig as JSimConfig
from repro.core.simulation import SimEnv as JSimEnv
from repro.data import federated as jfed
from repro.models import registry as jreg
from repro_torch.core import aggregation as tagg
from repro_torch.core.clients import make_client_update as tmake_update
from repro_torch.data import federated as tfed
from repro_torch.models import cnn as tcnn
from repro_torch.models import registry as treg
from repro_torch.models.convert import params_from_numpy, params_to_numpy

torch.set_num_threads(1)

FP32_RTOL = 2e-5      # fp32 sums in another order (logits, losses)
UPDATE_RTOL = 1e-3    # |port - ref| / |ref - start| after local training


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _bind(name, **dims):
    return (jreg.build_model(name, jreg.DataDims(**dims)),
            treg.build_model(name, treg.DataDims(**dims)))


CASES = [("cnn", dict(n_classes=10, image_hw=8)),
         ("cnn", dict(n_classes=10, image_hw=16)),
         ("cnn", dict(n_classes=3, image_hw=12)),
         ("logreg", dict(n_classes=2, n_features=32))]


@pytest.mark.parametrize("name,dims", CASES)
def test_forward_loss_accuracy_match_reference(name, dims):
    jm, tm = _bind(name, **dims)
    p0 = _np(jm.init_params(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(0)
    K, B = 3, 7
    x = rng.standard_normal((K, B) + jm.batch_shape).astype(np.float32)
    y = rng.integers(0, dims["n_classes"], (K, B)).astype(np.int32)
    mask = (rng.random((K, B)) < 0.8)
    # the port runs K clients with their own params in one batched pass
    pk = {k: np.stack([v * (1 + 0.05 * i) for i in range(K)])
          for k, v in p0.items()}
    tp = params_from_numpy(pk, "cpu")
    logits = tm.apply(tp, torch.from_numpy(x)).numpy()
    loss = tm.loss(tp, torch.from_numpy(x), torch.from_numpy(y).long(),
                   torch.from_numpy(mask).float()).numpy()
    acc = tm.eval_metrics(tp, torch.from_numpy(x), torch.from_numpy(y).long(),
                          torch.from_numpy(mask).float()).numpy()
    for i in range(K):
        pi = {k: jnp.asarray(v[i]) for k, v in pk.items()}
        jl = np.asarray(jm.apply(pi, jnp.asarray(x[i])))
        np.testing.assert_allclose(logits[i], jl, rtol=FP32_RTOL, atol=1e-5)
        np.testing.assert_allclose(
            loss[i], float(jm.loss(pi, x[i], y[i], mask[i])),
            rtol=FP32_RTOL)
        assert acc[i] == pytest.approx(
            float(jm.eval_metrics(pi, x[i], y[i], mask[i])), abs=1e-6)


@pytest.mark.parametrize("name,dims", CASES)
def test_init_layout_matches_reference(name, dims):
    jm, tm = _bind(name, **dims)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = tm.init_params(torch.Generator().manual_seed(0))
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == jp[k].shape
        assert tp[k].dtype == torch.float32
    if name == "cnn":   # He-normal: std sqrt(2 / fan_in)
        w = tp["c3_w"]
        assert float(w.std()) == pytest.approx((2 / (9 * 64)) ** 0.5,
                                               rel=0.05)


def test_unbatched_apply_and_convert_roundtrip():
    jm, _ = _bind("cnn", n_classes=10, image_hw=8)
    p0 = _np(jm.init_params(jax.random.PRNGKey(2)))
    tp = params_from_numpy(p0, "cpu")
    back = params_to_numpy(tp)
    assert all(np.array_equal(back[k], p0[k]) for k in p0)
    x = np.random.default_rng(1).standard_normal((5, 8, 8, 3)).astype(
        np.float32)
    np.testing.assert_allclose(
        tcnn.cnn_apply(tp, torch.from_numpy(x)).numpy(),
        np.asarray(jm.apply(p0, x)), rtol=FP32_RTOL, atol=1e-5)


@pytest.fixture(scope="module")
def small_env():
    return JSimEnv(JSimConfig(n_clients=6, n_tiers=2, samples_per_client=25,
                              image_hw=8, clients_per_round=3,
                              local_epochs=2, n_unstable=1))


def _jax_perms(keys, E, cap):
    return np.stack([np.stack([np.asarray(jax.random.permutation(r, cap))
                               for r in jax.random.split(k, E)])
                     for k in keys]).astype(np.int64)


@pytest.mark.parametrize("prox", [0.4, 0.0])
def test_client_update_matches_reference(small_env, prox):
    env = small_env
    sc = env.sc
    ids = np.array([0, 2, 5])
    keys = jax.random.split(jax.random.PRNGKey(123), len(ids))
    batch = {k: env.train[k][ids] for k in ("x", "y", "mask")}
    jupd = jmake_update(env.model, local_epochs=sc.local_epochs,
                        batch_size=sc.batch_size, lr=sc.lr,
                        prox_lambda=prox)
    jp, _ = jupd(env.params0, {k: jnp.asarray(v) for k, v in batch.items()},
                 keys)
    tm = treg.build_model("cnn", treg.DataDims(n_classes=10, image_hw=8))
    tupd = tmake_update(tm, local_epochs=sc.local_epochs,
                        batch_size=sc.batch_size, lr=sc.lr, prox_lambda=prox)
    cap = batch["y"].shape[1]
    perms = torch.from_numpy(_jax_perms(keys, sc.local_epochs, cap))
    tbatch = {"x": torch.from_numpy(batch["x"]),
              "y": torch.from_numpy(batch["y"]).long(),
              "mask": torch.from_numpy(batch["mask"]).float()}
    tp, loss = tupd(params_from_numpy(_np(env.params0), "cpu"), tbatch,
                    perms)
    assert loss.shape == (3,) and bool(torch.isfinite(loss).all())
    for k in env.params0:
        ref = np.asarray(jp[k])
        start = np.stack([np.asarray(env.params0[k])] * 3)
        moved = np.linalg.norm(ref - start)
        assert moved > 0
        assert np.linalg.norm(tp[k].numpy() - ref) / moved < UPDATE_RTOL, k


def test_aggregation_weight_twins_are_bitwise():
    for counts in ([0, 0, 0], [3, 1, 0, 7], [5], [2, 2]):
        assert np.array_equal(tagg.cross_tier_weights_host(counts),
                              jagg.cross_tier_weights_host(counts))
    for ns in ([16., 20., 0., 0.], [1., 2., 3.], [0., 0.]):
        assert np.array_equal(tagg.client_weights_host(ns),
                              jagg.client_weights_host(ns))
    assert np.array_equal(tagg.uniform_weights_host(5),
                          jagg.uniform_weights_host(5))


def test_weighted_average_matches_reference():
    rng = np.random.default_rng(4)
    stacked = {"a": rng.standard_normal((4, 3, 5)).astype(np.float32),
               "b": rng.standard_normal((4, 7)).astype(np.float32)}
    w = tagg.client_weights_host([10., 20., 0., 5.])
    ref = jagg.weighted_average({k: jnp.asarray(v)
                                 for k, v in stacked.items()},
                                jnp.asarray(w))
    out = tagg.weighted_average(params_from_numpy(stacked, "cpu"),
                                torch.from_numpy(w))
    for k in stacked:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6, atol=1e-7)
    # an exactly-zero weight leaves the average bitwise unchanged
    live = tagg.weighted_average(
        {k: torch.from_numpy(v[[0, 1, 3]]) for k, v in stacked.items()},
        torch.from_numpy(w[[0, 1, 3]]))
    assert all(torch.equal(live[k], out[k]) for k in stacked)


@pytest.mark.parametrize("kwargs", [
    dict(task="image", n_clients=5, image_hw=6),
    dict(task="features", n_clients=4, n_features=16, n_classes=3),
    dict(task="text", n_clients=3, n_features=8),
    dict(task="image", n_clients=4, image_hw=4, partitioner="dirichlet:0.3"),
    dict(task="image", n_clients=4, image_hw=4, classes_per_client=10),
    dict(task="tokens", n_clients=4, vocab_size=20, seq_len=8),
    dict(task="tokens", n_clients=3, vocab_size=9, seq_len=5,
         partitioner="dirichlet:0.3")])
def test_federated_data_bitwise(kwargs):
    jd = jfed.make_federated(samples_per_client=30, seed=3, **kwargs)
    td = tfed.make_federated(samples_per_client=30, seed=3, **kwargs)
    assert td.input_shape == jd.input_shape
    js, ts = jfed.pad_stack(jd), tfed.pad_stack(td)
    for k in js:
        assert js[k].dtype == ts[k].dtype and np.array_equal(js[k], ts[k])
    for a, b in zip(jd.clients, td.clients):
        assert np.array_equal(a.x_test, b.x_test)
        assert np.array_equal(a.y_test, b.y_test)
