"""The federated LM (``tiny_lm`` / ``tiny_lm_long``) in the port against
the JAX reference: the ``tokens`` partitions, the model's logits, loss and
accuracy on client-stacked params, and short FedAT runs from the
reference's ``params0`` with its own permutations.

The port flattens the LM's nested param tree at the model's boundary
(keys ``layers/attn/wq``...), in the reference's leaf order; the
reference's trees are flattened the same way to compare.  Host-side state
(partitions, event trace, byte ledger) must match bitwise.

Tolerances: logits and losses within 2e-5 of max(1, max |reference|)
(fp32 products summed in another order).  FedAT after 4 updates,
relative L2 of the global model against the reference's (RTOL): measured
on the CPU beside the reference's own spread (the reference against
itself from a params0 changed by 1e-7 relative, about one ulp, over the
same 4 updates): ``none`` 3.8e-7 (reference 1.4e-7), bound 1e-5;
``quantize8`` 6.8e-8 (reference 1.6e-6), bound 1e-3, as in
test_torch_engine.py: a value within rounding noise of a code boundary
can land on the neighbouring code, which moves its block by
max|block|/127.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import strategies as jstrategies
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.engine import run_engine as jrun_engine
from repro.core.simulation import SimConfig as JSimConfig
from repro.core.simulation import SimEnv as JSimEnv
from repro.data.federated import make_federated as jmake
from repro.models import registry as jregistry
from repro_torch import api as tapi
from repro_torch.api import cli as tcli
from repro_torch.core import strategies as tstrategies
from repro_torch.core.engine import EngineConfig as TEngineConfig
from repro_torch.core.engine import run_engine as trun_engine
from repro_torch.core.simulation import SimConfig as TSimConfig
from repro_torch.core.simulation import SimEnv as TSimEnv
from repro_torch.data.federated import make_federated as tmake
from repro_torch.models import registry as tregistry
from repro_torch.models.common import flatten_tree

from test_torch_engine import _logged, _rel, jax_perm_source

torch.set_num_threads(1)

SCENARIO = dict(model="tiny_lm", n_clients=12, n_tiers=3,
                samples_per_client=24, classes_per_client=2,
                clients_per_round=4, local_epochs=1, n_unstable=2,
                vocab_size=64, seq_len=16,
                delay_bands=((0.0, 0.0), (0.0, 0.5), (0.5, 1.0)))
RTOL = {"none": 1e-5, "quantize8": 1e-3}
LOGIT_RTOL = 2e-5
ACC_TOL = 0.02 + 1e-9


@pytest.fixture(scope="module")
def envs():
    jenv = JSimEnv(JSimConfig(**SCENARIO))
    p0 = jax.tree.map(np.asarray, jenv.params0)
    tenv = TSimEnv(TSimConfig(**SCENARIO), device="cpu", params0=p0)
    tenv.executor().perm_source = jax_perm_source(tenv)
    return jenv, tenv


def _flat(tree):
    flat = flatten_tree(tree)
    return np.concatenate([
        (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)).ravel()
        for _, v in sorted(flat.items())])


@pytest.mark.parametrize("partitioner", ["#class", "dirichlet:0.5"])
def test_token_partitions_bitwise(partitioner):
    kw = dict(task="tokens", n_clients=6, n_classes=5, classes_per_client=2,
              samples_per_client=30, seed=3, partitioner=partitioner,
              vocab_size=50, seq_len=12)
    a, b = jmake(**kw), tmake(**kw)
    assert a.input_shape == b.input_shape == (12,)
    assert a.input_dtype == b.input_dtype == np.int32
    for ca, cb in zip(a.clients, b.clients):
        for f in ("x_train", "y_train", "x_test", "y_test"):
            assert np.array_equal(getattr(ca, f), getattr(cb, f))


def test_environment_matches_reference(envs):
    jenv, tenv = envs
    for k in ("x", "y", "mask", "n_samples"):
        assert np.array_equal(jenv.train[k], tenv.train[k])
    assert tenv.train_dev["x"].dtype == torch.int32
    assert sorted(tenv.params0) == sorted(flatten_tree(jenv.params0))
    assert jenv.model_bytes == tenv.model_bytes


@pytest.mark.parametrize("name", ["tiny_lm", "tiny_lm_long"])
@pytest.mark.parametrize("backend", ["auto", "flash", "reference"])
def test_model_matches_reference(name, backend):
    dims = dict(vocab_size=64, seq_len=32, attention_backend=backend)
    jm = jregistry.build_model(name, jregistry.DataDims(**dims))
    tm = tregistry.build_model(name, tregistry.DataDims(**dims))
    assert tm.data_kind == "tokens" and tm.batch_shape == (32,)
    assert tm.config.attention_backend == backend
    K, B = 3, 5
    rng = np.random.default_rng(0)
    keys = jax.random.split(jax.random.PRNGKey(1), K)
    jp = jax.vmap(jm.init_params)(keys)                 # (K, ...) leaves
    tp = {k: torch.from_numpy(np.array(v))
          for k, v in flatten_tree(jax.tree.map(np.asarray, jp)).items()}
    x = rng.integers(0, 64, (K, B, 32)).astype(np.int32)
    y = np.zeros((K, B), np.int32)
    mask = (rng.random((K, B)) < 0.7).astype(np.float32)
    mask[:, 0] = 1.0
    jl = np.asarray(jax.vmap(jm.apply)(jp, x))
    tl = tm.apply(tp, torch.from_numpy(x)).detach().numpy()
    bound = LOGIT_RTOL * max(1.0, float(np.abs(jl).max()))
    assert tl.shape == jl.shape and float(np.abs(tl - jl).max()) <= bound
    args = (torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask))
    jloss = np.asarray(jax.vmap(jm.loss)(jp, x, y, mask))
    tloss = tm.loss(tp, *args).detach().numpy()
    assert np.abs(tloss - jloss).max() <= LOGIT_RTOL * max(
        1.0, float(np.abs(jloss).max()))
    jacc = np.asarray(jax.vmap(jm.eval_metrics)(jp, x, y, mask))
    tacc = tm.eval_metrics(tp, *args).numpy()
    assert np.abs(tacc - jacc).max() <= 1e-6


@pytest.mark.parametrize("codec", ["none", "quantize8"])
def test_fedat_run_matches_reference(envs, codec):
    jenv, tenv = envs
    jlog = _logged(jenv, "fedat_round")
    tlog = _logged(tenv, "fedat_round")
    try:
        js = jstrategies.make_strategy("fedat", codec=codec)
        ts = tstrategies.make_strategy("fedat", codec=codec)
        jm = jrun_engine(jenv, js, JEngineConfig(total_updates=4,
                                                 eval_every=2))
        tm = trun_engine(tenv, ts, TEngineConfig(total_updates=4,
                                                 eval_every=2))
    finally:
        del jenv.executor().fedat_round, tenv.executor().fedat_round
    assert tlog == jlog and len(tlog) == 4
    assert tm.times == jm.times and tm.rounds == jm.rounds
    assert tm.bytes_up == jm.bytes_up and tm.bytes_down == jm.bytes_down
    assert all(abs(a - b) <= ACC_TOL for a, b in zip(tm.acc, jm.acc))
    w0 = _flat(jax.tree.map(np.asarray, jenv.params0))
    jw, tw = _flat(js.w_global), _flat(ts.w_global)
    assert np.linalg.norm(jw - w0) > 0
    assert _rel(tw, jw) < RTOL[codec]


def test_api_and_cli_run_tiny_lm_long_on_cpu(tmp_path):
    spec = tapi.ExperimentSpec(
        data=tapi.DataSpec(model="tiny_lm_long", n_clients=6,
                           samples_per_client=20, seq_len=32,
                           attention_backend="flash", seed=1),
        tiers=tapi.TierSpec(n_tiers=2, clients_per_round=2, n_unstable=1),
        engine=tapi.EngineSpec(total_updates=2, eval_every=1,
                               local_epochs=1))
    res = tapi.build(spec, device="cpu").run()
    assert res.metrics.rounds[-1] >= 2 and all(np.isfinite(res.metrics.acc))
    out = tmp_path / "r.json"
    rows = tcli.main(["--device", "cpu", "--set", "data.model=tiny_lm",
                      "--set", "data.n_clients=6", "--set",
                      "data.samples_per_client=20", "--set",
                      "tiers.n_tiers=2", "--set", "tiers.clients_per_round=2",
                      "--set", "tiers.n_unstable=1", "--set",
                      "engine.total_updates=2", "--set",
                      "engine.eval_every=1", "--out", str(out)])
    assert len(rows) == 1 and out.exists()
