"""Training the dense LM in the port against the JAX reference: the
seq-chunked causal-LM loss and its gradients (models/transformer.py
``loss_fn``), remat, the token pipeline, and two single-pod train steps
(core/steps.py) with gradient accumulation, AdamW and the cosine
schedule.  The port starts from the reference's params
(``lm.init_params(PRNGKey(0))``, carried over with models/convert.py) and
takes the same numpy token batches.

Tolerances (fp32): the loss within 2e-6 relative and each gradient leaf
within 1e-4 of its max |value| (the backward sums in another order than
XLA's autodiff, through two layers, RoPE and the chunked head); after two
AdamW steps the params within 2e-5 of each leaf's max |value| plus 1e-3
lr absolute (AdamW divides by sqrt(v), so an ulp of a tiny gradient moves
its weight by a share of lr; the biases start at zero, so their max is
about lr), loss and grad_norm within 1e-5 relative.  Measured on the CPU:
9.2e-6 relative on the weight leaves, 1.6e-8 absolute on the biases.
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
from repro.models import lm as jlm
from repro.runtime import sharding as shd
from repro_torch.configs.base import TrainConfig as TTrainConfig
from repro_torch.configs.registry import get_smoke_config as tsmoke
from repro_torch.configs.shapes import ShapeConfig as TShape
from repro_torch.core import steps as tsteps
from repro_torch.data.pipeline import TokenPipeline as TPipe
from repro_torch.models import lm as tlm
from repro_torch.models.common import unflatten_tree
from repro_torch.models.convert import params_from_numpy

torch.set_num_threads(1)

ARCHS = ["qwen2-7b", "h2o-danube-3-4b"]
LOSS_RTOL = 2e-6
GRAD_RTOL = 1e-4


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _leaves(tree):
    if isinstance(tree, dict):
        return [(k + "/" + p if p else k, x) for k in sorted(tree)
                for p, x in _leaves(tree[k])]
    return [("", tree)]


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_reference(arch, remat):
    jc = jsmoke(arch).replace(remat=remat)
    tc = tsmoke(arch).replace(remat=remat)
    jp = jlm.init_params(jc, jax.random.PRNGKey(0), 1, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    toks = _tokens(jc, 2, 128)

    (jl, jm), jg = jax.value_and_grad(
        lambda p: jlm.loss_fn(jc, p, {"tokens": jnp.asarray(toks)}, 1),
        has_aux=True)(jp)
    leaves = {k: v.requires_grad_(True) for k, v in _leaves(tp)}
    tl, tm = tlm.loss_fn(tc, unflatten_tree(leaves),
                         {"tokens": torch.from_numpy(toks)}, 1)
    tg = torch.autograd.grad(tl, list(leaves.values()))

    assert abs(float(tl.detach()) - float(jl)) <= LOSS_RTOL * abs(float(jl))
    assert abs(float(tm["ce_loss"]) - float(jm["ce_loss"])) <= \
        LOSS_RTOL * abs(float(jm["ce_loss"]))
    jgl = dict(_leaves(jg))
    assert sorted(jgl) == sorted(leaves)
    for (path, _), g in zip(leaves.items(), tg):
        want = np.asarray(jgl[path])
        err = float(np.abs(_np(g) - want).max())
        assert err <= GRAD_RTOL * max(float(np.abs(want).max()), 1e-8), path


def test_remat_recomputes_the_same_gradients():
    cfg = tsmoke("qwen2-7b")
    params = tlm.init_params(cfg, 0, device="cpu")
    toks = {"tokens": torch.from_numpy(_tokens(cfg, 2, 64))}
    out = []
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in _leaves(params)}
        loss, _ = tlm.loss_fn(c, unflatten_tree(leaves), toks, 1)
        out.append((loss, torch.autograd.grad(loss, list(leaves.values()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_recurrent_families_still_raise_for_training():
    """They raised naming ROADMAP A17 until A17 was ported (the name is
    kept); now lm.loss_fn trains them, with the dense families' metrics
    (tests/test_torch_recurrent_train.py holds them to the reference)."""
    for arch in ("rwkv6-3b", "zamba2-2.7b"):
        cfg = tsmoke(arch)
        params = tlm.init_params(cfg, 0, device="cpu")
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in _leaves(params)}
        loss, metrics = tlm.loss_fn(cfg, unflatten_tree(leaves), {
            "tokens": torch.from_numpy(_tokens(cfg, 2, 32))}, 1)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        assert bool(torch.isfinite(loss)) and sorted(metrics) == [
            "aux_loss", "ce_loss"]
        assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("arch", ["qwen2-7b", "rwkv6-3b"])
@pytest.mark.parametrize("step", [0, 3])
def test_token_pipeline_batches_bitwise(arch, step):
    shape = (8, 32)
    jb = JPipe(jsmoke(arch), JShape("s", shape[1], shape[0], "train"),
               seed=5).batch(step)
    tb = TPipe(tsmoke(arch), TShape("s", shape[1], shape[0], "train"),
               seed=5).batch(step)
    assert sorted(jb) == sorted(tb)
    for k in jb:
        assert jb[k].dtype == tb[k].dtype
        assert np.array_equal(jb[k], tb[k])


def test_single_pod_steps_match_reference():
    """Two steps, microbatch 2, of make_single_pod_step from the
    reference's params0 and the reference's batches."""
    jc = jsmoke("qwen2-7b").replace(microbatch=2)
    tc = tsmoke("qwen2-7b").replace(microbatch=2)
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
        assert tf.state_shardings is None and tf.batch_shardings is None
        pipe = JPipe(jc, JShape("s", 64, 4, "train"), seed=0)
        for i in range(2):
            batch = pipe.batch(i)
            jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
            tstate, tm = tf.train_step(tstate, batch)
            for key in ("loss", "grad_norm", "lr_scale"):
                want = float(jm[key])
                assert abs(float(tm[key]) - want) <= 1e-5 * abs(want), key
    assert int(tstate["step"]) == int(jstate["step"]) == 2
    assert int(tstate["opt"]["count"]) == 2
    lr = kw["lr"]
    for (path, got), (_, want) in zip(_leaves(tstate["params"]),
                                      _leaves(jstate["params"])):
        want = np.asarray(want)
        err = float(np.abs(_np(got) - want).max())
        assert err <= 2e-5 * float(np.abs(want).max()) + 1e-3 * lr, path


def test_init_state_draws_on_the_device():
    tc = tsmoke("qwen2-7b")
    fns = tsteps.make_single_pod_step(tc, TTrainConfig(), device="cpu")
    a, b = fns.init_state(0), fns.init_state(0)
    assert int(a["step"]) == 0 and int(a["opt"]["count"]) == 0
    for (_, x), (_, y) in zip(_leaves(a["params"]), _leaves(b["params"])):
        assert torch.equal(x, y) and x.dtype == torch.float32


@pytest.mark.parametrize("name", ["make_fedat_step", "split_batch_for_pods",
                                  "poison_updates", "gate_updates",
                                  "UpdateGate"])
def test_unported_steps_raise(name):
    """The multi-pod step and its batch split raised naming A16 before
    A16 was ported (the ids are kept); each now takes the reference's
    parameters (the multi-pod step one more, ``device``), as the fault
    plane's update gate (A12) does.  tests/test_torch_steps_multipod.py
    and tests/test_torch_faults.py hold their results to the
    reference's."""
    import inspect
    from repro.core import steps as jsteps
    got = list(inspect.signature(getattr(tsteps, name)).parameters)
    want = list(inspect.signature(getattr(jsteps, name)).parameters)
    if name == "make_fedat_step":
        assert got == want + ["device"]
        return
    assert got == want
