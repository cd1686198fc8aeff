"""Serving a federated checkpoint with the port (serve/loader.py, the
CLI's ``serve`` subcommand): a ``tiny_lm`` checkpoint written by the
port's ``Run.run`` and one written by the reference's, loaded by the
port on the CPU, give the reference engine's tokens on the same
requests; every sidecar error is the reference's, word for word."""
import json
import os
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import serve as jserve
from repro.models import registry as jregistry
from repro_torch import api as tapi
from repro_torch import serve as tserve
from repro_torch.api import cli as tcli
from repro_torch.models.common import flatten_tree
from repro_torch.models.convert import params_to_numpy

torch.set_num_threads(1)

LM = {"data.model": "tiny_lm", "data.n_clients": 8, "tiers.n_tiers": 2,
      "tiers.n_unstable": 0, "tiers.clients_per_round": 2,
      "engine.total_updates": 2, "engine.eval_every": 2,
      "engine.local_epochs": 1, "data.samples_per_client": 20}
SERVE = dict(slots=3, max_len=40, prefill_len=8, max_new=6)


def _spec(api, **extra):
    return api.ExperimentSpec().with_overrides(dict(LM, **extra))


def _reference_tokens(params_np, cfg_spec, n=5, seed=2):
    """The reference engine's (rid, tokens, truncated) on ``n`` requests,
    from ``params_np`` (the LM tree as numpy)."""
    d = cfg_spec.data
    model = jregistry.build_model(d.model, jregistry.DataDims(
        vocab_size=d.vocab_size, seq_len=d.seq_len,
        attention_backend=d.attention_backend))
    reqs = jserve.make_requests(n, 0.0, SERVE["prefill_len"],
                                SERVE["max_new"], model.config.vocab_size,
                                seed)
    done = jserve.ServeEngine(model.config,
                              jax.tree.map(np.asarray, params_np),
                              jserve.ServeSpec(**SERVE)).run(reqs)
    return [(r.rid, r.out, r.truncated) for r in done], reqs


def _port_tokens(loaded, reqs):
    done = tserve.ServeEngine(loaded.config, loaded.lm_params,
                              tserve.ServeSpec(**SERVE)).run(
        [tserve.ServeRequest(r.rid, r.prompt.copy(), r.max_new, r.arrival)
         for r in reqs])
    return [(r.rid, r.out, r.truncated) for r in done]


@pytest.fixture(scope="module")
def port_ckpt(tmp_path_factory):
    """A tiny_lm FedAT run of the port, checkpointed by ``Run.run``."""
    d = str(tmp_path_factory.mktemp("port_ckpt"))
    spec = _spec(tapi)
    run = tapi.build(spec, device="cpu")
    run.run(checkpoint_dir=d)
    return d, spec, run.strategy.global_params()


@pytest.fixture(scope="module")
def ref_ckpt(tmp_path_factory):
    """The same scenario run and checkpointed by the reference."""
    d = str(tmp_path_factory.mktemp("ref_ckpt"))
    spec = _spec(japi)
    japi.build(spec).run(checkpoint_dir=d)
    return d, spec


def test_port_checkpoint_serves_the_reference_tokens(port_ckpt):
    d, spec, w_final = port_ckpt
    loaded = tserve.load_checkpoint(d, expect_spec=spec, device="cpu")
    assert isinstance(loaded, tserve.LoadedCheckpoint)
    assert loaded.spec_hash == spec.hash() == tapi.ExperimentSpec.from_dict(
        json.loads(Path(d, "spec.json").read_text())["spec"]).hash()
    assert loaded.step == LM["engine.total_updates"]
    # the final global model, bitwise, on the asked device, nested like
    # the LM facade's tree
    flat = flatten_tree(loaded.lm_params)
    assert sorted(flat) == sorted(w_final)
    assert all(torch.equal(flat[k], w_final[k]) and
               flat[k].device.type == "cpu" for k in flat)
    want, reqs = _reference_tokens(params_to_numpy(loaded.lm_params), spec)
    assert _port_tokens(loaded, reqs) == want
    # the same through serve_from_checkpoint
    _, done = tserve.serve_from_checkpoint(
        d, tserve.ServeSpec(**SERVE),
        [tserve.ServeRequest(r.rid, r.prompt.copy(), r.max_new, r.arrival)
         for r in reqs], device="cpu")
    assert [(r.rid, r.out, r.truncated) for r in done] == want


def test_reference_checkpoint_serves_the_reference_tokens(ref_ckpt):
    d, jspec = ref_ckpt
    jl = jserve.load_checkpoint(d)
    tl = tserve.load_checkpoint(d, device="cpu")
    assert tl.spec_hash == jl.spec_hash and tl.step == jl.step
    for k, v in flatten_tree(jax.tree.map(np.asarray, jl.params)).items():
        assert np.array_equal(flatten_tree(tl.lm_params)[k].numpy(), v)
    want, reqs = _reference_tokens(jl.params, jspec)
    assert _port_tokens(tl, reqs) == want


@pytest.mark.parametrize("which", ["port", "reference"])
def test_cli_serve_on_the_cpu(which, port_ckpt, ref_ckpt, tmp_path, capsys):
    d = port_ckpt[0] if which == "port" else ref_ckpt[0]
    out = tmp_path / "rep.json"
    tcli.main(["serve", "--resume-from", d, "--device", "cpu",
               "--requests", "5", "--slots", str(SERVE["slots"]),
               "--prompt-len", str(SERVE["prefill_len"]),
               "--max-new", str(SERVE["max_new"]),
               "--max-len", str(SERVE["max_len"]), "--seed", "2",
               "--out", str(out)])
    rep = json.loads(out.read_text())
    assert "serving tiny_lm @ spec" in capsys.readouterr().out
    assert rep["requests"] == 5 and rep["device"] == "cpu"
    assert rep["spec_hash"] == _spec(tapi).hash()
    assert rep["shapes"] == {"prefill": 1, "decode": 1, "reset": 1}
    jl = jserve.load_checkpoint(d)
    want, _ = _reference_tokens(jl.params, _spec(japi))
    assert {int(k): v for k, v in rep["tokens"].items()} == \
        {rid: out for rid, out, _ in want}


def _both_errors(fn_dir, **kw):
    """The (reference, port) SpecError messages of loading ``fn_dir``."""
    msgs = []
    for load, extra in ((jserve.load_checkpoint, {}),
                        (tserve.load_checkpoint, {"device": "cpu"})):
        with pytest.raises(Exception) as e:
            load(fn_dir, **dict(kw, **extra))
        msgs.append((type(e.value).__name__, str(e.value)))
    return msgs


def test_sidecar_errors_match_the_reference(ref_ckpt, tmp_path):
    d, jspec = ref_ckpt
    # missing directory / sidecar
    a, b = _both_errors(str(tmp_path / "nope"))
    assert a == b and "no spec.json" in b[1]
    # a wrong spec hash asked for
    other = jspec.with_overrides({"engine.lr": 0.123})
    a, b = _both_errors(d, expect_spec=other)
    assert a[1] == b[1] and "was written by spec" in b[1]
    assert b[0] == "SpecError"
    # a hand-edited sidecar: its hash no longer matches its own spec doc
    edited = str(tmp_path / "edited")
    shutil.copytree(d, edited)
    side = os.path.join(edited, "spec.json")
    doc = json.loads(Path(side).read_text())
    doc["spec_hash"] = "0" * 12
    Path(side).write_text(json.dumps(doc))
    a, b = _both_errors(edited)
    assert a[1] == b[1] and "self-inconsistent" in b[1]
    # no embedded spec document
    del doc["spec"]
    Path(side).write_text(json.dumps(doc))
    a, b = _both_errors(edited)
    assert a[1] == b[1] and "no embedded spec" in b[1]
    # a model with no decode path
    cnn = str(tmp_path / "cnn")
    spec = japi.ExperimentSpec().with_overrides({
        "data.model": "cnn", "data.n_clients": 8, "tiers.n_tiers": 2,
        "tiers.n_unstable": 0, "tiers.clients_per_round": 2})
    model = jregistry.build_model("cnn", jregistry.DataDims())
    japi.save_checkpoint(cnn, spec, model.init_params(
        jax.random.PRNGKey(0)), step=1)
    a, b = _both_errors(cnn)
    assert a[1] == b[1] and "no decode path" in b[1]


def test_cli_serve_refuses_a_bad_checkpoint(ref_ckpt, tmp_path):
    with pytest.raises(SystemExit) as e:
        tcli.main(["serve", "--resume-from", str(tmp_path / "nope"),
                   "--device", "cpu"])
    assert str(e.value).startswith("spec error: no spec.json")
