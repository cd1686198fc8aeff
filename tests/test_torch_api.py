"""The port's spec/API/CLI surface, its device policy, and its isolation
from JAX and the reference package."""
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro import api as japi
from repro_torch import api as tapi
from repro_torch.api import cli as tcli
from repro_torch.core.simulation import SimConfig, SimEnv
from repro_torch.device import resolve_device

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

SMALL = ["--set", "data.n_clients=12", "--set", "data.samples_per_client=20",
         "--set", "data.image_hw=8", "--set", "tiers.n_tiers=3",
         "--set", "tiers.clients_per_round=4", "--set", "tiers.n_unstable=2",
         "--set", "engine.local_epochs=1", "--set", "engine.total_updates=2",
         "--set", "engine.eval_every=1"]


def test_default_spec_hash_matches_reference():
    assert tapi.ExperimentSpec().hash() == "60fd95ec9d49"
    assert tapi.ExperimentSpec().to_dict() == japi.ExperimentSpec().to_dict()
    assert tapi.SPEC_VERSION == japi.SPEC_VERSION


@pytest.mark.parametrize("overrides", [
    {"strategy.name": "fedavg", "transport.codec": "quantize8"},
    {"data.n_clients": 40, "data.partitioner": "dirichlet:0.3",
     "tiers.delay_bands": [[0, 1], [2, 3]], "engine.lr": 0.01},
    {"strategy.kwargs.use_prox": False, "tiers.retier_every": 5},
    {"data.task": "text"},
    {"data.model": "logreg", "data.n_features": 64},
])
def test_spec_documents_and_hashes_match_reference(overrides):
    j = japi.ExperimentSpec().with_overrides(overrides)
    t = tapi.ExperimentSpec().with_overrides(overrides)
    assert t.to_dict() == j.to_dict()
    assert t.hash() == j.hash() and t.env_hash() == j.env_hash()
    assert tapi.ExperimentSpec.from_json(j.to_json()).hash() == j.hash()
    t.validate()


def test_old_documents_parse_like_the_reference():
    doc = {"spec_version": 1, "data": {"task": "image", "n_clients": 20},
           "strategy": {"name": "tifl"}}
    assert (tapi.ExperimentSpec.from_dict(doc).hash()
            == japi.ExperimentSpec.from_dict(doc).hash())
    with pytest.raises(tapi.SpecError, match="unknown field"):
        tapi.ExperimentSpec.from_dict({"data": {"bogus": 1}})
    with pytest.raises(tapi.SpecError, match="unknown spec path"):
        tapi.ExperimentSpec().with_overrides({"nope.x": 1})


#: an out-of-range value of each fault knob, refused by both packages
FAULT_BAD = {"faults.churn_rate": 1.5, "faults.blackouts": -1,
             "faults.checkpoint_every": -2}


@pytest.mark.parametrize("path,value,item", [
    ("faults.churn_rate", 0.1, "A12"),
    ("faults.blackouts", 2, "A12"),
    ("faults.checkpoint_every", 5, "A12"),
    ("population.plane", "streaming", "A13"),
    ("topology.n_silos", 2, "A14"),
    ("mesh.kind", "host", "A16"),
])
def test_unported_sections_name_their_roadmap_item(path, value, item):
    """Every case refused naming its ROADMAP item before the item was
    ported (the ids are kept).  The fault (A12), population (A13),
    topology (A14) and mesh (A16) sections are ported: their knobs
    validate, hash as in the reference and bridge to the reference's
    ``SimConfig`` payload, and an out-of-range fault knob raises the
    reference's message."""
    spec = tapi.ExperimentSpec().with_overrides({path: value})
    jspec = japi.ExperimentSpec().with_overrides({path: value})
    jspec.validate()                                       # valid there
    if item == "A16":
        spec.validate()
        assert spec.hash() == jspec.hash()
        assert spec.env_hash() == jspec.env_hash()
        assert spec.env_hash() != tapi.ExperimentSpec().env_hash()
        sc, jsc = spec.to_sim_config(), jspec.to_sim_config()
        assert (sc.mesh, sc.shard_tiers) == (jsc.mesh, jsc.shard_tiers) \
            == ("host", False)
        assert type(spec).from_sim_config(sc) == spec
        return
    if item in ("A13", "A14"):
        spec.validate()
        assert spec.hash() == jspec.hash()
        assert spec.env_hash() == jspec.env_hash()
        field = path.split(".")[0]
        got = getattr(spec.to_sim_config(), field)
        want = getattr(jspec.to_sim_config(), field)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert type(spec).from_sim_config(spec.to_sim_config()) == spec
        return
    if item == "A12":
        spec.validate()
        assert spec.hash() == jspec.hash()
        assert spec.env_hash() == jspec.env_hash()
        msgs = []
        for api in (japi, tapi):
            with pytest.raises(api.SpecError) as e:
                api.ExperimentSpec().with_overrides(
                    {path: FAULT_BAD[path]}).validate()
            msgs.append(str(e.value))
        assert msgs[1] == msgs[0] and path in msgs[1]
        return
    with pytest.raises(tapi.SpecError, match=item):
        spec.validate()


@pytest.mark.parametrize("bad,match", [
    ({"strategy.name": "fedsgd"}, "unknown strategy"),
    ({"transport.codec": "zstd"}, "transport.codec"),
    ({"tiers.n_tiers": 0}, "n_tiers"),
    ({"strategy.kwargs.codec": "none"}, "transport.codec"),
])
def test_validation_errors_match_reference(bad, match):
    for api in (japi, tapi):
        with pytest.raises(api.SpecError, match=match):
            api.ExperimentSpec().with_overrides(bad).validate()


def test_cli_cpu_run_writes_results(tmp_path, capsys):
    out = tmp_path / "runs.json"
    results = tcli.main(["--device", "cpu", *SMALL,
                         "--sweep", "transport.codec=none,quantize8",
                         "--out", str(out)])
    assert len(results) == 2
    doc = json.loads(out.read_text())
    hashes = [r["spec_hash"] for r in doc["runs"]]
    spec = japi.ExperimentSpec().with_overrides(
        {a.split("=")[0]: json.loads(a.split("=")[1]) for a in SMALL[1::2]})
    assert hashes == [spec.with_overrides({"transport.codec": c}).hash()
                      for c in ("none", "quantize8")]
    for r in doc["runs"]:
        assert r["trajectory"]["rounds"] == [1, 2]
        assert all(0 <= a <= 1 for a in r["trajectory"]["acc"])
    assert "quantize8" in capsys.readouterr().out


def test_cli_print_spec_matches_reference(capsys):
    tcli.main(["--print-spec", "--set", "data.n_clients=7"])
    ours = json.loads(capsys.readouterr().out)
    assert ours == japi.ExperimentSpec().with_overrides(
        {"data.n_clients": 7}).to_dict()


@pytest.mark.parametrize("argv,match", [
    pytest.param(["serve", "--resume-from", "no/such/dir"],
                 "spec error: no spec.json", id="argv0-A15"),
    pytest.param(["--checkpoint-dir", "x", "--sweep",
                  "transport.codec=none,quantize8"],
                 "apply to single runs, not sweeps", id="argv1-A12"),
    pytest.param([*SMALL, "--resume-from", "no/such/dir"],
                 "spec error: no spec.json", id="argv2-A12"),
])
def test_cli_unported_paths_fail_fast(argv, match, capsys):
    """The checkpoint flags and the serve subcommand are ported (A12,
    A15): a bad use fails fast with the reference CLI's message."""
    from repro.api import cli as jcli
    msgs = []
    for main, extra in ((jcli.main, []), (tcli.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            main(argv + extra)
        err = capsys.readouterr().err
        msgs.append(str(e.value) if e.value.code != 2
                    else err.splitlines()[-1].split(": error: ")[1])
    assert msgs[1] == msgs[0] and match in msgs[1]


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")
    with pytest.raises(RuntimeError):
        SimEnv(SimConfig(n_clients=4, n_tiers=2, clients_per_round=2))
    with pytest.raises(SystemExit, match="device error"):
        tcli.main(SMALL)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_port_imports_neither_jax_nor_the_reference():
    code = ("import sys, repro_torch.api, repro_torch.api.cli, "
            "repro_torch.kernels, repro_torch.models.convert, "
            "repro_torch.compress, repro_torch.core.strategies; "
            "bad = [m for m in sys.modules if m in ('jax', 'repro') or "
            "m.startswith(('jax.', 'repro.'))]; "
            "assert not bad, bad; print('clean')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "clean"


def test_port_sources_have_no_jax_or_reference_imports():
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.M)
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        assert not pat.search(f.read_text()), f


def test_port_mirrors_reference_paths():
    ref = ROOT / "src" / "repro"
    for f in PORT.rglob("*.py"):
        rel = f.relative_to(PORT)
        if rel.name in ("__init__.py", "device.py", "convert.py", "build.py",
                        "spans.py", "cnn_block.py"):
            continue   # packages, and the port's own device policy, weight
            # converter, nvcc build of the CUDA kernels, span tracer and
            # CNN conv-block kernels (XLA fuses that glue for the reference)
        assert (ref / rel).exists(), rel
    assert (PORT / "kernels" / "csrc" / "polyline_codec.cu").exists()
    assert (PORT / "kernels" / "csrc" / "flash_attention.cu").exists()


def _run_smoke(cwd: Path):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=""))


def test_chip_smoke_refuses_without_card_or_sources(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal path on a machine with no card")
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", alone)
    proc = _run_smoke(alone)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
