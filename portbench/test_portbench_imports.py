"""A run at smoke size loads no module whose top-level name is jax,
jaxlib, flax or repro (the JAX package; ``repro_torch`` is another name),
checked in a fresh process because other test files in a worker import
JAX."""
import json
import os
import subprocess
import sys

import pytest

from portbench import harness

PROBE = """
import json, sys
sys.path[:0] = [{root!r}]
from portbench import harness, testing
harness.cache_env()
res = testing.smoke_run({cell!r}, seconds=0.2)
print(json.dumps({{"correct": res["correct"],
                  "forbidden": harness.forbidden_modules()}}))
"""


@pytest.mark.parametrize("cell", ["fedat_cnn_k100"])
def test_a_run_loads_no_jax(cell):
    out = subprocess.run(
        [sys.executable, "-c", PROBE.format(root=str(harness.ROOT),
                                            cell=cell)],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"correct": True, "forbidden": []}


def test_forbidden_names_are_whole_top_level_names():
    assert set(harness.FORBIDDEN) == {"jax", "jaxlib", "flax", "repro"}
    sys.modules.setdefault("repro_torch_probe_name", sys)
    try:
        assert "repro" not in harness.forbidden_modules() or \
            "repro" in {m.split(".")[0] for m in sys.modules}
    finally:
        del sys.modules["repro_torch_probe_name"]


def test_no_file_reads_the_jax_package_or_its_benchmarks():
    words = ("import jax", "from jax", "import repro\n", "from repro ",
             "from repro.", "import repro.", "chip_smoke", "BENCH_",
             "benchmarks/", "benchmarks.")
    for p in harness.PB.rglob("*.py"):
        if p.name.startswith("test_portbench_imports"):
            continue
        text = p.read_text()
        for w in words:
            assert w not in text, (p, w)
