"""The harness: load a cell by name, run its driver, reduce the record to
the cell's metrics, check the port against its plain reference, print.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``.  Everything it
needs is found by name:

* ``workloads/<traffic>.json``: the configuration it is written for, the
  driver, the traffic parameters (and a ``smoke`` set for the CPU tests),
  the limits of the numbers that decide ``correct``;
* ``configs/<config>.json``: the configuration's sizes, source and cuts;
* ``drivers/<driver>.py``: ``run(cell) -> record``;
* ``metrics/<metric>.py``: ``read(record) -> float | None`` for every
  metric of ``BENCHMARK.json`` the cell reports.

A record is a dict.  Every driver fills ``setup_s``, ``window`` (host
``perf_counter`` seconds of the measured window), ``attempted``,
``failed``, ``counters``, ``spans`` (host ``(name, start, end)``),
``shapes``, ``memory_peak_bytes`` (the device's peak allocation in the
window: its counter is reset when the window opens) and ``checks``
(``{name: (value, limit)}``, each number compared with the reference
beside its limit); a
traced run adds ``device_events`` and ``busy_s`` (devtrace.py).  The
harness adds ``config``, ``workload`` and ``peaks`` (counts/peaks.py).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List

PB = Path(__file__).resolve().parent
ROOT = PB.parent
#: top-level module names no run may load (the JAX package and JAX)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def cache_env(root: Path = ROOT) -> None:
    """Fixed cache directories inside the checkout, set before torch loads
    (the port's own kernels build into ``build/repro_torch_kernels``)."""
    base = root / "build" / "portbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(base / "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(path: Path) -> Any:
    return json.loads(Path(path).read_text())


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under portbench, loaded by its path (metric
    names hold dots)."""
    path = PB / kind / f"{name}.py"
    safe = "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(f"_pb_{kind}_{safe}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no {kind} file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One cell as a run sees it."""
    name: str
    entry: Dict[str, Any]          # the BENCHMARK.json workload entry
    workload: Dict[str, Any]       # workloads/<traffic>.json
    config: Dict[str, Any]         # configs/<config>.json
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    seed: int = 0
    seconds: float = 10.0
    trace: bool = False
    device: str = "cuda"
    smoke: bool = False
    t_start: float = 0.0

    @property
    def traffic(self) -> Dict[str, Any]:
        return self.workload["smoke" if self.smoke else "traffic"]

    @property
    def limits(self) -> Dict[str, float]:
        return self.workload["limits"]


def cell_metrics(bench: Dict[str, Any], name: str):
    """The end-to-end and per-layer metrics ``BENCHMARK.json`` asks of
    cell ``name``: those whose ``workloads`` list names it, and those
    without the key (a per-layer one in every cell that reports the
    end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if (name in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    return e2e, per


def load_cell(name: str, root: Path = ROOT, **kw) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json; cells: "
                         f"{sorted(entries)}")
    entry = entries[name]
    workload = load_json(PB / "workloads" / f"{entry['traffic']}.json")
    if workload["config"] != entry["config"]:
        raise SystemExit(f"traffic {entry['traffic']!r} is written for "
                         f"{workload['config']!r}, the cell names "
                         f"{entry['config']!r}")
    config = load_json(PB / "configs" / f"{entry['config']}.json")
    e2e, per = cell_metrics(bench, name)
    return Cell(name=name, entry=entry, workload=workload,
                config=config, end_to_end=e2e, per_layer=per, **kw)


def sync(device: str) -> None:
    if device == "cuda":
        import torch
        torch.cuda.synchronize()


def memory_peak(device: str) -> int:
    if device == "cuda":
        import torch
        return int(torch.cuda.max_memory_allocated())
    return 0


def reset_peak(device: str) -> None:
    if device == "cuda":
        import torch
        torch.cuda.reset_peak_memory_stats()


def free_device(device: str) -> None:
    import gc
    gc.collect()
    if device == "cuda":
        import torch
        torch.cuda.empty_cache()


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def device_info(cell: Cell, rec: Dict[str, Any]) -> Dict[str, Any]:
    if cell.device == "cuda":
        import torch
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": int(cell.entry["chips"])}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1}
    info["memory_peak_bytes"] = int(rec["memory_peak_bytes"])
    if cell.trace and rec.get("busy_s") is not None:
        info["busy_s"] = rec["busy_s"]
        info["window_s"] = rec["window"][1] - rec["window"][0]
    return info


def read_metrics(cell: Cell, rec: Dict[str, Any]) -> Dict[str, Any]:
    """Each metric the run reports, by its reader; a reader that finds
    nothing to read returns None and the metric is left out."""
    out = {}
    for m in (cell.per_layer if cell.trace else cell.end_to_end):
        value = load_module("metrics", m["name"]).read(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def verdict(checks: Dict[str, Any]) -> bool:
    """Every compared number at or under its limit (NaN fails)."""
    return all(v <= lim for v, lim in checks.values())


def run_cell(cell: Cell) -> Dict[str, Any]:
    """Run ``cell`` through its driver and build the result line (a
    dict, ``checks`` last)."""
    from portbench.counts import peaks
    driver = load_module("drivers", cell.workload["driver"])
    rec = driver.run(cell)
    rec["config"], rec["workload"] = cell.config, cell.workload
    info = device_info(cell, rec)
    rec["peaks"] = peaks.lookup(info["kind"]) if cell.device == "cuda" \
        else None
    res = {"correct": verdict(rec["checks"]),
           "attempted": int(rec["attempted"]), "failed": int(rec["failed"]),
           "metrics": read_metrics(cell, rec), "device": info}
    if cell.trace and rec.get("breakdown"):
        res["breakdown"] = rec["breakdown"]
    # a number that is not finite (a leaf missing, a NaN) reads null
    res["checks"] = {k: {"value": v if math.isfinite(v) else None,
                         "limit": lim}
                     for k, (v, lim) in rec["checks"].items()}
    return res


def power_line() -> None:
    """The card's name and power limit, on an earlier line of stderr."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable: {e}"
    log(f"card: {out}")


def main(argv: List[str], t_start: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_env()
    cell = load_cell(args.workload, seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), device="cuda", t_start=t_start)
    import torch
    need = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        log(f"no card: cuda available {torch.cuda.is_available()}, "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" devices, the cell needs {need}")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # the configurations state float32: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    power_line()
    res = run_cell(cell)
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        log("TF32 was switched on during the run")
        return 4
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {bad}")
        return 3
    for k, c in res["checks"].items():
        ok = c["value"] is not None and c["value"] <= c["limit"]
        log(f"check {k} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if ok else 'FAIL'}")
    print(json.dumps(res), flush=True)
    return 0
