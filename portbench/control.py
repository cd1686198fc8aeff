"""Readings of the numbers that decide ``correct``: the program's on many
seeds, and the control's and the planted faults' with the plain
reference in the program's place.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 \
        [--program-seeds 4 5 6 ...]

For each of ``--seeds``, the reference in the nearest precision below
the configuration's float32 (TF32 operands, fp32 accumulation:
``control``) and the reference with half of each round's clients left
out (``half_batch``), each judged by the run's own comparison against
the reference at float32.  A round that returns its state unchanged
reads about 1 by that measure and needs no run.  ``--program-seeds``
drives the program on each seed through the driver's own ``drive``, one
environment for all (its set-up is long), with a window of no length,
and judges it as a run does (the lower readings).  The benchmark's own
runs never run this.
"""
import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path


def _driver(cell):
    from portbench import harness
    return harness.load_module("drivers", cell.workload["driver"])


def shared_data(cell, seeds):
    """The reference's data for the checked rounds of all ``seeds``."""
    from portbench.reference import fedat as ref
    drv, need = _driver(cell), set()
    for seed in seeds:
        c = dataclasses.replace(cell, seed=seed)
        spec = drv.spec_dict(c)
        rounds = ref.schedule(spec, seed, int(c.traffic["warm_updates"]))
        checked = ref.checked_rounds(rounds, int(c.traffic["fold_rounds"]))
        need |= drv.needed_clients(spec, seed, checked)
    return ref.synthesize(cell.traffic["spec"]["data"], need)


def readings(cell, seed: int, variants, data=None):
    """{variant: {number: reading}} for one seed: each variant of the
    reference in the program's place."""
    from portbench.reference import fedat as ref
    drv = _driver(cell)
    c = dataclasses.replace(cell, seed=seed)
    spec = drv.spec_dict(c)
    cfg = dict(c.config, **c.traffic.get("config", {}))
    replay = ref.schedule(spec, seed, int(c.traffic["warm_updates"]))
    checked = ref.checked_rounds(replay, int(c.traffic["fold_rounds"]))
    if data is None:
        data = shared_data(cell, [seed])
    out = {}
    for v in variants:
        prec, fault = ("tf32", None) if v == "control" else ("fp32", v)
        obs = ref.observe(spec, cfg, seed,
                          ref.draw_params(cfg, seed, c.device), checked,
                          prec=prec, fault=fault, data=data)
        out[v] = drv.readings(c, replay, obs, checked, data)
    return out


def program_readings(cell, seeds, data):
    """{seed: {number: reading}}: the program driven on each seed."""
    drv = _driver(cell)
    env = drv.environment(cell)
    out = {}
    for seed in seeds:
        c = dataclasses.replace(cell, seed=seed, seconds=0.0, trace=False)
        run = drv.drive(c, env)
        checked, prog = drv.checked_of(c, run["captured"])
        out[seed] = drv.readings(c, run["rounds"], prog, checked, data)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "checked": checked, "program": out[seed]}),
              flush=True)
    return out


def main(argv=None):
    root = Path(__file__).resolve().parents[1]
    sys.path[0] = str(root)
    sys.path.insert(1, str(root / "src"))
    from portbench import harness
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    harness.cache_env()
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.load_cell(args.workload)
    t = time.perf_counter()
    data = shared_data(cell, args.seeds + args.program_seeds)
    harness.log(f"reference data in {time.perf_counter() - t:.1f} s")
    if args.program_seeds:
        from repro_torch.kernels import build as kbuild
        kbuild.build(*cell.workload["kernels"])
        program_readings(cell, args.program_seeds, data)
    for seed in args.seeds:
        t = time.perf_counter()
        r = readings(cell, seed, ["control", "half_batch"], data)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "readings": r,
                          "seconds": time.perf_counter() - t}), flush=True)


if __name__ == "__main__":
    main()
