"""Experiment CLI over the declarative spec API (the port's).

    # one run on the card: paper defaults + dotted-path overrides
    PYTHONPATH=src python -m repro_torch.api.cli \\
        --set data.n_clients=40 --set transport.codec=quantize8

    # on the CPU, a spec file + a cartesian sweep, results to JSON
    PYTHONPATH=src python -m repro_torch.api.cli --device cpu \\
        --spec exp.json --sweep strategy.name=fedat,fedavg \\
        --sweep transport.codec=none,quantize8 --out results.json

``--set PATH=VALUE`` applies one override; ``--sweep PATH=V1,V2,...`` adds
a grid axis.  Values parse as JSON when possible, else as strings.
``--out`` writes one record per run: tag, spec hash, full spec echo,
summary and the eval trajectory.  ``--device`` picks the device (default
cuda; without CUDA the run fails unless ``--device cpu`` is given).

The federated LM runs like any other model (``--set data.model=tiny_lm``
or ``tiny_lm_long``).  Not ported yet: the ``serve`` subcommand (serving a
federated checkpoint: the loader of ROADMAP A15, after A12; zoo decoders
are served by
``python -m repro_torch.launch.serve``) and
``--checkpoint-dir`` / ``--resume-from`` / ``--resume`` (ROADMAP A12).
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from repro_torch import api
from repro_torch.device import resolve_device


def _parse_value(s: str) -> Any:
    try:
        return json.loads(s)
    except json.JSONDecodeError:
        return s


def _parse_assignment(arg: str, flag: str) -> tuple:
    path, eq, val = arg.partition("=")
    if not eq or not path:
        raise SystemExit(f"{flag} expects PATH=VALUE, got {arg!r}")
    return path, val


def _result_record(res: api.Result) -> Dict[str, Any]:
    m = res.metrics
    return {
        "tag": res.tag, "spec_hash": res.spec_hash,
        "spec": res.spec.to_dict(), "summary": res.summary(),
        "trajectory": {
            "times": m.times, "rounds": m.rounds, "acc": m.acc,
            "acc_var": m.acc_var, "bytes_up": m.bytes_up,
            "bytes_down": m.bytes_down,
        },
    }


def _print_row(res: api.Result) -> None:
    s = res.metrics.summary()
    print(f"  {res.tag or '(single run)':48s} {res.spec_hash}  "
          f"acc={s['best_acc']:.3f}  var={s['final_var']:.4f}  "
          f"t={s['sim_time']:7.0f}s  {s['total_mb']:7.1f}MB", flush=True)


def main(argv: Optional[List[str]] = None) -> List[api.Result]:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "serve":
        raise SystemExit("the serve subcommand (serving a federated "
                         "checkpoint) is not ported to the PyTorch package "
                         "yet: it needs the checkpoint loader (the rest of "
                         "ROADMAP A15), which waits for A12; serve a zoo "
                         "decoder with python -m repro_torch.launch.serve "
                         "--arch <id>")
    ap = argparse.ArgumentParser(
        prog="repro_torch.api.cli",
        description="Run declarative FL experiments (ExperimentSpec) with "
                    "the PyTorch port.")
    ap.add_argument("--spec", metavar="FILE",
                    help="JSON ExperimentSpec (default: paper defaults)")
    ap.add_argument("--set", action="append", default=[], dest="sets",
                    metavar="PATH=VALUE",
                    help="override one spec field (repeatable)")
    ap.add_argument("--sweep", action="append", default=[], dest="sweeps",
                    metavar="PATH=V1,V2,...",
                    help="add a cartesian grid axis (repeatable)")
    ap.add_argument("--out", metavar="FILE",
                    help="write per-run results (spec echo + hash + "
                         "trajectory) as JSON")
    ap.add_argument("--device", default=None,
                    help="torch device: cuda (default), cuda:N or cpu")
    ap.add_argument("--checkpoint-dir", metavar="DIR",
                    help="not ported yet (ROADMAP A12)")
    ap.add_argument("--resume-from", metavar="DIR",
                    help="not ported yet (ROADMAP A12)")
    ap.add_argument("--resume", action="store_true",
                    help="not ported yet (ROADMAP A12)")
    ap.add_argument("--print-spec", action="store_true",
                    help="print the resolved base spec and exit")
    args = ap.parse_args(argv)
    if args.checkpoint_dir or args.resume_from or args.resume:
        ap.error("--checkpoint-dir/--resume-from/--resume are not ported "
                 "to the PyTorch package yet (ROADMAP A12)")

    try:
        if args.spec:
            with open(args.spec) as f:
                spec = api.ExperimentSpec.from_dict(json.load(f))
        else:
            spec = api.ExperimentSpec()
        overrides = {}
        for s in args.sets:
            path, val = _parse_assignment(s, "--set")
            overrides[path] = _parse_value(val)
        if overrides:
            spec = spec.with_overrides(overrides)
        if args.print_spec:
            print(spec.to_json())
            return []
        spec.validate()
        try:
            device = resolve_device(args.device)
        except (RuntimeError, ValueError) as e:
            raise SystemExit(f"device error: {e}")

        grid = {}
        for s in args.sweeps:
            path, vals = _parse_assignment(s, "--sweep")
            grid[path] = [_parse_value(v) for v in vals.split(",")]

        if grid:
            axes = " x ".join(f"{k}[{len(v)}]" for k, v in grid.items())
            print(f"base spec {spec.hash()}  sweep: {axes}", flush=True)
            results = api.sweep(spec, grid, on_result=_print_row,
                                device=device)
        else:
            print(f"spec {spec.hash()}", flush=True)
            res = api.build(spec, device=device).run()
            _print_row(res)
            results = [res]
    except api.SpecError as e:
        raise SystemExit(f"spec error: {e}")

    if args.out:
        with open(args.out, "w") as f:
            json.dump({"base_spec_hash": spec.hash(),
                       "runs": [_result_record(r) for r in results]},
                      f, indent=2)
        print(f"wrote {args.out}", file=sys.stderr)
    return results


if __name__ == "__main__":
    main()
