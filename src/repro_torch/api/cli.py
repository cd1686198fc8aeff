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
or ``tiny_lm_long``).  ``--checkpoint-dir`` saves the final params + spec
hash after a single run; ``--resume-from`` restores such a checkpoint as
the initial model (the saved spec hash must match).  With
``faults.checkpoint_every > 0`` the run also snapshots full engine state
under ``<checkpoint-dir>/engine``, and ``--resume`` replays a killed run
from the newest snapshot to a bitwise-identical trajectory.

Serving: ``repro_torch.api.cli serve --resume-from DIR [--device cpu]``
loads a ``--checkpoint-dir`` checkpoint of either package (spec-hash
verified against its ``spec.json`` sidecar), rebuilds the registry model
from the embedded spec, and serves it with the continuous-batching engine
under open-loop Poisson load (``--rate``), printing p50/p95/p99 latency
and tok/s (``--out`` writes the full report as JSON).  Zoo decoders are
served by ``python -m repro_torch.launch.serve``.

Several ranks (``--set mesh.kind=host``: the round's clients split over
them, launch/mesh.py): ``python -m torch.distributed.run --nproc-per-node
N -m repro_torch.api.cli --set mesh.kind=host ...``.  Each rank joins the
process group the launcher describes (gloo on the CPU and for ranks that
share one card, nccl for one card a rank); every rank runs the same
events, and only rank 0 prints rows and writes ``--out`` and checkpoints.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from repro_torch import api
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_mod


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


def _device(name: Optional[str]):
    try:
        return resolve_device(name)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"device error: {e}")


def _serve_main(argv: List[str]) -> Dict[str, Any]:
    """``repro_torch.api.cli serve --resume-from DIR``: load a
    spec-hash-verified federated checkpoint and serve it under open-loop
    Poisson load."""
    from repro_torch import serve as serving

    ap = argparse.ArgumentParser(
        prog="repro_torch.api.cli serve",
        description="Serve a federated checkpoint (continuous batching).")
    ap.add_argument("--resume-from", metavar="DIR", required=True,
                    help="checkpoint dir written by --checkpoint-dir; its "
                         "spec.json sidecar names the model + spec hash")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="Poisson arrival rate (req/s); 0 = closed burst")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=0,
                    help="position budget per slot "
                         "(0 = prompt-len + 4*max-new)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device: cuda (default), cuda:N or cpu")
    ap.add_argument("--out", metavar="FILE",
                    help="write the latency/throughput report as JSON")
    args = ap.parse_args(argv)
    device = _device(args.device)

    try:
        loaded = serving.load_checkpoint(args.resume_from, device=device)
        cfg = loaded.config
        max_len = args.max_len or (args.prompt_len + 4 * args.max_new)
        spec = serving.ServeSpec(slots=args.slots, max_len=max_len,
                                 prefill_len=min(args.prompt_len, max_len),
                                 max_new=args.max_new, seed=args.seed)
        reqs = serving.make_requests(args.requests, args.rate,
                                     spec.prefill_len, args.max_new,
                                     cfg.vocab_size, args.seed)
        engine = serving.ServeEngine(cfg, loaded.lm_params, spec)
        done = engine.run(reqs)
    except api.SpecError as e:
        raise SystemExit(f"spec error: {e}")

    rep = serving.report(done)
    rep.update(spec_hash=loaded.spec_hash, step=loaded.step,
               model=loaded.spec.data.model, rate=args.rate,
               device=str(device),
               shapes={k: len(v) for k, v in engine.call_shapes.items()},
               tokens={r.rid: [int(t) for t in r.out] for r in done})
    print(f"serving {rep['model']} @ spec {rep['spec_hash']} "
          f"(step {rep['step']}) on {rep['device']}")
    print(f"  {rep['requests']} requests ({rep['truncated']} truncated)  "
          f"{rep['tok_per_s']:.1f} tok/s  "
          f"p50/p95/p99 latency {rep['latency_p50_s']:.3f}/"
          f"{rep['latency_p95_s']:.3f}/{rep['latency_p99_s']:.3f}s",
          flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=2)
        print(f"wrote {args.out}", file=sys.stderr)
    return rep


def main(argv: Optional[List[str]] = None) -> List[api.Result]:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "serve":
        _serve_main(argv[1:])
        return []
    try:
        return _run_main(argv)
    finally:
        mesh_mod.shutdown()


def _run_main(argv: List[str]) -> List[api.Result]:
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
                    help="save final params + spec hash after the run "
                         "(single runs only)")
    ap.add_argument("--resume-from", metavar="DIR",
                    help="restore initial params from a --checkpoint-dir "
                         "checkpoint whose spec hash matches")
    ap.add_argument("--resume", action="store_true",
                    help="resume a killed run from its newest engine "
                         "snapshot under <checkpoint-dir>/engine (needs "
                         "--checkpoint-dir and faults.checkpoint_every > 0)")
    ap.add_argument("--print-spec", action="store_true",
                    help="print the resolved base spec and exit")
    args = ap.parse_args(argv)
    if (args.checkpoint_dir or args.resume_from) and args.sweeps:
        ap.error("--checkpoint-dir/--resume-from apply to single runs, "
                 "not sweeps")
    if args.resume and not args.checkpoint_dir:
        ap.error("--resume needs --checkpoint-dir (engine snapshots live "
                 "under <checkpoint-dir>/engine)")

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
        device = mesh_mod.init_from_env(_device(args.device))
        writer = mesh_mod.is_writer()

        grid = {}
        for s in args.sweeps:
            path, vals = _parse_assignment(s, "--sweep")
            grid[path] = [_parse_value(v) for v in vals.split(",")]

        if grid:
            axes = " x ".join(f"{k}[{len(v)}]" for k, v in grid.items())
            print(f"base spec {spec.hash()}  sweep: {axes}", flush=True)
            results = api.sweep(
                spec, grid, device=device,
                on_result=_print_row if writer else None)
        else:
            if writer:
                print(f"spec {spec.hash()}", flush=True)
            res = api.build(spec, device=device,
                            resume_from=args.resume_from).run(
                checkpoint_dir=args.checkpoint_dir,
                resume_engine=args.resume)
            if writer:
                _print_row(res)
            results = [res]
    except api.SpecError as e:
        raise SystemExit(f"spec error: {e}")

    if args.out and mesh_mod.is_writer():
        with open(args.out, "w") as f:
            json.dump({"base_spec_hash": spec.hash(),
                       "runs": [_result_record(r) for r in results]},
                      f, indent=2)
        print(f"wrote {args.out}", file=sys.stderr)
    return results


if __name__ == "__main__":
    main()
