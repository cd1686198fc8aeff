"""Driver of the FedAT simulation cells: ``repro_torch.api.build`` on an
environment made from the cell's spec, then ``Run.run()`` (the engine ->
``FedATStrategy`` -> ``RoundExecutor.fedat_round``), stopped from outside
the port at an event boundary once the window has passed.

Set-up: the environment (the program's data synthesis, padding and
upload), the benchmark's initial model (drawn on the device from
``--seed``, handed to the run as its ``initial_params``), the kernels'
load, and the first ``warm_updates`` committed updates with their evals.
Each of those rounds is captured (its input global model, the tier slot
it wrote, the global model after it).  After the window the plain
reference replays the engine from the same seed and computes the checked
rounds: the first, and ``fold_rounds`` rounds from the first whose Eq. 3
weights a trained tier slot (``reference.fedat.checked_rounds``).
Compared: every committed round's tier, clients and seed exactly; each
checked round's change of its tier slot by the median leaf's gap of
norms, the reference's round trained from the program's input
(``tier_gap``); the global model's change from the initial one after it,
the reference on its own chain, by the median leaf's gap
(``global_gap``) and by the worst leaf's (``global_worst_gap``, which a
leaf left unmoved or moved double fails).

The window: committed updates from the end of set-up until ``--seconds``
have passed, measured to the end of the last one's device work.  With
``--trace 1`` the device is traced over the window and each round is
timed on the host clock, synchronised before and after it.
"""
from __future__ import annotations

import copy
import sys
import time
from typing import Any, Dict, List

import numpy as np


class _WindowClosed(Exception):
    pass


def spec_dict(cell) -> Dict[str, Any]:
    """The cell's spec with the engine seeded by ``--seed``."""
    spec_d = copy.deepcopy(cell.traffic["spec"])
    spec_d["engine"]["seed"] = int(cell.seed)
    return spec_d


def environment(cell):
    """The program's environment of the cell's spec (the benchmark's
    model is handed to each run, not to the environment)."""
    from repro_torch import api
    from repro_torch.core.simulation import SimEnv
    spec = api.ExperimentSpec.from_dict(spec_dict(cell))
    return SimEnv(spec.to_sim_config(), device=cell.device)


def drive(cell, env) -> Dict[str, Any]:
    """One run of the engine on ``env`` from ``--seed``: warm-up, then the
    window; the rounds it committed, the warm-up's captures, the spans."""
    import torch
    from portbench import devtrace, harness
    from portbench.reference import fedat as ref
    from repro_torch import api

    dev = cell.device
    cfg = dict(cell.config, **cell.traffic.get("config", {}))
    warm = int(cell.traffic["warm_updates"])
    spec_d = spec_dict(cell)
    spec = api.ExperimentSpec.from_dict(dict(
        spec_d, engine=dict(spec_d["engine"], total_updates=10 ** 9)))
    run_ = api.build(spec, env=env)
    run_.initial_params = ref.draw_params(cfg, cell.seed, dev)
    ex = env.executor()
    strategy = run_.strategy
    trace = devtrace.DeviceTrace() if cell.trace and dev == "cuda" else None
    st: Dict[str, Any] = {"t0": None, "t1": None}
    rounds: List[Dict[str, Any]] = []
    spans: List[tuple] = []
    captured: List[Dict[str, Any]] = []

    orig_round = ex.fedat_round

    def fedat_round(w_global, tier_models, m, ids, seed, **kw):
        timed = st["t0"] is not None and cell.trace
        if timed:
            harness.sync(dev)
        a = time.perf_counter()
        check = len(rounds) < warm
        w_in = {k: v.detach().cpu().clone() for k, v in w_global.items()} \
            if check else None
        out = orig_round(w_global, tier_models, m, ids, seed, **kw)
        if timed:
            harness.sync(dev)
        b = time.perf_counter()
        rounds.append({"tier": int(m), "ids": np.array(ids), "seed": int(seed),
                       "in_window": st["t0"] is not None})
        if st["t0"] is not None:
            spans.append(("fedat_round", a, b))
        if check:
            w_out, stack = out
            captured.append({
                "w_in": w_in,
                "slot": {k: v[int(m)].detach().cpu().clone()
                         for k, v in stack.items()},
                "w_out": {k: v.detach().cpu().clone()
                          for k, v in w_out.items()}})
        return out

    orig_event = strategy.on_event

    def on_event(env_, ctx, now, actor):
        if st["t0"] is None and len(rounds) >= warm:
            if trace is not None:
                trace.start()
            harness.sync(dev)
            harness.reset_peak(dev)
            st["t0"] = time.perf_counter()
        if (st["t0"] is not None
                and time.perf_counter() - st["t0"] >= cell.seconds):
            harness.sync(dev)
            st["t1"] = time.perf_counter()
            raise _WindowClosed
        return orig_event(env_, ctx, now, actor)

    orig_eval = env.evaluate

    def evaluate(params):
        a = time.perf_counter()
        out = orig_eval(params)
        if st["t0"] is not None:
            spans.append(("eval", a, time.perf_counter()))
        return out

    ex.fedat_round = fedat_round
    strategy.on_event = on_event
    env.evaluate = evaluate
    try:
        run_.run()
        raise RuntimeError("the engine ran out of events before the "
                           "window closed")
    except _WindowClosed:
        pass
    finally:
        del ex.fedat_round, strategy.on_event, env.evaluate
    if trace is not None:
        trace.stop()
    final = strategy.global_params()
    return {"rounds": rounds, "captured": captured, "spans": spans,
            "window": (st["t0"], st["t1"]), "trace": trace,
            "finite": all(bool(torch.isfinite(v).all())
                          for v in final.values())}


def run(cell) -> Dict[str, Any]:
    from portbench import devtrace, harness
    from portbench.reference import fedat as ref

    dev = cell.device
    if dev == "cuda":
        from repro_torch.kernels import build as kbuild
        kbuild.build(*cell.workload["kernels"])
    env = environment(cell)
    cfg = dict(cell.config, **cell.traffic.get("config", {}))
    shapes = {k: tuple(v.shape) for k, v in env.params0.items()}
    if shapes != ref.param_shapes(cfg):
        raise RuntimeError(f"the program's CNN {shapes} is not the "
                           f"configuration's {ref.param_shapes(cfg)}")
    n_params = sum(v.numel() for v in env.params0.values())
    K = env.sc.clients_per_round
    out = drive(cell, env)
    (t0, t1), rounds = out["window"], out["rounds"]
    peak = harness.memory_peak(dev)
    window = [r for r in rounds if r["in_window"]]
    setup_s = t0 - cell.t_start
    rec: Dict[str, Any] = {
        "setup_s": setup_s, "window": (t0, t1),
        "attempted": len(window),
        "failed": 0 if out["finite"] else len(window),
        "spans": out["spans"], "memory_peak_bytes": peak,
        "counters": {"committed_updates": len(window),
                     "b1_values": len(window) * (n_params + K * n_params)},
        "shapes": {"clients_per_round": K, "params": n_params}}
    devtrace.finish(out["trace"], rec, t0, t1)
    del env, out["trace"]
    harness.free_device(dev)

    # -- the plain reference, after the window -------------------------
    spec_d = spec_dict(cell)
    checked, prog = checked_of(cell, out["captured"])
    data = ref.synthesize(spec_d["data"], needed_clients(
        spec_d, cell.seed, None if prog is None else checked))
    nums = readings(cell, rounds, prog, checked, data)
    if cell.trace:
        n_train = data[0]
        cap = int(n_train.max())
        e = spec_d["engine"]["local_epochs"]
        bs = spec_d["engine"]["batch_size"]
        rec["counters"]["real_samples"] = sum(
            ref.visited_real_samples(r["seed"], [int(n_train[c])
                                                 for c in r["ids"]],
                                     K, e, cap, bs)
            for r in window)
    rec["checks"] = {k: (nums[k], float(v)) for k, v in cell.limits.items()}
    harness.log(f"{cell.name}: {len(window)} updates in {t1 - t0:.3f} s, "
                f"set-up {setup_s:.3f} s, peak {peak} B")
    return rec


def checked_of(cell, captured: List[Dict]):
    """The checked rounds of ``--seed`` and their captures (None where
    the warm-up holds them not)."""
    from portbench.reference import fedat as ref
    checked = ref.checked_rounds(
        ref.schedule(spec_dict(cell), int(cell.seed), len(captured)),
        int(cell.traffic["fold_rounds"]))
    if checked is None or max(checked) >= len(captured):
        return checked, None
    return checked, [captured[i] for i in checked]


def needed_clients(spec_d, seed: int, checked) -> set:
    """The clients of the rounds the reference trains for ``checked``
    (None: none); the sizes of all come with any draw."""
    from portbench.reference import fedat as ref
    if checked is None:
        return set()
    rounds = ref.schedule(spec_d, int(seed), max(checked) + 1)
    need = ref.needed_rounds(rounds, checked, spec_d["tiers"]["n_tiers"])
    return {int(c) for i in need for c in rounds[i]["ids"]}


def readings(cell, rounds: List[Dict], prog, checked, data
             ) -> Dict[str, float]:
    """The numbers compared: ``rounds`` (the committed rounds' tier, ids
    and seed) against the reference's replay of the engine
    (``schedule_mismatches``), and ``prog`` (the observed checked rounds,
    None where the warm-up held them not) against the reference's checked
    rounds, the worst over them of: the median leaf's gap of norms of the
    tier slot's change, the reference's round trained from the program's
    input (``tier_gap``); the median and the worst leaf's gap of norms of
    the global model's change from the initial model, the reference on
    its own chain (``global_gap``, ``global_worst_gap``).  Each round's
    median and worst leaf are logged."""
    from portbench import compare, harness
    from portbench.reference import fedat as ref
    spec_d = spec_dict(cell)
    cfg = dict(cell.config, **cell.traffic.get("config", {}))
    replay = ref.schedule(spec_d, int(cell.seed), len(rounds))
    mismatches = sum(
        1 for i, r in enumerate(rounds)
        if i >= len(replay) or r["tier"] != replay[i]["tier"]
        or r["seed"] != replay[i]["seed"]
        or not np.array_equal(r["ids"], replay[i]["ids"]))
    out = {"schedule_mismatches": float(mismatches)}
    if prog is None:
        harness.log(f"{cell.name}: the warm-up holds not the checked "
                    f"rounds {checked}")
        return dict(out, tier_gap=float("inf"), global_gap=float("inf"),
                    global_worst_gap=float("inf"))
    w0 = ref.draw_params(cfg, cell.seed, cell.device)
    obs = ref.observe(spec_d, cfg, int(cell.seed), w0, checked, data=data,
                      starts={i: p["w_in"] for i, p in zip(checked, prog)})
    w0 = {k: v.cpu() for k, v in w0.items()}
    worst = {"tier_gap": 0.0, "global_gap": 0.0, "global_worst_gap": 0.0}
    for i, p, r in zip(checked, prog, obs):
        for name, key, base_p, base_r in (
                ("tier_gap", "slot", p["w_in"], r["start"]),
                ("global_gap", "w_out", w0, w0)):
            dp = compare.leaf_norms({k: p[key][k] - base_p[k]
                                     for k in p[key]})
            dr = compare.leaf_norms({k: r[key][k] - base_r[k]
                                     for k in r[key]})
            med = compare.median_leaf_gap(dp, dr)
            top, leaf = compare.worst_leaf_gap(dp, dr)
            print(f"[portbench] round {i} {name}: median leaf {med!r}, "
                  f"worst leaf {top!r} ({leaf})", file=sys.stderr)
            worst[name] = max(worst[name], med)
            if name == "global_gap":
                worst["global_worst_gap"] = max(worst["global_worst_gap"],
                                                top)
    return dict(out, **worst)
