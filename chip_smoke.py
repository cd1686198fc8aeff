#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py [--out FILE]

Runs from the root of a checkout; drives the port (``src/repro_torch``)
only, never JAX or the reference package.  Phases:

1. Record the card (name, power limit, torch/CUDA versions) and build the
   codec kernels from ``src/repro_torch/kernels/csrc``.
2. Hold each kernel against its plain PyTorch version on the card,
   bitwise, for 8 and 16 bits: every CNN leaf at full width, per client
   and stacked over 10 clients, tails, an all-zero block, exact ties and a
   NaN block.  Time kernel and plain version at the stacked uplink size.
3. Run the main path: FedAT with ``transport.codec=quantize8`` through
   ``repro_torch.api.build(spec).run()`` on the card, the paper CNN at
   CIFAR-10 shape (100 clients, K=10, 3 local epochs, 10 updates), with
   the kernel launch counts set to 0 just before and read just after.
4. Hold the card against the CPU: the same small FedAT quantize8 run from
   the same params0 and permutations on both devices.
5. Drive the baselines (FedAvg, TiFL, FedAsync) with quantize8.

Any failed check exits non-zero.  The last three lines of standard output
are the kernel report (JSON), the card's ``name, power.limit`` and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the port's
sources beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
CARD_VS_CPU_RTOL = 1e-3        # see phase 4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1: the card and the build
# ---------------------------------------------------------------------------

def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def bits_equal(a, b) -> bool:
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def codec_cases(torch, dev, params_shapes, K):
    """(name, flat float32 tensor) cases at the main path's shapes."""
    g = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for k, shape in params_shapes.items():
        for stack in (1, K):
            n = stack * math.prod(shape)
            cases.append((f"{k}x{stack}",
                          torch.randn(n, device=dev, generator=g) * 0.05))
    for n in (1, 255, 257, 2000):
        cases.append((f"tail{n}", torch.randn(n, device=dev, generator=g)))
    z = torch.randn(1024, device=dev, generator=g)
    z[256:512] = 0.0
    cases.append(("zero_block", z))
    return cases


def tie_case(torch, dev, bits):
    """A block whose scale is exactly 1: x = j/2 holds exact half-way ties
    (round half to even must give 0, -2, 2, ...)."""
    qmax = (1 << (bits - 1)) - 1
    x = (torch.arange(256, device=dev, dtype=torch.float32) - 128) * 0.5
    x[0] = float(qmax)
    return x


def compare_kernels(torch, pc, ref, dev, params_shapes, K):
    """Bitwise kernel-vs-plain checks; returns max abs errors."""
    err = {"compress": 0.0, "decompress": 0.0}
    n_checked = 0
    for bits in (8, 16):
        cases = codec_cases(torch, dev, params_shapes, K)
        cases.append(("ties", tie_case(torch, dev, bits)))
        for name, x in cases:
            n = x.numel()
            q, s = pc.compress_blocks(x, bits)
            qr, sr = ref.compress_blocks(x, bits)
            xr = pc.decompress_blocks(q, s, n)
            xrr = ref.decompress_blocks(qr, sr, n)
            torch.cuda.synchronize()
            check(bits_equal(q, qr), f"compress q differs ({name}, {bits} bits)")
            check(bits_equal(s, sr), f"compress scale differs ({name}, {bits} bits)")
            check(bits_equal(xr, xrr), f"decompress differs ({name}, {bits} bits)")
            err["compress"] = max(
                err["compress"],
                float((q.float() - qr.float()).abs().max()),
                float((s - sr).abs().max()))
            err["decompress"] = max(err["decompress"],
                                    float((xr - xrr).abs().max()))
            n_checked += 1
        q, _ = pc.compress_blocks(tie_case(torch, dev, bits), bits)
        check(q[0, 1:6].tolist() == [-64, -63, -62, -62, -62],
              f"ties not rounded half to even: {q[0, :6].tolist()}")
        # a NaN anywhere in a block makes that block's scale NaN
        x = torch.randn(1000, device=dev)
        x[300] = float("nan")
        _, s = pc.compress_blocks(x, bits)
        check(s.isnan().squeeze(1).tolist() == [False, True, False, False],
              f"NaN block scale: {s.squeeze(1).tolist()}")
    log(f"phase 2: {n_checked} kernel/plain comparisons bitwise equal "
        f"(8 and 16 bits)")
    return err


def graph_time_ms(torch, fn, iters: int = 50) -> float:
    """Device time of ``fn`` per call: captured once in a CUDA graph and
    replayed ``iters`` times between CUDA events (no host launch cost)."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_kernels(torch, pc, ref, dev, params_shapes, K, bits=8):
    """Kernel and plain times for one stacked uplink (every leaf of K
    clients), beside the bytes-moved bound."""
    g = torch.Generator(device=dev).manual_seed(1)
    leaves = [torch.randn(K * math.prod(s), device=dev, generator=g) * 0.05
              for s in params_shapes.values()]
    comp = [pc.compress_blocks(x, bits) for x in leaves]
    itemsize = 1 if bits <= 8 else 2
    n_vals = sum(x.numel() for x in leaves)
    n_blocks = sum(q.shape[0] for q, _ in comp)
    code_bytes = n_blocks * (256 * itemsize + 4)
    out = {}
    for name, kern, plain, nbytes, ops in (
            ("compress",
             lambda: [pc.compress_blocks(x, bits) for x in leaves],
             lambda: [ref.compress_blocks(x, bits) for x in leaves],
             4 * n_vals + code_bytes, 6 * n_blocks * 256),
            ("decompress",
             lambda: [pc.decompress_blocks(q, s, x.numel())
                      for (q, s), x in zip(comp, leaves)],
             lambda: [ref.decompress_blocks(q, s, x.numel())
                      for (q, s), x in zip(comp, leaves)],
             code_bytes + 4 * n_vals, n_blocks * 256)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / FP32_OPS_PER_S * 1e3
        # plain, kernel, kernel, plain: the order cancels drift
        p1 = graph_time_ms(torch, plain)
        k1 = graph_time_ms(torch, kern)
        k2 = graph_time_ms(torch, kern)
        p2 = graph_time_ms(torch, plain)
        out[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "bytes": nbytes, "values": n_vals,
                     "launches_timed": len(leaves)}
        log(f"phase 2: {name} stacked uplink ({n_vals} values, "
            f"{len(leaves)} leaves): kernel {out[name]['ms']:.4f} ms "
            f"(runs {k1:.4f}/{k2:.4f}), plain {out[name]['plain_ms']:.4f} ms "
            f"(runs {p1:.4f}/{p2:.4f}), bound {out[name]['bound_ms']:.5f} ms "
            f"({nbytes} B at 3.35 TB/s)")
    return out


# ---------------------------------------------------------------------------
# phases 3-5: the slice
# ---------------------------------------------------------------------------

FULL = {
    "data.model": "cnn", "data.image_hw": 32, "data.n_classes": 10,
    "data.n_clients": 100, "data.samples_per_client": 500,
    "tiers.n_tiers": 5, "tiers.clients_per_round": 10,
    "engine.local_epochs": 3, "engine.batch_size": 10,
    "engine.total_updates": 10, "engine.eval_every": 5,
    "strategy.name": "fedat", "transport.codec": "quantize8",
}

SMALL = {
    "data.n_clients": 12, "data.samples_per_client": 20,
    "data.image_hw": 8, "tiers.n_tiers": 3, "tiers.clients_per_round": 4,
    "tiers.n_unstable": 2,
    "tiers.delay_bands": [[0.0, 0.0], [0.0, 0.5], [0.5, 1.0]],
    "engine.local_epochs": 2, "engine.total_updates": 2,
    "engine.eval_every": 1, "strategy.name": "fedat",
    "transport.codec": "quantize8",
}


def flat(params):
    import torch
    return torch.cat([params[k].detach().float().cpu().reshape(-1)
                      for k in sorted(params)])


def run_main_path(torch, api, pc, dev):
    spec = api.ExperimentSpec().with_overrides(FULL)
    run = api.build(spec, device=dev)
    env = run.env
    n_params = sum(v.numel() for v in env.params0.values())
    check(n_params == 122570, f"CNN has {n_params} params, expected 122570")
    check(all(v.is_cuda for v in env.train_dev.values()),
          "train stacks are not resident on the card")
    ex = env.executor()
    round_s = []
    orig = ex.fedat_round

    def timed_round(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*a, **k)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        return out

    ex.fedat_round = timed_round
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pc.reset_launch_counts()
    t0 = time.perf_counter()
    res = run.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = pc.launch_counts()
    del ex.fedat_round
    peak = torch.cuda.max_memory_allocated()

    w = run.strategy.global_params()
    check(all(v.is_cuda for v in w.values()), "global params left the card")
    check(all(bool(torch.isfinite(v).all()) for v in w.values()),
          "non-finite global params")
    check(all(bool(torch.isfinite(v).all())
              for v in run.strategy.tier_models.values()),
          "non-finite tier models")
    m = res.metrics
    check(m.rounds and m.rounds[-1] == 10, f"rounds {m.rounds}")
    check(all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in m.acc),
          f"accuracies {m.acc}")
    rounds = len(round_s)
    n_leaves = len(env.params0)
    # 2 lossy steps (downlink + uplink) x n_leaves per committed round
    expect = 2 * n_leaves * rounds
    check(rounds == 10, f"{rounds} FedAT rounds ran, expected 10")
    check(counts == {"compress": expect, "decompress": expect},
          f"launch counts {counts}, expected {expect} each "
          f"(2 x {n_leaves} leaves x {rounds} rounds)")
    steps = (env.train["y"].shape[1] // env.sc.batch_size) \
        * env.sc.local_epochs
    info = {
        "spec_hash": res.spec_hash, "rounds": rounds, "wall_s": wall,
        "events_per_s": rounds / wall,
        "ms_per_round": 1e3 * sum(round_s) / rounds,
        "ms_per_round_each": [1e3 * r for r in round_s],
        "local_steps_per_round": steps, "final_acc": m.acc[-1],
        "acc": m.acc, "sim_time": m.times[-1],
        "bytes_up": m.bytes_up[-1], "bytes_down": m.bytes_down[-1],
        "peak_mem_bytes": peak, "launches": counts, "n_params": n_params,
        "client_cap": int(env.train["y"].shape[1]),
    }
    log(f"phase 3: FedAT quantize8 full width: {rounds} rounds in "
        f"{wall:.3f} s ({info['events_per_s']:.4f} events/s, "
        f"{info['ms_per_round']:.2f} ms/round over {steps} local steps "
        f"of K=10 clients), final acc {m.acc[-1]:.4f}, peak "
        f"{peak / 2**20:.1f} MiB, launches {counts}")
    return info, run


def card_vs_cpu(torch, api, SimEnv, dev):
    """Relative L2 of card - CPU over the CPU params' norm; the tolerance
    is the CPU tests' quantize8 bound: fp32 products summed in another
    order can move a value across a code boundary, a step of
    max|block|/127."""
    spec = api.ExperimentSpec().with_overrides(SMALL)
    sc = spec.to_sim_config()
    p0 = SimEnv(sc, device="cpu").params0
    out = {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        env = SimEnv(sc, device=d, params0=p0)
        run = api.build(spec, env=env)
        run.run()
        out[name] = (flat(run.strategy.w_global),
                     flat(run.strategy.tier_models))
    w0 = flat(p0)
    rel = {}
    for i, name in enumerate(("w_global", "tier_models")):
        a, b = out["card"][i], out["cpu"][i]
        if name == "w_global":
            check(float((b - w0).norm()) > 0, "w_global did not move")
        rel[name] = float((a - b).norm() / b.norm())
    log(f"phase 4: card vs CPU after 2 FedAT quantize8 updates: "
        f"|card - cpu| / |cpu| = {rel} (tolerance {CARD_VS_CPU_RTOL})")
    for k, v in rel.items():
        check(v <= CARD_VS_CPU_RTOL, f"card and CPU disagree on {k}: {v}")
    return rel


def profile_round(torch, run, round_ms: float):
    """One more full-width FedAT quantize8 round under torch.profiler
    (outside the counted main-path run): the device time of its kernels,
    where that time goes, and the device busy share against
    ``round_ms``, the median unprofiled round (the profiler slows the host
    side, not the kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    env, st = run.env, run.strategy
    ex = env.executor()
    ids = env.tm.members[0][:env.sc.clients_per_round]
    cw = np.full(env.tm.n_tiers, 1.0 / env.tm.n_tiers, np.float32)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ex.fedat_round(st.w_global, st.tier_models, 0, ids, 12345,
                       codec=st.codec, use_prox=True, cross_weights=cw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = {}
    for e in prof.key_averages():
        # kernel events only: a CPU op's self device time repeats the
        # time of the kernels it launched
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        per_kernel[e.key] = per_kernel.get(e.key, 0.0) + \
            e.self_device_time_total / 1e3
    dev_ms = sum(per_kernel.values())
    if dev_ms == 0:
        log("phase 3: profiler saw no kernel time: busy share not measured")
        return {"profiled_wall_ms": wall_ms, "device_ms": None}
    codec_ms = sum(t for k, t in per_kernel.items() if "compress_kernel" in k)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    info = {"profiled_wall_ms": wall_ms, "device_ms": dev_ms,
            "round_ms": round_ms, "busy_share": dev_ms / round_ms,
            "codec_ms": codec_ms, "codec_share_of_device": codec_ms / dev_ms,
            "n_kernels": len(per_kernel),
            "top_kernels_ms": {k[:100]: t for k, t in top}}
    log(f"phase 3: profiled round: kernels {dev_ms:.1f} ms of device time "
        f"against a {round_ms:.1f} ms round (busy "
        f"{100 * info['busy_share']:.1f}%, idle "
        f"{100 * (1 - info['busy_share']):.1f}%); codec kernels "
        f"{codec_ms:.3f} ms ({100 * info['codec_share_of_device']:.3f}% of "
        f"device time); profiled wall {wall_ms:.1f} ms")
    for k, t in top:
        log(f"  {t:9.3f} ms  {k[:100]}")
    return info


def baselines(torch, api, pc, dev):
    out = {}
    for name in ("fedavg", "tifl", "fedasync"):
        spec = api.ExperimentSpec().with_overrides(
            dict(FULL, **{"strategy.name": name,
                          "engine.total_updates": 2,
                          "engine.eval_every": 2}))
        run = api.build(spec, device=dev)
        pc.reset_launch_counts()
        t0 = time.perf_counter()
        res = run.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = pc.launch_counts()
        w = run.strategy.global_params()
        check(all(bool(torch.isfinite(v).all()) for v in w.values()),
              f"{name}: non-finite params")
        check(res.metrics.rounds == [2], f"{name}: rounds {res.metrics.rounds}")
        check(counts["compress"] > 0 and counts["decompress"] > 0,
              f"{name}: codec kernels not launched {counts}")
        out[name] = {"wall_s": wall, "acc": res.metrics.acc[-1],
                     "launches": counts}
        log(f"phase 5: {name} quantize8, 2 updates: {wall:.3f} s, acc "
            f"{res.metrics.acc[-1]:.4f}, launches {counts}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every number as JSON here")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available; this script needs an NVIDIA card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"the port's sources (src/repro_torch) are not beside "
             f"{Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import api
    from repro_torch.core.simulation import SimEnv
    from repro_torch.kernels import polyline_codec as pc, ref
    check("jax" not in sys.modules and "repro" not in sys.modules,
          "the port imported jax or the reference package")

    # phase 1
    card = card_line()
    dev = "cuda"
    log(f"phase 1: card {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmul is on; the port computes fp32 products in full fp32")
    t0 = time.perf_counter()
    info = pc.build()
    log(f"phase 1: codec kernels built in {time.perf_counter() - t0:.2f} s "
        f"({info['path']})")
    for line in str(info["log"]).splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    from repro_torch.models.registry import DataDims, build_model
    model = build_model("cnn", DataDims(n_classes=10, image_hw=32))
    shapes = {k: tuple(v.shape) for k, v in
              model.init_params(torch.Generator().manual_seed(0)).items()}
    K = FULL["tiers.clients_per_round"]

    # phase 2
    errs = compare_kernels(torch, pc, ref, dev, shapes, K)
    times = time_kernels(torch, pc, ref, dev, shapes, K)

    # phase 3: the main path, counts from 0 (the profile runs after)
    main_path, run = run_main_path(torch, api, pc, dev)
    main_path["profile"] = profile_round(
        torch, run, float(np.median(main_path["ms_per_round_each"])))
    # phase 4
    agree = card_vs_cpu(torch, api, SimEnv, dev)
    # phase 5
    base = baselines(torch, api, pc, dev)

    src = "src/repro_torch/kernels/csrc/polyline_codec.cu"
    kernels = []
    for name, line in (("compress", 52), ("decompress", 69)):
        t = times[name]
        kernels.append({
            "name": f"quantize_{name}", "route": "cuda", "source": src,
            "replaces": f"src/repro/kernels/polyline_codec.py:{line}",
            "launches": main_path["launches"][name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({
            "card": card, "torch": torch.__version__,
            "cuda": torch.version.cuda, "build_s": info["seconds"],
            "kernels": kernels, "kernel_times": times,
            "main_path": main_path, "card_vs_cpu": agree,
            "baselines": base}, indent=2))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
