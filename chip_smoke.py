#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py [--out FILE]

Runs from the root of a checkout; drives the port (``src/repro_torch``)
only, never JAX or the reference package.  Phases:

1. Record the card (name, power limit, torch/CUDA versions) and build
   every kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
   source, all started together).
2. Hold each codec kernel against its plain PyTorch version on the card,
   bitwise, for 8 and 16 bits: every CNN leaf at full width, per client
   and stacked over 10 clients, tails, an all-zero block, exact ties and a
   NaN block.  Time kernel and plain version at the stacked uplink size.
3. Run the FedAT path: FedAT with ``transport.codec=quantize8`` through
   ``repro_torch.api.build(spec).run()`` on the card, the paper CNN at
   CIFAR-10 shape (100 clients, K=10, 3 local epochs, 10 updates), with
   the kernel launch counts set to 0 just before and read just after.
4. Hold the card against the CPU: the same small FedAT quantize8 run from
   the same params0 and permutations on both devices.
5. Drive the baselines (FedAvg, TiFL, FedAsync) with quantize8.
6. Hold the flash attention kernel against its plain version (the
   materialised oracle) on the card: the reference's seven ATTN_CASES,
   head dims 16 and 120, and the serving prefill shape, in fp32 (max abs
   error 2e-5) and bf16 (2e-2).  Time kernel, plain version and
   ``scaled_dot_product_attention`` (the yardstick, never called by the
   port) at the prefill shape in both dtypes, beside the bound.
7. Run the serving path: ``repro_torch.launch.serve`` at qwen2-7b full
   width (fp32 params drawn on the card, fp32 cache), 16 requests over 8
   slots, prompts up to 1024 tokens, 16 new tokens each, with the launch
   counts set to 0 just before and read just after: the flash kernel must
   have run once per layer per prefill wave.  Then profile one prefill
   wave and one decode step.
8. Hold the card against the CPU for serving: qwen2-smoke and
   h2o-danube-smoke (window 64) from the same params and requests on both
   devices give the same tokens, and their prefill logits agree within a
   relative L2 of 1e-4.

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
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
CARD_VS_CPU_RTOL = 1e-3        # see phase 4
SERVE_LOGITS_RTOL = 1e-4       # see phase 8


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
    check(counts == {"compress": expect, "decompress": expect,
                     "flash_attention": 0},
          f"launch counts {counts}, expected {expect} of each codec kernel "
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

# ---------------------------------------------------------------------------
# phase 6: the flash attention kernel against its plain version
# ---------------------------------------------------------------------------

# (S, T, H, KV, hd, causal, window): the reference's ATTN_CASES
# (tests/test_kernels.py), then the smoke/tiny head dim 16 and
# h2o-danube's 120
ATTN_CASES = [
    (128, 128, 4, 4, 64, True, None),
    (256, 256, 4, 2, 64, True, None),
    (200, 200, 4, 2, 80, True, None),
    (128, 128, 8, 1, 128, True, None),
    (128, 384, 2, 2, 64, False, None),
    (256, 256, 4, 4, 64, True, 100),
    (512, 512, 2, 2, 64, True, 128),
    (100, 100, 4, 2, 16, True, None),
    (300, 300, 8, 2, 120, True, 128),
]
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
#: bf16 output against the fp32 plain version on the same (bf16-valued)
#: inputs: the kernel computes in fp32 and rounds once to bf16, so each
#: element is within half a bf16 ulp (<= 2^-8 of its magnitude) of the fp32
#: result, plus the fp32 tolerance for the order of the sums.  A wrong scale
#: or a dropped key moves typical outputs (about 0.05) by far more.
BF16_ROUND_REL = 2.0 ** -8
#: the serving prefill shape: 8 slots x 1024 tokens at qwen2-7b's heads
PREFILL = dict(B=8, S=1024, H=28, KV=4, hd=128)


def visible_pairs(S: int, T: int, causal: bool, window) -> int:
    """(query, key) pairs the masks let through, per head."""
    s = np.arange(S)
    hi = np.minimum(s + 1, T) if causal else np.full(S, T)
    lo = np.maximum(s - window + 1, 0) if window else np.zeros(S, int)
    return int(np.maximum(hi - lo, 0).sum())


def attention_bound(B, S, T, H, KV, hd, causal, window, dtype):
    """Least time for one launch: each of q, k, v, o moved once, and
    2 FLOP per multiply-add of QK^T and PV over the visible pairs."""
    size = 4 if dtype == "float32" else 2
    nbytes = size * (2 * B * S * H * hd + 2 * B * T * KV * hd)
    flops = 4 * B * H * visible_pairs(S, T, causal, window) * hd
    peak = FP32_OPS_PER_S if dtype == "float32" else BF16_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def event_time_ms(torch, fn, iters: int = 10) -> float:
    """Device time per call of ``fn`` between CUDA events, after warm-up
    (each call is long enough that launch cost is noise)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attn_inputs(torch, g, B, S, T, H, KV, hd, dtype):
    dt = getattr(torch, dtype)
    return (torch.randn(B, S, H, hd, device="cuda", generator=g).to(dt),
            torch.randn(B, T, KV, hd, device="cuda", generator=g).to(dt),
            torch.randn(B, T, KV, hd, device="cuda", generator=g).to(dt))


def check_flash(torch, fa, ref):
    """Kernel vs plain version on every case and dtype; then times at the
    prefill shape.  Returns {dtype: {...}}."""
    g = torch.Generator(device="cuda").manual_seed(6)
    P = PREFILL
    cases = [(c, 2) for c in ATTN_CASES] + \
        [((P["S"], P["S"], P["H"], P["KV"], P["hd"], True, None), P["B"])]
    out = {}
    for dtype in ("float32", "bfloat16"):
        worst, worst_round = 0.0, 0.0
        for (S, T, H, KV, hd, causal, window), B in cases:
            q, k, v = attn_inputs(torch, g, B, S, T, H, KV, hd, dtype)
            got = fa.flash_attention(q, k, v, causal=causal, window=window)
            want = ref.attention_gqa(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"flash output {tuple(got.shape)} {got.dtype}")
            check(bool(torch.isfinite(got).all()), "flash output not finite")
            err = float((got.float() - want.float()).abs().max())
            check(err < ATTN_TOL[dtype],
                  f"flash kernel vs plain ({S},{T},{H},{KV},{hd},{causal},"
                  f"{window}) B={B} {dtype}: max abs err {err}")
            worst = max(worst, err)
            if dtype == "bfloat16":
                want32 = ref.attention_gqa(q.float(), k.float(), v.float(),
                                           causal=causal, window=window)
                excess = float(((got.float() - want32).abs()
                                / (BF16_ROUND_REL * want32.abs()
                                   + ATTN_TOL["float32"])).max())
                check(excess <= 1.0,
                      f"flash kernel bf16 ({S},{T},{H},{KV},{hd},{causal},"
                      f"{window}) B={B}: not the fp32 result rounded to "
                      f"bf16 (|err| / (2^-8 |want| + 2e-5) = {excess})")
                worst_round = max(worst_round, excess)
                del want32
            del got, want
        q, k, v = attn_inputs(torch, g, P["B"], P["S"], P["S"], P["H"],
                              P["KV"], P["hd"], dtype)
        kern = lambda: fa.flash_attention(q, k, v, causal=True)  # noqa: E731
        plain = lambda: ref.attention_gqa(q, k, v, causal=True)  # noqa: E731

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True)
        lib_note = None
        try:
            lib = library()
            torch.cuda.synchronize()
            lib_err = float((lib.transpose(1, 2).float()
                             - kern().float()).abs().max())
        except Exception as e:  # the yardstick only: never on the path
            lib, lib_err, lib_note = None, None, f"{type(e).__name__}: {e}"
        # plain, kernel, kernel, plain (library between): cancels drift
        p1 = event_time_ms(torch, plain, 3)
        k1 = event_time_ms(torch, kern)
        l1 = event_time_ms(torch, library) if lib is not None else None
        k2 = event_time_ms(torch, kern)
        p2 = event_time_ms(torch, plain, 3)
        b = attention_bound(P["B"], P["S"], P["S"], P["H"], P["KV"],
                            P["hd"], True, None, dtype)
        out[dtype] = dict(b, max_abs_err=worst, ms=min(k1, k2),
                          ms_runs=[k1, k2], plain_ms=min(p1, p2),
                          plain_ms_runs=[p1, p2], library_ms=l1,
                          library_vs_kernel_max_abs=lib_err,
                          library_note=lib_note, cases=len(cases))
        o = out[dtype]
        rounding = ""
        if dtype == "bfloat16":
            o["bf16_rounding_ratio"] = worst_round
            rounding = (f", within one bf16 rounding of the fp32 result "
                        f"(worst ratio {worst_round:.3g} <= 1)")
        log(f"phase 6: flash {dtype}: {len(cases)} shapes within "
            f"{ATTN_TOL[dtype]} of the plain version (max abs err "
            f"{worst:.3g}){rounding}; prefill shape B={P['B']} S=T={P['S']} "
            f"H={P['H']} KV={P['KV']} hd={P['hd']} causal: kernel "
            f"{o['ms']:.4f} ms (runs {k1:.4f}/{k2:.4f}), plain "
            f"{o['plain_ms']:.4f} ms, SDPA "
            f"{'n/a' if l1 is None else f'{l1:.4f}'} ms, bound "
            f"{o['bound_ms']:.4f} ms ({o['bound_by']}: {o['flops'] / 1e9:.1f}"
            f" GFLOP, {o['bytes'] / 1e6:.1f} MB); achieved "
            f"{o['flops'] / o['ms'] / 1e9:.2f} TFLOP/s"
            + (f"; SDPA unavailable: {lib_note}" if lib_note else ""))
        del q, k, v
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 7-8: the serving path
# ---------------------------------------------------------------------------

SERVE_ARGV = ["--arch", "qwen2-7b", "--requests", "16", "--slots", "8",
              "--prompt-len", "1024", "--max-new", "16", "--seed", "0",
              "--device", "cuda"]


def run_serving(torch, kernels, serve_launch):
    """qwen2-7b at full width through the port's serving entry point."""
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, done, rep = serve_launch.run(SERVE_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    cfg = engine.cfg
    n_params = sum(t.numel() for t in _leaves(engine.params))
    check(cfg.name == "qwen2-7b" and n_params == 7_615_612_928 + cfg.d_model,
          f"served {cfg.name} with {n_params} params")
    check(all(t.is_cuda and t.dtype == torch.float32
              for t in _leaves(engine.params)), "params not fp32 on the card")
    waves = len(engine.call_seconds["prefill"])
    steps = len(engine.call_seconds["decode"])
    check(waves == 2, f"{waves} prefill waves, expected 2 (16 over 8 slots)")
    check(counts["flash_attention"] == waves * cfg.n_layers == 56,
          f"flash launches {counts}, expected {waves} waves x "
          f"{cfg.n_layers} layers")
    check(counts["compress"] == 0 and counts["decompress"] == 0,
          f"codec kernels ran while serving: {counts}")
    check(len(done) == 16 and sorted(r.rid for r in done) == list(range(16)),
          f"{len(done)} requests done")
    check(all(len(r.out) == 16 and not r.truncated for r in done),
          "a request did not finish with 16 tokens")
    check(all(0 <= t < cfg.vocab_size for r in done for t in r.out),
          "token ids out of range")
    check(all(len(v) == 1 for v in engine.call_shapes.values()),
          f"more than one input shape per call: {engine.call_shapes}")
    check(bool(torch.isfinite(engine.cache.k).all()
               and torch.isfinite(engine.cache.v).all()),
          "non-finite KV cache")
    # least times from the shapes: a prefill wave is the layers' GEMMs over
    # B x P padded tokens, one flash launch per layer and the head at the
    # last positions (operations, fp32 FFMA); a decode step reads every
    # weight and the whole cache once (bytes)
    B, P, d = engine.spec.slots, engine.spec.prefill_len, cfg.d_model
    gemm = sum(t.numel() for t in _leaves(engine.params["layers"])
               if t.dim() == 3)
    wave_flops = (2 * gemm * B * P + 2 * B * d * cfg.vocab_size
                  + cfg.n_layers * attention_bound(
                      B, P, P, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                      True, None, "float32")["flops"])
    step_bytes = 4 * n_params + sum(t.numel() * t.element_size()
                                    for t in engine.cache)
    bounds = {"prefill_wave_flops": wave_flops,
              "prefill_wave_bound_s": wave_flops / FP32_OPS_PER_S,
              "decode_step_bytes": step_bytes,
              "decode_step_bound_s": step_bytes / HBM_BYTES_PER_S}
    info = {"wall_s": wall, "report": rep, "peak_mem_bytes": peak,
            "bounds": bounds,
            "launches": counts, "prefill_waves": waves,
            "decode_steps": steps,
            "prefill_wave_s": list(engine.call_seconds["prefill"]),
            "decode_step_s_median": float(np.median(
                engine.call_seconds["decode"])),
            "reset_s": list(engine.call_seconds["reset"]),
            "prompt_lens": sorted(len(r.prompt) for r in done),
            "n_params": n_params}
    log(f"phase 7: qwen2-7b full width served {rep['requests']} requests "
        f"x 16 tokens in {wall:.3f} s: {rep['tok_per_s']:.2f} tok/s, "
        f"latency p50 {rep['latency_p50_s']:.3f} s / p95 "
        f"{rep['latency_p95_s']:.3f} s, TTFT p50 {rep['ttft_p50_s']:.3f} s "
        f"/ p95 {rep['ttft_p95_s']:.3f} s; peak {peak / 2**30:.2f} GiB; "
        f"prefill waves {[round(t, 4) for t in info['prefill_wave_s']]} s, "
        f"decode step median {1e3 * info['decode_step_s_median']:.2f} ms "
        f"over {steps} steps; flash launches {counts['flash_attention']} "
        f"(= {waves} waves x {cfg.n_layers} layers)")
    log(f"phase 7: bounds: prefill wave {bounds['prefill_wave_bound_s']:.4f}"
        f" s (operations: {wave_flops / 1e12:.2f} TFLOP at 67 TFLOP/s fp32)"
        f", decode step {1e3 * bounds['decode_step_bound_s']:.3f} ms (bytes:"
        f" {step_bytes / 1e9:.2f} GB of weights and cache at 3.35 TB/s)")
    return info, engine


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def profile_serving(torch, engine, info):
    """One more prefill wave and one decode step of the full-width engine
    under torch.profiler (outside the counted run): kernel time by kernel
    and the device busy share against the unprofiled medians."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    B, P = engine.spec.slots, engine.spec.prefill_len
    rng = np.random.default_rng(7)
    toks = rng.integers(0, engine.cfg.vocab_size, (B, P)).astype(np.int32)
    last = np.full(B, P - 1, np.int32)
    out = {}
    for name, call, base_s in (
            ("prefill", lambda: engine._prefill(toks, last),
             float(np.median(info["prefill_wave_s"]))),
            ("decode", lambda: engine._decode(toks[:, 0], last + 1),
             info["decode_step_s_median"])):
        engine._reset(np.ones(B, bool))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        per_kernel = {}
        for e in prof.key_averages():
            if getattr(e, "device_type", None) != DeviceType.CUDA:
                continue
            per_kernel[e.key] = per_kernel.get(e.key, 0.0) + \
                e.self_device_time_total / 1e3
        dev_ms = sum(per_kernel.values())
        if dev_ms == 0:
            log(f"phase 7: profiler saw no kernel time in {name}: busy "
                f"share not measured")
            out[name] = {"device_ms": None}
            continue
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
        flash_ms = sum(t for k, t in per_kernel.items() if "flash" in k)
        out[name] = {"device_ms": dev_ms, "call_ms": 1e3 * base_s,
                     "busy_share": dev_ms / (1e3 * base_s),
                     "flash_ms": flash_ms, "n_kernels": len(per_kernel),
                     "top_kernels_ms": {k[:100]: t for k, t in top}}
        o = out[name]
        log(f"phase 7: profiled {name}: kernels {dev_ms:.2f} ms against a "
            f"{o['call_ms']:.2f} ms unprofiled call (busy "
            f"{100 * o['busy_share']:.1f}%, idle "
            f"{100 * (1 - o['busy_share']):.1f}%); flash {flash_ms:.3f} ms "
            f"({100 * flash_ms / dev_ms:.2f}% of kernel time)")
        for k, t in top:
            log(f"  {t:10.3f} ms  {k[:100]}")
    return out


def serving_card_vs_cpu(torch, kernels, lm, convert, serve):
    """Smoke configs on the card and on the CPU from the same params and
    requests: equal tokens, and prefill logits within SERVE_LOGITS_RTOL
    (fp32 sums in another order, through the kernel on the card and the
    blocked path on the CPU)."""
    from repro_torch.configs.registry import get_smoke_config
    out = {}
    for arch, plen, max_new in (("qwen2-7b", 24, 8),
                                ("h2o-danube-3-4b", 48, 40)):
        cfg = get_smoke_config(arch)
        p_cpu = lm.init_params(cfg, seed=1, device="cpu")
        p_card = convert.params_from_numpy(convert.params_to_numpy(p_cpu),
                                           device="cuda")
        spec = serve.ServeSpec(slots=3, max_len=plen + 4 * max_new,
                               prefill_len=plen, max_new=max_new)
        toks = {}
        kernels.reset_launch_counts()
        for dev, p in (("card", p_card), ("cpu", p_cpu)):
            reqs = serve.make_requests(6, 0.0, plen, max_new,
                                       cfg.vocab_size, seed=2)
            done = serve.ServeEngine(cfg, p, spec).run(reqs)
            toks[dev] = {r.rid: (r.out, r.truncated) for r in done}
        launches = kernels.launch_counts()["flash_attention"]
        check(launches > 0, f"{arch}: the card run did not use the kernel")
        check(toks["card"] == toks["cpu"],
              f"{arch}: card and CPU generated different tokens")
        rng = np.random.default_rng(3)
        batch = rng.integers(0, cfg.vocab_size, (3, plen)).astype(np.int32)
        logits = {}
        for dev, p in (("card", p_card), ("cpu", p_cpu)):
            d = "cuda" if dev == "card" else "cpu"
            cache = lm.init_cache(cfg, 3, plen, 1, torch.float32, device=d)
            with torch.no_grad():
                lg, _ = lm.serve_prefill(
                    cfg, p, {"tokens": torch.as_tensor(batch, device=d)}, 1,
                    cache)
            logits[dev] = lg.float().cpu()
        rel = float((logits["card"] - logits["cpu"]).norm()
                    / logits["cpu"].norm())
        check(rel <= SERVE_LOGITS_RTOL,
              f"{arch}: prefill logits card vs CPU rel L2 {rel}")
        n_tok = sum(len(o) for o, _ in toks["card"].values())
        out[arch] = {"tokens": n_tok, "rel_l2_prefill_logits": rel,
                     "flash_launches": launches}
        log(f"phase 8: {arch}: card and CPU generated the same {n_tok} "
            f"tokens (6 requests, 3 slots); prefill logits |card - cpu| / "
            f"|cpu| = {rel:.3g} (tolerance {SERVE_LOGITS_RTOL})")
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
    from repro_torch import api, kernels, serve
    from repro_torch.core.simulation import SimEnv
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import polyline_codec as pc, ref
    from repro_torch.launch import serve as serve_launch
    from repro_torch.models import convert, lm
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
    built = kbuild.build(*kbuild.sources())
    build_s = time.perf_counter() - t0
    log(f"phase 1: kernels {sorted(built)} built in {build_s:.2f} s "
        f"(nvcc in parallel) into {kbuild.BUILD_DIR}")
    for name, info in sorted(built.items()):
        for line in str(info["log"]).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    from repro_torch.models.registry import DataDims, build_model
    model = build_model("cnn", DataDims(n_classes=10, image_hw=32))
    shapes = {k: tuple(v.shape) for k, v in
              model.init_params(torch.Generator().manual_seed(0)).items()}
    K = FULL["tiers.clients_per_round"]

    # phase 2
    errs = compare_kernels(torch, pc, ref, dev, shapes, K)
    times = time_kernels(torch, pc, ref, dev, shapes, K)

    # phase 3: the FedAT path, counts from 0 (the profile runs after)
    main_path, run = run_main_path(torch, api, kernels, dev)
    main_path["profile"] = profile_round(
        torch, run, float(np.median(main_path["ms_per_round_each"])))
    del run
    # phase 4
    agree = card_vs_cpu(torch, api, SimEnv, dev)
    # phase 5
    base = baselines(torch, api, kernels, dev)
    torch.cuda.empty_cache()

    # phase 6
    flash = check_flash(torch, fa, ref)
    # phase 7: the serving path, counts from 0 (the profile runs after)
    serving, engine = run_serving(torch, kernels, serve_launch)
    serving["profile"] = profile_serving(torch, engine, serving)
    del engine
    torch.cuda.empty_cache()
    # phase 8
    serve_agree = serving_card_vs_cpu(torch, kernels, lm, convert, serve)

    src = "src/repro_torch/kernels/csrc/polyline_codec.cu"
    report = []
    for name, line in (("compress", 52), ("decompress", 69)):
        t = times[name]
        report.append({
            "name": f"quantize_{name}", "route": "cuda", "source": src,
            "replaces": f"src/repro/kernels/polyline_codec.py:{line}",
            "launches": main_path["launches"][name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    f32 = flash["float32"]   # the serving path's dtype
    report.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:91",
        "launches": serving["launches"]["flash_attention"],
        "max_abs_err": f32["max_abs_err"], "ms": f32["ms"],
        "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"], "library_ms": f32["library_ms"]})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({
            "card": card, "torch": torch.__version__,
            "cuda": torch.version.cuda, "build_s": build_s,
            "kernels": report, "kernel_times": times,
            "main_path": main_path, "card_vs_cpu": agree,
            "baselines": base, "flash": flash, "serving": serving,
            "serving_card_vs_cpu": serve_agree}, indent=2))
    print(json.dumps({"kernels": report}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
