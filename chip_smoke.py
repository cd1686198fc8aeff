#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (H100).

    python3 chip_smoke.py [--out FILE]

Runs from the root of a checkout; drives the port (``src/repro_torch``)
only, never JAX or the reference package.  Phases:

1. Record the card (name, power limit, torch/CUDA versions) and build
   every kernel from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
   source, all started together).
2. Hold each codec kernel against its plain PyTorch version on the card,
   bitwise, for 8 and 16 bits: the pair (compress, decompress) on every
   CNN leaf at full width, per client and stacked over 10 clients, tails,
   an all-zero block, exact ties and a NaN block; the fused roundtrip
   (the links' lossy step, one launch over up to 64 leaves) against the
   pair and the plain version on the full-width CNN tree as a downlink and
   as a K=10 uplink, a tree of those cases, a +-inf block, sizes that are
   no multiple of 4, views that are not 16-byte aligned and a tree of 150
   leaves (3 launches).  Time the pair at the stacked uplink size; time
   the roundtrip per uplink and downlink tree, L2-cold and warm, beside
   the pair, the plain version, an empty kernel (the launch floor), a
   yardstick that is not bitwise (amax and
   ``fake_quantize_per_channel_affine``) and the bytes bound, and log its
   grid, CTAs per SM and waves.
3. Run the FedAT path: FedAT with ``transport.codec=quantize8`` through
   ``repro_torch.api.build(spec).run()`` on the card, the paper CNN at
   CIFAR-10 shape (100 clients, K=10, 3 local epochs, 10 updates), with
   the kernel launch counts set to 0 just before and read just after:
   exactly one roundtrip launch a link (2 a round) and no pair launch.
   Then profile one round: the codec's device time and launches in it.
4. Hold the card against the CPU: the same small FedAT quantize8 run from
   the same params0 and permutations on both devices.
5. Drive the baselines (FedAvg, TiFL, FedAsync) with quantize8: each
   must launch the roundtrip and not the pair.
6. Hold the flash attention kernel against its plain version (the
   materialised oracle) on the card: the reference's seven ATTN_CASES,
   head dims 16 and 120, the qwen2-7b prefill shape, zamba2's shared
   block (32 heads of 80) and the trainer's microbatch (1 x 4096 tokens
   at qwen2-7b's heads), and the moe, audio and hybrid paths' shapes
   (``PATH_ATTN_SHAPES``: granite and deepseek prefill waves, granite,
   hubert and zamba2 training microbatches, hubert's non-causal at hd
   80), in fp32 (max abs error 2e-5; the FFMA design)
   and bf16 (2e-2, and within one bf16 rounding of the fp32 result; the
   tensor-core design, whose SASS must hold HGMMA and UTMALDG
   instructions), and on layouts that take the designs' other paths
   (unaligned fp32, padded bf16 head dims, strides in no order, cross
   attention, S > T); a bf16 operand TMA cannot load must be refused.
   Time kernel, plain version and
   ``scaled_dot_product_attention`` (the yardstick, never called by the
   port) at both serving shapes and the trainer's in both dtypes, beside
   the bound.
7. Run the serving path: ``repro_torch.launch.serve`` at qwen2-7b full
   width (fp32 params drawn on the card, fp32 cache), 16 requests over 8
   slots, prompts up to 1024 tokens, 16 new tokens each, with the launch
   counts set to 0 just before and read just after: the flash kernel must
   have run once per layer per prefill wave.  Then profile one prefill
   wave and one decode step.  Then, with the fp32 engine freed, one
   qwen2-7b prefill wave in bf16 (8 x 1024 tokens) through the prototype
   ``Server``: exactly 28 flash launches and finite logits, its time and
   flash's share of it under the profiler.
8. Hold the card against the CPU for serving: qwen2-smoke and
   h2o-danube-smoke (window 64) from the same params and requests on both
   devices give the same tokens, and their prefill logits agree within a
   relative L2 of 1e-4.

9. Hold the chunk-scan kernels against their plain versions on the card:
   WKV6 (B3) on the reference's WKV_CASES against the token-level oracle
   (5e-4 fp32, 5e-2 bf16), SSD (B4) on SSD_CASES (5e-4, 1e-1); both with
   a nonzero state in and the state out against the chunked plain version
   (relative 1e-4 fp32, 1e-2 bf16), in the models' layouts, at full width
   with an S that is no multiple of the kernels' chunk and at the
   full-width prefill shapes; WKV6 with logw = -8 finite, also over the
   whole prefill shape.  Both kernels' SASS must hold tensor-core
   products (HMMA); log their counts and each launch's grid, CTAs per SM
   and waves.  Time kernel and plain version at the prefill shapes beside
   the bound (counted at a fixed chunk, BOUND_CHUNK) and the bound with
   the products on the tensor cores.
10. rwkv6-3b at full width (fp32 params drawn on the card): the prototype
    ``Server`` prefills a wave of 8 prompts of 4..1024 tokens through
    ``lm.serve_prefill`` (exactly 32 wkv6 launches) and decodes 16 tokens;
    then ``launch/serve.py`` with its default arch (16 requests, 8 slots,
    prompts up to 64, 16 new) force-feeds every prompt (no prefill call,
    no launch); then one profiled wave and step.
11. zamba2-2.7b likewise: a wave makes 54 ssd and 9 flash launches.
12. rwkv6-smoke and zamba2-smoke on the card and the CPU from the same
    params and requests: equal tokens from a Server wave and an engine run
    that recycles slots, prefill logits within a relative L2 of 1e-4.

13. Hold the flash attention backward (B2 bwd, the training paths'
    kernels: bf16 on wgmma + TMA, fp32 in 3xTF32 on mma.sync) against its
    plain version on the card: phase 6's cases, a GQA hd-128 case and
    S != T, dO contiguous, strided and misaligned (bf16 copies it for
    TMA, counted), in fp32 (1e-4 of each gradient's max) and bf16 (2e-2,
    and within 3 bf16 roundings plus 1% of the max of the fp32
    gradients), with the forward's log-sum-exp against the plain one;
    every call twice, with equal bits.  Check the SASS (HGMMA and UTMALDG
    in the bf16 kernels, HMMA in the fp32 ones, no other design) and log
    each kernel's registers and spills.  Time it at the trainer's shape
    (fp32 and bf16) and the federated LM's, the whole call (eager, and in
    a CUDA graph) and each of its three kernels alone in a graph, beside
    the plain version, SDPA's backward (the yardstick) and the bound (5
    products over the visible pairs; on the tensor cores: 3xTF32 for
    fp32); log grid, CTAs per SM and waves.
14. The federated LM on the card: tiny_lm_long through
    ``api.build(spec).run()`` (the reference's _lm_spec scenario: seq 128,
    24 clients, 3 tiers, K=4, quantize8, 16 updates, backend flash),
    counts from 0: a flash forward and backward launch per layer per
    local step, a forward per eval chunk, 2 roundtrips per update.
15. A small tiny_lm FedAT run on the card and the CPU from the same
    params0 and permutations: global models within a relative L2 of
    1e-4.
16. The trainer (``launch/train.py``'s code path) at qwen2-7b widths cut
    to 3 layers (the machine's disk-write cap: see TRAIN_LAYERS) and a
    global batch of 8 x 4096 tokens, microbatch 8, remat, fp32 AdamW: 2
    steps ending in a checkpoint, step 3 timed and step 4 profiled in the
    same process, then a restart with ``--resume --ckpt-every 0`` that
    repeats step 3 with the same loss and writes no second checkpoint
    (only step 2's is left); flash backward launches = 3 layers x 8
    microbatches a step, forward twice that (remat); no failure caught by
    the guarded runner.  Step 3's FLOPs, counted on meta tensors as the
    dry-run counts a cell (``launch/dryrun.py`` ``step_flops``), over its
    time: the achieved TFLOP/s and ``mfu``, its share of the card's fp32
    peak ``FP32_OPS_PER_S`` (a reading, not a check).
17. FedAT under the fault plane at phase 3's width (``FAULTS``: churn,
    two tier blackouts, poisoned uplinks, update clipping, engine
    snapshots every 2 updates; 8 updates): two runs through
    ``api.build(spec).run(checkpoint_dir=...)`` must agree bitwise
    (trajectory, final global and tier models); a third run, a CLI child
    process, is killed with SIGKILL once its second snapshot is on disk
    and resumed here with ``resume_engine=True``: bitwise equal to the
    others.  Every fault family must fire (counted and logged: blackout
    starts and returns, rounds discarded into a blackout, poisoned
    rounds, clients the gate zero-weighted, clipped updates, clients
    churned out of their rounds), 2 roundtrip launches a round; 2 gated
    updates on the card against the CPU (phase 4's bound); events/s
    beside phase 3's, snapshot save, write and restore seconds, snapshot
    bytes.
18. The federated LM (phase 14's scenario) under churn, blackouts and
    poisoned uplinks through ``python -m repro_torch.api.cli --device
    cuda --checkpoint-dir`` (called in this process, counts from 0:
    phase 14's flash and roundtrip launches per committed round), then
    ``cli serve --resume-from`` of its checkpoint on the card and on the
    CPU: the same tokens, flash forward launches and no backward in the
    serving; loading it under another spec's hash is refused.
19. The population plane: FedAT quantize8 over 1,000,000 simulated
    clients on the streaming plane (``POPULATION``: the paper CNN at
    CIFAR-10 shape, K = 32, 5 tiers, availability, responsiveness and
    completion processes, 10 updates) through ``api.build(spec).run()``,
    counts from 0: exactly 2 roundtrip launches a committed round and no
    other kernel, no resident train stack, data-plane bytes within 10% of
    the same spec at 1,000 clients; the host time of each round's
    materialization and upload, the population's build time, peak host
    RSS and device memory.  The same spec at N = 256 on the stacked and
    the streaming plane bitwise equal; a small streaming run on the card
    against the CPU (phase 4's bound).
20. The topology plane: FedAT quantize8 over 2 silos x 2 edges at phase
    3's width (``TOPOLOGY``: WAN delay bands, silo skew 3, compensation
    0.5, quantize8 on all three links, 10 silo rounds), counts from 0:
    exactly 7 roundtrip launches a silo round and no other kernel, the
    per-link byte ledger equal to the host-side sum over the committed
    rounds; B1's device time in one profiled silo round.  The degenerate
    tree (1 silo, 1 edge, zero delays) at phase 4's width bitwise the flat
    run; two runs with snapshots every 2 updates and a run resumed from
    its second snapshot bitwise equal; a small tree on the card against
    the CPU (phase 4's bound).
21. MoE serving: ``launch/serve.py`` at granite-moe-3b-a800m's published
    widths and depth (``MOE_SERVE_ARGV``: 8 requests over 8 slots,
    prompts of up to 256 tokens in a 256-wide prefill, so each row is one
    routing group with capacity; 8 new tokens each), then
    deepseek-moe-16b at published widths cut to ``DEEPSEEK_LAYERS``
    layers, counts from 0 per run: one flash launch per layer per wave
    and no other kernel, no token dropped by a dropless decode routing;
    tok/s, wave and step seconds, the dropped share of each layer's
    assignments in the wave, peak memory; then one more granite wave
    timed warm and with its MoE FFNs and attention synchronised, and a
    profiled wave and decode step (busy share, GEMM and B2 time).  The moe smoke configs on the card and the CPU:
    routing of the same inputs bitwise (combine within ``ROUTE_ATOL``),
    the same engine tokens from a 256-wide prefill, prefill logits within
    a relative L2 of 1e-4.
22. vlm serving: paligemma-3b at published widths and depth
    (``VLM_WAVE``: 4 slots of 256 patch embeddings + 64 tokens through
    ``lm.serve_prefill``, then 8 greedy ``lm.serve_step`` calls), counts
    from 0: no launch at all (the prefix-LM mask takes the blocked path,
    the reference's rule); wave and step seconds.  paligemma-smoke on the
    card and the CPU: prefill logits within 1e-4, the same tokens.
23. Training the three families (``FAMILY_TRAIN``): ``launch/train.py``
    (``train.run`` with ``--ckpt-every 0``) at published widths cut to ``FAMILY_TRAIN_LAYERS`` layers and a global
    batch of 8 x 4096 (microbatch 8, remat, fp32 AdamW; two steps, no
    checkpoint), counts from 0 per arch: a flash forward per layer per
    microbatch twice (remat) and a backward, for granite and hubert (its
    non-causal); none for paligemma; aux_loss above 0 for moe only.  The
    smoke configs' loss and gradient probe (embed; frontend_proj for
    audio) on the card against the CPU, the card run launching the flash
    kernels both ways for granite and hubert.  B2 forward and backward at
    hubert's shape (``HUBERT_ATTN``, non-causal hd 80, fp32): the output,
    lse and gradients held to the plain versions, then timed beside them,
    SDPA and the bound.
24. Training the recurrent families (``RECURRENT_TRAIN``):
    ``launch/train.py`` (``train.run`` with ``--ckpt-every 0``) at
    published widths, rwkv6-3b cut to 2 layers and zamba2-2.7b to 6 (one
    shared-attention application), a global batch of 8 x 4096
    (microbatch 8, remat, fp32 AdamW; two steps, no checkpoint), counts
    from 0 per arch and exact: a step launches wkv6 32 times (8
    microbatches x 2 layers x 2 under remat) and each pass of its
    backward (``wkv6_bwd_dstate``, ``wkv6_bwd``) 16, or ssd 96, each
    pass of its backward 48 and the flash kernel 8 each way (the shared
    block, not under remat), nothing else; step seconds, tokens/s, peak
    memory; a third step under the profiler, split into the forward
    scans, the backward scans, B2 each way, the GEMMs and the rest.  The
    smoke configs' loss and every parameter's gradient on the card
    against the CPU (``RECURRENT_LOSS_RTOL``, ``RECURRENT_GRAD_RTOL``).
    The B3 and B4 backward kernels (``csrc/wkv6_bwd.cu``,
    ``csrc/ssd_bwd.cu``, no Pallas counterpart; two passes each: the
    state-gradient scan and the chunk-parallel gradients) against their
    plain versions at the training microbatch and a ragged S
    (``SCAN_BWD_RTOL``, pass 1's state gradients too) and under strong
    decays (against float64: ``SCAN_BWD_F32_FACTOR``), every call twice
    with equal bits; then timed beside the plain version and the bound,
    each pass alone with its registers, shared memory, CTAs per SM and
    waves, and the forward kernels' training and serving
    instantiations at the same shape.
25. The mesh at D == 1: phase 4's small FedAT quantize8 scenario with
    ``mesh.kind=host`` in this process (one rank, no process group)
    against the no-mesh run, counts from 0 per run: the trajectory, the
    final global and tier models bitwise, the same step keys and launch
    counts (2 roundtrips a round), no collective call.
26. The client-sharded round (``SHARDED_RANKS`` = 2 ranks started by
    ``launch/mesh.py`` ``run_ranks``, sharing the card over gloo, each
    running this script with ``--rank-phase 26``): FedAT quantize8 at
    phase 3's width with ``mesh.kind=host``, 5 of the 10 clients a rank,
    ``SHARDED_UPDATES`` updates, counts from 0 on each rank: exactly one
    roundtrip launch a link a round and one all_reduce a round; the event
    times bitwise equal on the ranks and to the one-rank run in this
    process; one round from params0 within the CPU tests' bound of the
    one-rank round; accuracy within 0.1; the ranks' global models
    bitwise equal; events/s beside phase 3's and the all_reduce's time
    (host-clocked: a gloo collective on one card goes through the host).
27. The multi-pod trainer: ``launch/train.py --multi-pod --codec
    quantize8 --fedat-sync-every 2 --ckpt-every 0`` (``train.run``) on 2
    ranks sharing the card over gloo (``--rank-phase 27``), qwen2-7b at
    published widths cut to ``TRAIN_POD_LAYERS`` layers, 2 pods of 4 x
    4096 tokens, microbatch 4, remat, fp32 AdamW, 3 steps, counts from 0
    on each rank: flash 2 x layers x microbatches forward and layers x
    microbatches backward a step, nothing else; the pods' params differ
    after step 1 and are bitwise equal after step 2's sync (checksums of
    every parameter's bits); the bytes a sync sends (int8 codes + row
    scales) against fp32, then one more step syncing at 4 bits (packed
    codes half of int8's); step seconds and peak memory per rank.
28. The trainer sharded over ``data`` (FSDP, ZeRO-3): ``launch/train.py``
    (``train.run``, ``--ckpt-every 0``) on 2 ranks sharing the card over
    gloo (``--rank-phase 28``), qwen2-7b at published widths cut to
    ``FSDP_LAYERS`` layers, a global batch of 2 x 4096 tokens (one row a
    rank, microbatch 1), remat, fp32 AdamW, ``FSDP_STEPS`` steps; then
    the same global batch on one rank in this process, replicated (2
    rows, microbatch 2).  Counts from 0 on each rank, exact a step: flash
    2 x layers forward and layers backward; FSDP gathers (one a layer
    forward and again in the recompute, the embedding and head) and
    reduce-scatters (one a gathered group), each a collective over one
    flat buffer: gloo broadcasts D a gather, all_reduces one a
    reduce-scatter plus one a whole leaf, the metrics and the norm.  Each
    rank's params + m + v bytes exactly the dry-run's ``device_bytes``
    arithmetic; the ranks' losses equal, and with the gathered final
    params within ``FSDP_LOSS_RTOL`` / ``FSDP_PARAM_ATOL`` of the one-rank
    run's; a rank's peak below the one-rank run's; state bytes, peaks,
    step seconds and the collectives' host seconds.
29. Tier stacks laid over ``pod`` (``mesh.shard_tiers``), two runs of
    ``SHARD_TIERS_UPDATES`` updates on ranks sharing the card over gloo
    (``--rank-phase 29``), each against the same spec on one rank in
    this process: phase 3's FedAT quantize8 with 4 tiers on (pod=2,
    data=2), 4 ranks, and phase 20's 2 x 2 silo tree on (pod=2, data=1),
    2 ranks.  Each rank holds only its pod's slots of the stack (2 of 4
    tiers, 1 of 2 silos) and half its bytes; event times bitwise the
    one-rank run's; the global model and the whole stack (gathered over
    pod) within ``SHARDED_ROUND_ATOL`` of the one-rank run's; counts from
    0 on each rank: the roundtrip launches of phases 26 and 20 a round,
    one all_reduce over pod a round (Eq. 3) beside Eq. 4's over data;
    events/s a rank and the pod all_reduce's host-clocked time.

Any failed check exits non-zero.  The last three lines of standard output
are the kernel report (JSON), the card's ``name, power.limit`` and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the port's
sources beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
if (ROOT / "src" / "repro_torch").is_dir():   # else main() says so
    # the card's rates and the kernels' work, shared with the dry-run
    from repro_torch.kernels.build import (  # noqa: E402
        BF16_OPS_PER_S, FP32_OPS_PER_S, HBM_BYTES_PER_S, TF32_OPS_PER_S,
        bound as _bound)
    from repro_torch.kernels.flash_attention import (  # noqa: E402
        attention_bound, attention_bwd_bound)
    from repro_torch.kernels.rwkv6_scan import (  # noqa: E402
        bwd_flops as wkv6_bwd_flops, flops as wkv6_flops)
    from repro_torch.kernels.ssd import (  # noqa: E402
        bwd_flops as ssd_bwd_flops, flops as ssd_flops)
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


def roundtrip_trees(torch, dev, params_shapes, K, bits):
    """(name, leaves) trees the fused roundtrip is held on."""
    g = torch.Generator(device=dev).manual_seed(2)

    def rnd(n, s=1.0):
        return torch.randn(n, device=dev, generator=g) * s
    shapes = list(params_shapes.values())
    z = rnd(1024)
    z[256:512] = 0.0
    nan = rnd(1000)
    nan[300] = float("nan")
    inf = rnd(768)           # +inf in block 0, -inf in block 1, block 2 finite
    inf[5], inf[300] = float("inf"), -float("inf")
    big = rnd(4097)
    return [
        ("cnn_downlink", [rnd(math.prod(s), 0.05) for s in shapes]),
        (f"cnn_uplink_K{K}", [rnd(K * math.prod(s), 0.05) for s in shapes]),
        ("cases", [rnd(1), rnd(255), rnd(257), z, tie_case(torch, dev, bits),
                   nan]),
        ("inf", [inf]),
        ("not_multiple_of_4", [rnd(n) for n in (5, 7, 258, 1023, 771)]),
        # views 4 and 12 bytes past a 16-byte boundary: the scalar path
        ("unaligned_view", [big[1:], big[3:1004]]),
        ("many_leaves", [rnd(1 + (37 * i) % 700) for i in range(150)]),
    ]


def compare_roundtrip(torch, pc, ref, dev, params_shapes, K):
    """The fused roundtrip bitwise against the kernel pair (leaf by leaf)
    and the plain version, with its launches per tree."""
    err, n_leaves, inf_note = 0.0, 0, None
    for bits in (8, 16):
        for name, leaves in roundtrip_trees(torch, dev, params_shapes, K,
                                            bits):
            before = pc.launch_counts()["roundtrip"]
            outs = pc.roundtrip_blocks(leaves, bits)
            launches = pc.launch_counts()["roundtrip"] - before
            plan, _ = pc.segment_table([x.numel() for x in leaves])
            check(launches == len(plan) == -(-len(leaves) // 64),
                  f"roundtrip of {name} made {launches} launches for "
                  f"{len(leaves)} leaves")
            plain = ref.roundtrip_blocks(leaves, bits)
            pair = [pc.decompress_blocks(*pc.compress_blocks(x, bits),
                                         x.numel()) for x in leaves]
            torch.cuda.synchronize()
            for i, (o, p, r) in enumerate(zip(outs, pair, plain)):
                check(bits_equal(o, p), f"roundtrip differs from the kernel "
                      f"pair ({name} leaf {i}, {bits} bits)")
                if not bits_equal(o, r):
                    # only where the pair disagrees with the plain version
                    # as well (the +-inf block), and then it is logged
                    check(name == "inf" and not bits_equal(p, r),
                          f"roundtrip differs from the plain version "
                          f"({name} leaf {i}, {bits} bits)")
                    inf_note = (f"{bits} bits: kernels {o[:8].tolist()} "
                                f"plain {r[:8].tolist()}")
                    log(f"phase 2: kernels and plain version disagree on "
                        f"the +-inf block: {inf_note}")
                fin = torch.isfinite(o) & torch.isfinite(r)
                if fin.any():
                    err = max(err, float((o[fin] - r[fin]).abs().max()))
                n_leaves += 1
            if name == "inf":
                log(f"phase 2: +-inf block, {bits} bits: the inf blocks come "
                    f"out NaN {[bool(outs[0][b * 256:(b + 1) * 256].isnan().all()) for b in range(3)]}, "
                    f"the finite block finite "
                    f"{bool(outs[0][512:].isfinite().all())}")
    log(f"phase 2: roundtrip bitwise equal to the kernel pair and the plain "
        f"version on {n_leaves} leaves (8 and 16 bits; CNN downlink and "
        f"K={K} uplink, tails, zero, tie, NaN and +-inf blocks, sizes not "
        f"multiples of 4, unaligned views, 150 leaves in 3 launches)")
    return {"max_abs_err": err, "leaves_checked": n_leaves,
            "inf_disagreement": inf_note}


L2_BYTES = 50e6                # H100 L2 cache


def time_roundtrip(torch, pc, ref, dev, params_shapes, K, bits=8):
    """The fused roundtrip per uplink (K stacked clients) and downlink tree
    against the kernel pair (2 launches a leaf), the plain version, an
    empty kernel (the launch floor) and a yardstick (amax and
    fake_quantize_per_channel_affine on each leaf's padded (nb, 256) view:
    not bitwise, it multiplies by the scale's reciprocal; never called by
    the port).  Cold: each CUDA graph rotates over enough copies of the
    tree that the inputs alone exceed L2; warm: the same calls on one copy.
    The yardstick is timed eagerly: it reads its zero points on the host,
    which a graph cannot capture."""
    import torch.nn.functional as F
    out = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ctas = pc.roundtrip_ctas_per_sm()
    check(ctas > 0, f"no roundtrip CTA fits on an SM ({ctas})")
    qmax = (1 << (bits - 1)) - 1
    inv = torch.ones((), device=dev) / float(qmax)
    for link, stack in (("uplink", K), ("downlink", 1)):
        g = torch.Generator(device=dev).manual_seed(3)
        sizes = [stack * math.prod(s) for s in params_shapes.values()]
        n_vals = sum(sizes)
        copies = math.ceil(L2_BYTES / (4 * n_vals)) + 1
        trees = [[torch.randn(n, device=dev, generator=g) * 0.05
                  for n in sizes] for _ in range(copies)]
        grid = pc.roundtrip_grid(trees[0])

        def rt_cold():
            return [pc.roundtrip_blocks(t, bits) for t in trees]

        def rt_warm():
            for _ in trees:
                pc.roundtrip_blocks(trees[0], bits)

        def pair(t):
            return [pc.decompress_blocks(*pc.compress_blocks(x, bits),
                                         x.numel()) for x in t]

        def pair_cold():
            return [pair(t) for t in trees]

        def pair_warm():
            for _ in trees:
                pair(trees[0])

        def plain_cold():
            return [ref.roundtrip_blocks(t, bits) for t in trees]

        def floor():
            for _ in trees:
                pc.empty_launch()

        padded = [[F.pad(x, (0, -x.numel() % 256)).reshape(-1, 256)
                   for x in t] for t in trees]
        zps = [torch.zeros(x.shape[0], dtype=torch.int32, device=dev)
               for x in padded[0]]

        def yardstick():
            for t in padded:
                for x, zp in zip(t, zps):
                    sc = (x.abs().amax(1) * inv).clamp_min(1e-30)
                    torch.fake_quantize_per_channel_affine(
                        x, sc, zp, 0, -qmax, qmax)

        # plain and the pair before and after the roundtrip runs: the
        # order cancels drift; times per tree, the best run kept
        t = {}
        for key, fn in (("plain", plain_cold), ("pair", pair_cold),
                        ("cold", rt_cold), ("warm", rt_warm),
                        ("floor", floor), ("cold", rt_cold),
                        ("warm", rt_warm), ("pair_warm", pair_warm),
                        ("pair", pair_cold), ("pair_warm", pair_warm),
                        ("plain", plain_cold)):
            t.setdefault(key, []).append(graph_time_ms(torch, fn, 20)
                                         / copies)
        t["yardstick"] = [event_time_ms(torch, yardstick, 3) / copies]
        best = {k: min(v) for k, v in t.items()}
        nbytes = 8 * n_vals
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        res = {
            "ms": best["cold"], "warm_ms": best["warm"],
            "pair_ms": best["pair"], "pair_warm_ms": best["pair_warm"],
            "plain_ms": best["plain"], "floor_ms": best["floor"],
            "yardstick_ms": best["yardstick"], "runs": t,
            "bound_ms": bound, "bound_by": "bytes", "bytes": nbytes,
            "values": n_vals, "leaves": len(sizes), "copies": copies,
            "share_of_bound": bound / best["cold"],
            "speedup_vs_pair": best["pair"] / best["cold"],
            "grid": grid, "ctas_per_sm": ctas, "sms": sms,
            "waves": [c / (ctas * sms) for c in grid]}
        out[link] = res
        log(f"phase 2: roundtrip {link} ({n_vals} values, {len(sizes)} "
            f"leaves, one launch: grid {grid} CTAs of 4 warps, {ctas} CTAs "
            f"an SM, {res['waves'][0]:.3f} waves): cold {res['ms']:.5f} ms "
            f"(runs {', '.join(f'{x:.5f}' for x in t['cold'])}; "
            f"{copies} copies), warm {res['warm_ms']:.5f} ms; pair "
            f"({2 * len(sizes)} launches) cold {res['pair_ms']:.5f} / warm "
            f"{res['pair_warm_ms']:.5f} ms ({res['speedup_vs_pair']:.2f}x); "
            f"plain {res['plain_ms']:.5f} ms; empty kernel "
            f"{res['floor_ms']:.5f} ms; yardstick (eager amax + "
            f"fake_quantize_per_channel_affine) {res['yardstick_ms']:.5f} "
            f"ms; bound {bound:.6f} ms ({nbytes} B at 3.35 TB/s), cold at "
            f"{100 * res['share_of_bound']:.1f}% of it"
            + ("; warm beats the HBM bound (L2-resident)"
               if res["warm_ms"] < bound else ""))
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
    # 2 lossy steps (downlink + uplink) per committed round, one launch each
    expect = 2 * rounds
    check(rounds == 10, f"{rounds} FedAT rounds ran, expected 10")
    check(counts == {"compress": 0, "decompress": 0, "roundtrip": expect,
                     "flash_attention": 0, "flash_attention_bwd": 0,
                     "wkv6": 0, "wkv6_bwd_dstate": 0, "wkv6_bwd": 0,
                     "ssd": 0, "ssd_bwd_dstate": 0, "ssd_bwd": 0},
          f"launch counts {counts}, expected {expect} roundtrip launches "
          f"(2 links x {rounds} rounds, {n_leaves} leaves a launch) and no "
          f"other")
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


def card_vs_cpu(torch, api, SimEnv, dev, extra=None, phase="4",
                what="2 FedAT quantize8 updates"):
    """Relative L2 of card - CPU over the CPU params' norm; the tolerance
    is the CPU tests' quantize8 bound: fp32 products summed in another
    order can move a value across a code boundary, a step of
    max|block|/127.  ``extra`` overrides the SMALL spec (phase 17 turns
    the fault plane's gate on)."""
    spec = api.ExperimentSpec().with_overrides(dict(SMALL, **(extra or {})))
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
    log(f"phase {phase}: card vs CPU after {what}: "
        f"|card - cpu| / |cpu| = {rel} (tolerance {CARD_VS_CPU_RTOL})")
    for k, v in rel.items():
        check(v <= CARD_VS_CPU_RTOL, f"card and CPU disagree on {k}: {v}")
    return rel


def profile_round(torch, run, pc, round_ms: float):
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
    before = pc.launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ex.fedat_round(st.w_global, st.tier_models, 0, ids, 12345,
                       codec=st.codec, use_prox=True, cross_weights=cw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    codec_launches = {k: n - before[k] for k, n in pc.launch_counts().items()
                      if k in ("compress", "decompress", "roundtrip")}
    per_kernel, calls = {}, {}
    for e in prof.key_averages():
        # kernel events only: a CPU op's self device time repeats the
        # time of the kernels it launched
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        per_kernel[e.key] = per_kernel.get(e.key, 0.0) + \
            e.self_device_time_total / 1e3
        calls[e.key] = calls.get(e.key, 0) + e.count
    dev_ms = sum(per_kernel.values())
    if dev_ms == 0:
        log("phase 3: profiler saw no kernel time: busy share not measured")
        return {"profiled_wall_ms": wall_ms, "device_ms": None,
                "codec_launches": codec_launches}
    codec = [k for k in per_kernel
             if "compress_kernel" in k or "roundtrip_kernel" in k]
    codec_ms = sum(per_kernel[k] for k in codec)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    info = {"profiled_wall_ms": wall_ms, "device_ms": dev_ms,
            "round_ms": round_ms, "busy_share": dev_ms / round_ms,
            "codec_ms": codec_ms, "codec_share_of_device": codec_ms / dev_ms,
            "codec_launches": codec_launches,
            "codec_kernel_events": sum(calls[k] for k in codec),
            "n_kernels": len(per_kernel),
            "top_kernels_ms": {k[:100]: t for k, t in top}}
    log(f"phase 3: profiled round: kernels {dev_ms:.1f} ms of device time "
        f"against a {round_ms:.1f} ms round (busy "
        f"{100 * info['busy_share']:.1f}%, idle "
        f"{100 * (1 - info['busy_share']):.1f}%); codec kernels "
        f"{codec_ms:.4f} ms ({100 * info['codec_share_of_device']:.4f}% of "
        f"device time) in {info['codec_kernel_events']} kernel events, "
        f"launches {codec_launches}; profiled wall {wall_ms:.1f} ms")
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
        check(counts["roundtrip"] > 0 and counts["compress"] == 0
              and counts["decompress"] == 0,
              f"{name}: the lossy step did not run the roundtrip kernel "
              f"alone: {counts}")
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
#: the shapes the serving paths give the kernel, checked and timed: a
#: qwen2-7b prefill wave (8 slots x 1024 tokens) and the zamba2-2.7b
#: shared attention block at the same wave (32 heads of 80, no GQA)
ATTN_SHAPES = {
    "qwen2-7b prefill": dict(B=8, S=1024, H=28, KV=4, hd=128),
    "zamba2-2.7b shared block": dict(B=8, S=1024, H=32, KV=32, hd=80),
    # one 4096-token microbatch of the trainer (phase 16)
    "qwen2-7b training": dict(B=1, S=4096, H=28, KV=4, hd=128),
}
#: the shapes the moe, audio and hybrid paths give the kernel (phases 21,
#: 23 and 24), checked against the plain version here beside ATTN_CASES:
#: a granite and a deepseek prefill wave (8 slots x 256 tokens; GQA 24/8
#: at hd 64, MHA at hd 128) and one 4096-token training microbatch of
#: granite, of hubert (bidirectional at hd 80) and of zamba2's shared
#: block (32 heads of 80)
PATH_ATTN_SHAPES = {
    "granite-moe-3b prefill wave": dict(B=8, S=256, H=24, KV=8, hd=64,
                                        causal=True),
    "deepseek-moe-16b prefill wave": dict(B=8, S=256, H=16, KV=16, hd=128,
                                          causal=True),
    "granite-moe-3b training": dict(B=1, S=4096, H=24, KV=8, hd=64,
                                    causal=True),
    "hubert-xlarge training": dict(B=1, S=4096, H=16, KV=16, hd=80,
                                   causal=False),
    "zamba2-2.7b training": dict(B=1, S=4096, H=32, KV=32, hd=80,
                                 causal=True),
}
#: the forward's lse against the plain blocked version's (absolute): the
#: phase-13 cases measured at most 1.43e-6 on an H100
LSE_ATOL = 2e-5
#: SASS instructions counted in the built kernels: the wgmma products
#: (HGMMA) and TMA tile loads (UTMALDG) the bf16 flash design must
#: contain, and the mma.sync products (HMMA) of the chunk scans
TC_OPCODES = ("HGMMA", "UTMALDG", "HMMA")


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


def sass_counts(lib_path: str) -> dict:
    """{kernel symbol: {opcode: count}} for TC_OPCODES, from ``cuobjdump
    -sass`` of a built library."""
    from repro_torch.kernels import build as kbuild
    tool = Path(kbuild._nvcc()).with_name("cuobjdump")
    res = subprocess.run([str(tool), "-sass", lib_path], capture_output=True,
                         text=True)
    check(res.returncode == 0, f"cuobjdump -sass failed: {res.stderr}")
    out, fn = {}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            out[fn] = dict.fromkeys(TC_OPCODES, 0)
        elif fn is not None:
            for op in TC_OPCODES:
                out[fn][op] += op in line
    return out


def check_flash(torch, fa, ref, lib_path):
    """Kernel vs plain version on every case and dtype; then times at the
    serving shapes.  Returns {dtype: {...}, "sass": {kernel: counts}}."""
    sass = sass_counts(lib_path)
    tc = {fn: c for fn, c in sass.items() if "wgmma" in fn}
    ffma = {fn: c for fn, c in sass.items() if "ffma" in fn}
    check(tc and all(c["HGMMA"] > 0 and c["UTMALDG"] > 0
                     for c in tc.values()),
          f"the bf16 kernels lack wgmma or TMA instructions: {tc}")
    check(ffma and all(sum(c.values()) == 0 for c in ffma.values()),
          f"the fp32 kernels use tensor cores or TMA: {ffma}")
    for fn, c in sorted(tc.items()):
        m = re.search(r"(flash_fwd_\w+?_kernel)ILi(\d+)E", fn)
        log(f"phase 6: SASS of {m[1]}<{m[2]}>: {c['HGMMA']} HGMMA, "
            f"{c['UTMALDG']} UTMALDG" if m else f"phase 6: SASS of {fn}: {c}")
    g = torch.Generator(device="cuda").manual_seed(6)
    cases = [(c, 2) for c in ATTN_CASES] + \
        [((P["S"], P["S"], P["H"], P["KV"], P["hd"], True, None), P["B"])
         for P in ATTN_SHAPES.values()] + \
        [((P["S"], P["S"], P["H"], P["KV"], P["hd"], P["causal"], None),
          P["B"]) for P in PATH_ATTN_SHAPES.values()]
    out = {"sass": sass}
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
        o = out[dtype] = {"max_abs_err": worst, "cases": len(cases),
                          "shapes": {}}
        rounding = ""
        if dtype == "bfloat16":
            o["bf16_rounding_ratio"] = worst_round
            rounding = (f", within one bf16 rounding of the fp32 result "
                        f"(worst ratio {worst_round:.3g} <= 1)")
        log(f"phase 6: flash {dtype}: {len(cases)} shapes within "
            f"{ATTN_TOL[dtype]} of the plain version (max abs err "
            f"{worst:.3g}){rounding}")
        for name, P in ATTN_SHAPES.items():
            o["shapes"][name] = time_flash(torch, fa, ref, g, P, dtype)
            t = o["shapes"][name]
            lib = t["library_ms"]
            log(f"phase 6: flash {dtype} {name} B={P['B']} S=T={P['S']} "
                f"H={P['H']} KV={P['KV']} hd={P['hd']} causal: kernel "
                f"{t['ms']:.4f} ms (runs {t['ms_runs'][0]:.4f}/"
                f"{t['ms_runs'][1]:.4f}), plain {t['plain_ms']:.4f} ms, SDPA "
                f"{'n/a' if lib is None else f'{lib:.4f}'} ms, bound "
                f"{t['bound_ms']:.4f} ms ({t['bound_by']}: "
                f"{t['flops'] / 1e9:.1f} GFLOP, {t['bytes'] / 1e6:.1f} MB);"
                f" achieved {t['flops'] / t['ms'] / 1e9:.2f} TFLOP/s"
                + (f"; SDPA unavailable: {t['library_note']}"
                   if t["library_note"] else ""))
    out["layouts_max_abs_err"] = check_flash_layouts(torch, fa, ref, g)
    torch.cuda.empty_cache()
    return out


def flash_layouts(torch, g):
    """Operands that take the designs' other paths, as (name, q, k, v,
    causal, window): fp32 with head dims that are not multiples of 4 and
    a misaligned pointer (4-byte copies); bf16 sliced from padded rows
    with hd not a multiple of 8 (element-wise output stores), a q read
    through (B, H, S, hd) memory and K/V sliced from one fused tensor
    (strides in no order), cross attention and S > T."""
    def rnd(*shape, dt="float32"):
        return torch.randn(*shape, device="cuda", generator=g).to(
            getattr(torch, dt))
    B, S, H, KV = 2, 200, 4, 2
    out = [(f"fp32 hd {hd}", rnd(B, S, H, hd), rnd(B, S, KV, hd),
            rnd(B, S, KV, hd), True, None) for hd in (1, 6, 17)]
    out.append(("fp32 misaligned q", rnd(B * S * H * 64 + 1)[1:].view(
        B, S, H, 64), rnd(B, S, KV, 64), rnd(B, S, KV, 64), True, 37))
    for hd in (4, 12, 100):
        pad = -(-hd // 8) * 8 + 8
        q, k, v = (rnd(B, S, n, pad, dt="bfloat16")[..., :hd]
                   for n in (H, KV, KV))
        out.append((f"bf16 padded hd {hd}", q, k, v, True, 37))
    kv = rnd(B, S, 2, KV, 64, dt="bfloat16")
    out.append(("bf16 (B, H, S, hd) q, fused K/V",
                rnd(B, H, S, 64, dt="bfloat16").transpose(1, 2),
                kv[:, :, 0], kv[:, :, 1], True, None))
    for dt in ("float32", "bfloat16"):
        out.append((f"{dt} cross attention", rnd(B, 77, H, 64, dt=dt),
                    rnd(B, 333, KV, 64, dt=dt), rnd(B, 333, KV, 64, dt=dt),
                    False, None))
        out.append((f"{dt} S > T", rnd(B, 300, H, 64, dt=dt),
                    rnd(B, 130, KV, 64, dt=dt), rnd(B, 130, KV, 64, dt=dt),
                    True, None))
    return out


def check_flash_layouts(torch, fa, ref, g):
    """The kernel against its plain version on :func:`flash_layouts`, and
    the wrapper's refusal of a bf16 operand that breaks TMA's rule."""
    worst, cases = {}, flash_layouts(torch, g)
    for name, q, k, v, causal, window in cases:
        dtype = str(q.dtype).split(".")[1]
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = ref.attention_gqa(q, k, v, causal=causal, window=window)
        err = float((got.float() - want.float()).abs().max())
        check(bool(torch.isfinite(got).all()) and err < ATTN_TOL[dtype],
              f"flash kernel vs plain, {name}: max abs err {err}")
        if dtype == "bfloat16":
            want32 = ref.attention_gqa(q.float(), k.float(), v.float(),
                                       causal=causal, window=window)
            excess = float(((got.float() - want32).abs()
                            / (BF16_ROUND_REL * want32.abs()
                               + ATTN_TOL["float32"])).max())
            check(excess <= 1.0, f"flash kernel bf16, {name}: not the fp32 "
                  f"result rounded to bf16 (ratio {excess})")
        worst[dtype] = max(worst.get(dtype, 0.0), err)
    x = torch.zeros(2, 8, 2, 6, device="cuda", dtype=torch.bfloat16)
    try:
        fa.flash_attention(x, x, x)
        fail("flash_attention took a bf16 operand TMA cannot load")
    except ValueError as e:
        check("multiples of 8 elements" in str(e), f"refusal: {e}")
    log(f"phase 6: flash on {len(cases)} other layouts (head dims off the "
        f"aligned paths, a misaligned pointer, strides in no order, cross "
        f"attention, S > T) within tolerance of the plain version (max abs "
        f"err {worst}); a bf16 hd-6 tensor is refused naming TMA's rule")
    return worst


def time_flash(torch, fa, ref, g, P, dtype, causal=True):
    """Kernel (first held to the plain version within ATTN_TOL), plain
    version and SDPA (the yardstick, never called by the port) at one
    shape, beside the bound."""
    q, k, v = attn_inputs(torch, g, P["B"], P["S"], P["S"], P["H"], P["KV"],
                          P["hd"], dtype)
    kern = lambda: fa.flash_attention(q, k, v, causal=causal)  # noqa: E731
    plain = lambda: ref.attention_gqa(q, k, v, causal=causal)  # noqa: E731
    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    check(bool(torch.isfinite(got).all()) and err < ATTN_TOL[dtype],
          f"flash kernel vs plain at {P} causal={causal} {dtype}: max abs "
          f"err {err}")
    del got, want

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, enable_gqa=True)
    note = None
    try:
        lib = library()
        torch.cuda.synchronize()
        lib_err = float((lib.transpose(1, 2).float()
                         - kern().float()).abs().max())
    except Exception as e:  # the yardstick only: never on the path
        lib, lib_err, note = None, None, f"{type(e).__name__}: {e}"
    # plain, kernel, kernel, plain (library between): cancels drift
    p1 = event_time_ms(torch, plain, 3)
    k1 = event_time_ms(torch, kern)
    l1 = event_time_ms(torch, library) if lib is not None else None
    k2 = event_time_ms(torch, kern)
    p2 = event_time_ms(torch, plain, 3)
    b = attention_bound(P["B"], P["S"], P["S"], P["H"], P["KV"], P["hd"],
                        causal, None, dtype)
    return dict(b, ms=min(k1, k2), ms_runs=[k1, k2], plain_ms=min(p1, p2),
                plain_ms_runs=[p1, p2], library_ms=l1, max_abs_err=err,
                library_vs_kernel_max_abs=lib_err, library_note=note)


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
    check(counts["compress"] == 0 and counts["decompress"] == 0
          and counts["roundtrip"] == 0
          and counts["wkv6"] == 0 and counts["ssd"] == 0,
          f"codec or scan kernels ran while serving qwen2-7b: {counts}")
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
    """Every tensor of a tree of dicts and (named) tuples."""
    if isinstance(tree, (dict, tuple)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
            yield from _leaves(v)
    else:
        yield tree


def profile_serving(torch, engine, info, tag="7"):
    """One more prefill wave and one decode step of the full-width engine
    under torch.profiler (outside the counted run): kernel time by kernel
    (flash and GEMM summed) and the device busy share against the
    unprofiled medians."""
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
            log(f"phase {tag}: profiler saw no kernel time in {name}: busy "
                f"share not measured")
            out[name] = {"device_ms": None}
            continue
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
        flash_ms = sum(t for k, t in per_kernel.items() if "flash" in k)
        gemm_ms = sum(t for k, t in per_kernel.items()
                      if "gemm" in k.lower())
        out[name] = {"device_ms": dev_ms, "call_ms": 1e3 * base_s,
                     "busy_share": dev_ms / (1e3 * base_s),
                     "flash_ms": flash_ms, "gemm_ms": gemm_ms,
                     "n_kernels": len(per_kernel),
                     "top_kernels_ms": {k[:100]: t for k, t in top}}
        o = out[name]
        log(f"phase {tag}: profiled {name}: kernels {dev_ms:.2f} ms against "
            f"a {o['call_ms']:.2f} ms unprofiled call (busy "
            f"{100 * o['busy_share']:.1f}%, idle "
            f"{100 * (1 - o['busy_share']):.1f}%); flash {flash_ms:.3f} ms "
            f"({100 * flash_ms / dev_ms:.2f}%), GEMM {gemm_ms:.3f} ms "
            f"({100 * gemm_ms / dev_ms:.1f}% of kernel time)")
        for k, t in top:
            log(f"  {t:10.3f} ms  {k[:100]}")
    return out


#: phase 7's bf16 wave: one qwen2-7b prefill of 8 prompts of 1024 tokens
#: through the prototype Server in bf16, the kernel's tensor-core design
BF16_WAVE = dict(slots=8, prompt=1024, seed=0)


def run_bf16_wave(torch, kernels, serve_launch, lm):
    """qwen2-7b at full width in bf16 through the prototype Server: one
    counted prefill wave (one flash launch per layer, finite logits), one
    more timed, and one under torch.profiler for flash's share of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.registry import get_config
    cfg = get_config("qwen2-7b")
    B, P = BF16_WAVE["slots"], BF16_WAVE["prompt"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    server = serve_launch.Server(cfg, batch_slots=B, max_len=P + 8,
                                 seed=BF16_WAVE["seed"],
                                 dtype=torch.bfloat16, device="cuda")
    check(all(t.is_cuda and t.dtype == torch.bfloat16
              for t in _leaves(server.params)),
          "bf16 Server: params not bf16 on the card")
    rng = np.random.default_rng(BF16_WAVE["seed"])
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, P)),
                           dtype=torch.int32, device="cuda")

    def wave():
        with torch.no_grad():
            return lm.serve_prefill(cfg, server.params, {"tokens": toks}, 1,
                                    server.cache)[0]
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    logits = wave()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    check(counts["flash_attention"] == cfg.n_layers == 28
          and all(n == 0 for k, n in counts.items()
                  if k != "flash_attention"),
          f"bf16 wave launches {counts}, expected 28 flash and nothing else")
    check(logits.dtype == torch.bfloat16 and logits.shape[0] == B
          and bool(torch.isfinite(logits.float()).all()),
          f"bf16 wave logits {tuple(logits.shape)} {logits.dtype} not "
          f"finite")
    t0 = time.perf_counter()
    wave()
    torch.cuda.synchronize()
    wave_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wave()
        torch.cuda.synchronize()
    per_kernel = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            per_kernel[e.key] = per_kernel.get(e.key, 0.0) + \
                e.self_device_time_total / 1e3
    dev_ms = sum(per_kernel.values())
    flash_ms = sum(t for k, t in per_kernel.items() if "flash_fwd" in k)
    info = {"wave_s": wave_s, "launches": counts,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "device_ms": dev_ms or None, "flash_ms": flash_ms,
            "top_kernels_ms": {k[:100]: t for k, t in sorted(
                per_kernel.items(), key=lambda kv: -kv[1])[:6]}}
    share = (f"flash {flash_ms:.3f} ms of {dev_ms:.2f} ms of kernels "
             f"({100 * flash_ms / dev_ms:.2f}%), busy "
             f"{100 * dev_ms / (1e3 * wave_s):.1f}%" if dev_ms else
             "profiler saw no kernel time: flash share not measured")
    log(f"phase 7: qwen2-7b bf16 Server prefill wave (8 x 1024 tokens): "
        f"{counts['flash_attention']} flash launches, finite logits; wave "
        f"{wave_s:.4f} s; {share}; peak "
        f"{info['peak_mem_bytes'] / 2**30:.2f} GiB")
    for k, t in list(info["top_kernels_ms"].items()):
        log(f"  {t:10.3f} ms  {k}")
    del server, logits
    torch.cuda.empty_cache()
    return info


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


# ---------------------------------------------------------------------------
# phase 9: the chunk-scan kernels against their plain versions
# ---------------------------------------------------------------------------

# the reference's sweeps (tests/test_kernels.py): (BH, S, N, chunk) and
# (BH, S, P, N, chunk), at the reference's tolerances against the
# token-level oracles
WKV_CASES = [(2, 64, 16, 32), (3, 100, 16, 32), (1, 256, 32, 64),
             (4, 33, 8, 16)]
SSD_CASES = [(2, 64, 16, 8, 32), (3, 100, 32, 16, 32), (1, 256, 64, 64, 64)]
WKV_TOL = {"float32": 5e-4, "bfloat16": 5e-2}
SSD_TOL = {"float32": 5e-4, "bfloat16": 1e-1}
#: kernel against the chunked plain version from a nonzero state, as
#: max |err| / max |want| over y and over the final state: fp32 sums in
#: another order agree to a few ulps of the largest value; bf16 outputs
#: round once to bf16 (2^-8 relative), the state stays fp32
SCAN_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}
#: the prefill waves' scan shapes: rwkv6-3b (8 slots x 1024 tokens, 40
#: heads of 64) and zamba2-2.7b (80 SSD heads, P = N = 64)
WKV_FULL = dict(B=8, S=1024, H=40, N=64)
SSD_FULL = dict(B=8, S=1024, H=80, P=64, N=64)
#: smaller shapes in the models' own layouts: several heads sharing u
#: (rwkv6) and B/C (mamba2), a ragged last chunk
WKV_MODEL_CASES = [dict(B=2, S=100, H=4, N=16), dict(B=3, S=70, H=5, N=64)]
SSD_MODEL_CASES = [dict(B=2, S=100, H=8, P=16, N=16),
                   dict(B=2, S=77, H=6, P=64, N=64)]
#: full width with an S that is not a multiple of the kernels' chunk
WKV_RAGGED = dict(B=2, S=1000, H=40, N=64)
SSD_RAGGED = dict(B=2, S=1000, H=80, P=64, N=64)
SCAN_CHUNK = 32   # both kernels' own chunk (csrc/chunk_scan.cuh kChunk)
#: the chunk the bounds are counted at, fixed whatever chunk the kernels
#: take, so that bounds stay comparable across designs
BOUND_CHUNK = 32
SSD_MODEL_CHUNK = 128   # zamba2-2.7b's configured chunk, the plain path's


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def _randn(torch, g):
    return lambda *s: torch.randn(*s, device="cuda", generator=g)


def wkv_inputs(torch, g, B, S, H, N, dtype, strong=False):
    dt, rnd = getattr(torch, dtype), _randn(torch, g)
    r, k, v = (rnd(B, S, H, N).to(dt) for _ in range(3))
    logw = (torch.full((B, S, H, N), -8.0, device="cuda") if strong
            else -torch.exp(rnd(B, S, H, N)))
    return r, k, v, logw, rnd(H, N), rnd(B, H, N, N)


def ssd_inputs(torch, g, B, S, H, P, N, dtype):
    dt, rnd = getattr(torch, dtype), _randn(torch, g)
    return (rnd(B, S, H, P).to(dt), rnd(B, S, N).to(dt),
            rnd(B, S, N).to(dt), -rnd(B, S, H).abs(), rnd(B, H, P, N))


def wkv_bound(B, S, H, N, dtype):
    """Least time for one launch: r, k, v, y (dtype) and logw (f32) moved
    once, the state read and written once; operations of the chunked form
    at BOUND_CHUNK (a multiply-add counts 2, an exp 1): per chunk
    (r exp(cum_prev)) @ S and the state update (2 C N^2 multiply-adds), the
    strictly-lower pairwise decayed products and their product with v
    (C(C-1)/2 N each), the bonus (2 C N), and C(C-1)/2 N + 2 C N exps."""
    size = 4 if dtype == "float32" else 2
    nbytes = (4 * size + 4) * B * S * H * N + 8 * B * H * N * N + 4 * H * N
    C = BOUND_CHUNK
    pairs = C * (C - 1) // 2
    flops = (wkv6_flops(B, S, H, N, C)
             + B * H * (-(-S // C)) * (pairs * N + 2 * C * N))
    return _bound(nbytes, flops, dtype)


def ssd_bound(B, S, H, P, N, dtype):
    """Least time for one launch: x, y (B,S,H,P), B, C (B,S,N) in dtype
    and da (f32) moved once, h read and written once; operations of the
    chunked form at BOUND_CHUNK: C.h and the state update (2 C P N
    multiply-adds per head), the visible C.B products once per batch row
    and chunk (C(C+1)/2 N: B and C are shared by the heads, though the
    kernel rebuilds them per head), their product with x (C(C+1)/2 P per
    head), and C(C+1)/2 + 2 C exps per head."""
    size = 4 if dtype == "float32" else 2
    nbytes = (size * (2 * B * S * H * P + 2 * B * S * N) + 4 * B * S * H
              + 8 * B * H * P * N)
    C = BOUND_CHUNK
    vis = C * (C + 1) // 2
    flops = (ssd_flops(B, S, H, P, N, C)
             + B * (-(-S // C)) * H * (vis + 2 * C))
    return _bound(nbytes, flops, dtype)


def scan_sass(lib_path: str, name: str) -> dict:
    """SASS counts of a scan kernel's instantiations; each must hold mma.sync
    products on the tensor cores (HMMA)."""
    sass = {fn: c for fn, c in sass_counts(lib_path).items() if name in fn}
    check(sass and all(c["HMMA"] > 0 for c in sass.values()),
          f"the {name} kernels lack tensor-core (HMMA) instructions: {sass}")
    for fn, c in sorted(sass.items()):
        kind = "bf16" if "bfloat16" in fn else "fp32"
        log(f"phase 9: SASS of {name} ({kind} inputs): {c['HMMA']} HMMA")
    return sass


def scan_grid(torch, scan, dtype, grid: int) -> dict:
    """The launch's grid (one CTA per (batch, head)), the CTAs that fit on
    an SM and the waves the grid takes on the card."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ctas = scan.ctas_per_sm(getattr(torch, dtype))
    check(ctas > 0, f"{scan.__name__}: no CTA fits on an SM ({ctas})")
    return {"grid": grid, "ctas_per_sm": ctas, "sms": sms,
            "waves": grid / (ctas * sms)}


def _time_pair(torch, kern, plain):
    """plain, kernel, kernel, plain: the order cancels drift."""
    p1 = event_time_ms(torch, plain, 3)
    k1 = event_time_ms(torch, kern)
    k2 = event_time_ms(torch, kern)
    p2 = event_time_ms(torch, plain, 3)
    return {"ms": min(k1, k2), "ms_runs": [k1, k2], "plain_ms": min(p1, p2),
            "plain_ms_runs": [p1, p2]}


def check_wkv6(torch, ops, scan, ref, lib_path):
    """B3 against its plain versions on the card; times at the rwkv6-3b
    prefill shape.  Returns {dtype: {...}, "sass": {kernel: counts}}."""
    g = torch.Generator(device="cuda").manual_seed(9)
    rnd = _randn(torch, g)
    out = {"sass": scan_sass(lib_path, "wkv6_kernel")}
    for dtype in ("float32", "bfloat16"):
        worst_oracle, worst_rel = 0.0, 0.0
        dt = getattr(torch, dtype)
        for BH, S, N, chunk in WKV_CASES:
            r, k, v = (rnd(BH, S, N).to(dt) for _ in range(3))
            logw, u = -torch.exp(rnd(BH, S, N)), rnd(BH, N)
            got = ops.wkv6(r, k, v, logw, u, chunk=chunk)
            want = ref.wkv6(r, k, v, logw, u)
            torch.cuda.synchronize()
            check(got.shape == want.shape and got.dtype == dt,
                  f"wkv6 output {tuple(got.shape)} {got.dtype}")
            err = float((got.float() - want.float()).abs().max())
            check(err < WKV_TOL[dtype], f"wkv6 kernel vs oracle ({BH},{S},"
                  f"{N}) {dtype}: max abs err {err}")
            worst_oracle = max(worst_oracle, err)
            # a nonzero state in, the final state out: the sweep's BH
            # rows as the heads of one batch row, read through strides,
            # as ops.wkv6 views them
            s0 = rnd(1, BH, N, N)
            s_k = s0.clone()
            view = lambda a: a.transpose(0, 1)[None]  # noqa: E731
            got = scan.wkv6(view(r), view(k), view(v), view(logw), u, s_k)
            want, s_p = ref.wkv6_chunked(view(r), view(k), view(v),
                                         view(logw), u, s0, chunk)
            rel = max(_rel(got, want), _rel(s_k, s_p))
            check(rel < SCAN_RTOL[dtype], f"wkv6 with state ({BH},{S},{N}) "
                  f"{dtype}: rel err {rel}")
            worst_rel = max(worst_rel, rel)
        for case in WKV_MODEL_CASES + [WKV_RAGGED, WKV_FULL]:
            r, k, v, logw, u, s0 = wkv_inputs(torch, g, dtype=dtype, **case)
            s_k = s0.clone()
            got = scan.wkv6(r, k, v, logw, u, s_k)
            want, s_p = ref.wkv6_chunked(r, k, v, logw, u, s0, SCAN_CHUNK)
            torch.cuda.synchronize()
            rel = max(_rel(got, want), _rel(s_k, s_p))
            check(rel < SCAN_RTOL[dtype], f"wkv6 model layout {case} "
                  f"{dtype}: rel err {rel}")
            worst_rel = max(worst_rel, rel)
            del r, k, v, logw, got, want
        # strong decay: the pairwise exp must not overflow
        r, k, v, logw, u, _ = wkv_inputs(torch, g, 2, 128, 1, 16, dtype,
                                         strong=True)
        y = ops.wkv6(r[:, :, 0], k[:, :, 0], v[:, :, 0], logw[:, :, 0],
                     torch.zeros(2, 16, device="cuda"), chunk=64)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(y).all()), "wkv6 strong decay not finite")
        # strong decay over the whole prefill shape, in the model's layout
        r, k, v, logw, u, s0 = wkv_inputs(torch, g, dtype=dtype, strong=True,
                                          **WKV_FULL)
        s_k = s0.clone()
        got = scan.wkv6(r, k, v, logw, u, s_k)
        want, s_p = ref.wkv6_chunked(r, k, v, logw, u, s0, SCAN_CHUNK)
        torch.cuda.synchronize()
        strong_rel = max(_rel(got, want), _rel(s_k, s_p))
        check(bool(torch.isfinite(got).all()) and bool(
            torch.isfinite(s_k).all()) and strong_rel < SCAN_RTOL[dtype],
              f"wkv6 strong decay (logw = -8) at {WKV_FULL} {dtype}: rel err "
              f"{strong_rel}")
        worst_rel = max(worst_rel, strong_rel)
        del r, k, v, logw, got, want
        F_ = WKV_FULL
        r, k, v, logw, u, s0 = wkv_inputs(torch, g, dtype=dtype, **F_)
        s = s0.clone()
        times = _time_pair(
            torch, lambda: scan.wkv6(r, k, v, logw, u, s),
            lambda: ref.wkv6_chunked(r, k, v, logw, u, s0, SCAN_CHUNK))
        o = out[dtype] = dict(wkv_bound(dtype=dtype, **F_), **times,
                              max_abs_err=worst_oracle, max_rel_err=worst_rel,
                              strong_decay_rel_err=strong_rel,
                              **scan_grid(torch, scan, dtype,
                                          F_["B"] * F_["H"]))
        log(f"phase 9: wkv6 {dtype}: {len(WKV_CASES)} reference sweeps "
            f"within {WKV_TOL[dtype]} of the oracle (max abs err "
            f"{worst_oracle:.3g}); with a state in and out, "
            f"{len(WKV_CASES) + len(WKV_MODEL_CASES) + 3} shapes within "
            f"{SCAN_RTOL[dtype]} relative of the chunked plain version "
            f"(worst {worst_rel:.3g}; S = {WKV_RAGGED['S']} at full width; "
            f"logw = -8 over the prefill shape {strong_rel:.3g}, finite); "
            f"prefill shape {F_}: kernel {o['ms']:.4f} ms (runs "
            f"{o['ms_runs'][0]:.4f}/{o['ms_runs'][1]:.4f}), plain "
            f"{o['plain_ms']:.4f} ms, bound {o['bound_ms']:.4f} ms "
            f"({o['bound_by']}: {o['flops'] / 1e9:.2f} GFLOP at C = "
            f"{BOUND_CHUNK}, {o['bytes'] / 1e6:.1f} MB), on the tensor cores "
            f"{o['tc_bound_ms']:.4f} ms ({o['tc_bound_by']}); grid "
            f"{o['grid']} CTAs, {o['ctas_per_sm']} per SM, {o['waves']:.2f} "
            f"waves on {o['sms']} SMs")
        del r, k, v, logw, s, s0
    torch.cuda.empty_cache()
    return out


def check_ssd(torch, ops, scan, ref, lib_path):
    """B4 against its plain versions on the card; times at the zamba2-2.7b
    prefill shape.  Returns {dtype: {...}, "sass": {kernel: counts}}."""
    g = torch.Generator(device="cuda").manual_seed(10)
    rnd = _randn(torch, g)
    out = {"sass": scan_sass(lib_path, "ssd_kernel")}
    for dtype in ("float32", "bfloat16"):
        worst_oracle, worst_rel = 0.0, 0.0
        dt = getattr(torch, dtype)
        for BH, S, P, N, chunk in SSD_CASES:
            x, Bm, Cm = (rnd(BH, S, d).to(dt) for d in (P, N, N))
            da = -rnd(BH, S, 1).abs()
            got = ops.ssd(x, Bm, Cm, da, chunk=chunk)
            want = ref.ssd(x, Bm, Cm, da)
            torch.cuda.synchronize()
            check(got.shape == want.shape and got.dtype == dt,
                  f"ssd output {tuple(got.shape)} {got.dtype}")
            err = float((got.float() - want.float()).abs().max())
            check(err < SSD_TOL[dtype], f"ssd kernel vs oracle ({BH},{S},"
                  f"{P},{N}) {dtype}: max abs err {err}")
            worst_oracle = max(worst_oracle, err)
            h0 = rnd(BH, 1, P, N)
            h_k = h0.clone()
            got = scan.ssd_scan(x[:, :, None], Bm, Cm, da, h_k)
            want, h_p = ref.ssd_chunked(x[:, :, None], Bm, Cm, da, h0, chunk)
            rel = max(_rel(got, want), _rel(h_k, h_p))
            check(rel < SCAN_RTOL[dtype], f"ssd with state ({BH},{S},{P},"
                  f"{N}) {dtype}: rel err {rel}")
            worst_rel = max(worst_rel, rel)
        for case in SSD_MODEL_CASES + [SSD_RAGGED, SSD_FULL]:
            x, Bm, Cm, da, h0 = ssd_inputs(torch, g, dtype=dtype, **case)
            h_k = h0.clone()
            got = scan.ssd_scan(x, Bm, Cm, da, h_k)
            want, h_p = ref.ssd_chunked(x, Bm, Cm, da, h0, SSD_MODEL_CHUNK)
            torch.cuda.synchronize()
            rel = max(_rel(got, want), _rel(h_k, h_p))
            check(rel < SCAN_RTOL[dtype], f"ssd model layout {case} {dtype}"
                  f": rel err {rel}")
            worst_rel = max(worst_rel, rel)
            del x, got, want
        F_ = SSD_FULL
        x, Bm, Cm, da, h0 = ssd_inputs(torch, g, dtype=dtype, **F_)
        h = h0.clone()
        times = _time_pair(
            torch, lambda: scan.ssd_scan(x, Bm, Cm, da, h),
            lambda: ref.ssd_chunked(x, Bm, Cm, da, h0, SSD_MODEL_CHUNK))
        o = out[dtype] = dict(ssd_bound(dtype=dtype, **F_), **times,
                              max_abs_err=worst_oracle, max_rel_err=worst_rel,
                              **scan_grid(torch, scan, dtype,
                                          F_["B"] * F_["H"]))
        log(f"phase 9: ssd {dtype}: {len(SSD_CASES)} reference sweeps "
            f"within {SSD_TOL[dtype]} of the oracle (max abs err "
            f"{worst_oracle:.3g}); with a state in and out, "
            f"{len(SSD_CASES) + len(SSD_MODEL_CASES) + 2} shapes within "
            f"{SCAN_RTOL[dtype]} relative of the chunked plain version "
            f"(worst {worst_rel:.3g}; S = {SSD_RAGGED['S']} at full "
            f"width); prefill shape {F_}: kernel "
            f"{o['ms']:.4f} ms (runs {o['ms_runs'][0]:.4f}/"
            f"{o['ms_runs'][1]:.4f}), plain {o['plain_ms']:.4f} ms (chunk "
            f"{SSD_MODEL_CHUNK}), bound {o['bound_ms']:.4f} ms "
            f"({o['bound_by']}: {o['flops'] / 1e9:.2f} GFLOP at C = "
            f"{BOUND_CHUNK}, {o['bytes'] / 1e6:.1f} MB), on the tensor cores "
            f"{o['tc_bound_ms']:.4f} ms ({o['tc_bound_by']}); grid "
            f"{o['grid']} CTAs, {o['ctas_per_sm']} per SM, {o['waves']:.2f} "
            f"waves on {o['sms']} SMs")
        del x, Bm, Cm, da, h, h0
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 10-11: the recurrent families at full width
# ---------------------------------------------------------------------------

#: the launches one prefill wave must make: rwkv6 runs B3 once per layer;
#: zamba2 runs B4 once per mamba2 layer and B2 once per application of the
#: shared attention block
RECURRENT = {
    "rwkv6-3b": {"wkv6": 32, "ssd": 0, "flash_attention": 0},
    "zamba2-2.7b": {"wkv6": 0, "ssd": 54, "flash_attention": 9},
}
WAVE = dict(slots=8, max_prompt=1024, max_new=16, seed=0)
ENGINE_ARGV = ["--requests", "16", "--slots", "8", "--prompt-len", "64",
               "--max-new", "16", "--seed", "0", "--device", "cuda"]


class timed_calls:
    """Wraps functions of a module for a ``with`` block: each call is
    synchronised and its host seconds recorded in ``seconds[name]``."""

    def __init__(self, torch, module, *names):
        self.torch, self.module, self.names = torch, module, names
        self.seconds = {n: [] for n in names}

    def _wrap(self, name, fn):
        def timed(*a, **k):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            self.torch.cuda.synchronize()
            self.seconds[name].append(time.perf_counter() - t0)
            return out
        return timed

    def __enter__(self):
        self.orig = {n: getattr(self.module, n) for n in self.names}
        for n, fn in self.orig.items():
            setattr(self.module, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.module, n, fn)


def profile_recurrent(torch, lm, cfg, params, plen, wave_s, step_s, tag):
    """One prefill wave (8 x plen) and one decode step under torch.profiler,
    outside the counted runs: kernel time, busy share against the
    unprofiled wave and median step, and the B3, B4 and B2 milliseconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    B = WAVE["slots"]
    rng = np.random.default_rng(11)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, plen)),
                           dtype=torch.int32, device="cuda")
    pos = torch.full((B,), plen, dtype=torch.int32, device="cuda")
    cache = lm.init_cache(cfg, B, plen + 8, 1, torch.float32, "cuda")
    out = {}
    for name, call, base_s in (
            ("prefill", lambda: lm.serve_prefill(
                cfg, params, {"tokens": toks}, 1, cache), wave_s),
            ("decode", lambda: lm.serve_step(
                cfg, params, toks[:, 0], pos, 1, cache), step_s)):
        torch.cuda.synchronize()
        with torch.no_grad(), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
            log(f"phase {tag}: profiler saw no kernel time in {name}: busy "
                f"share not measured")
            out[name] = {"device_ms": None}
            continue
        pick = lambda s: sum(t for k, t in per_kernel.items()  # noqa: E731
                             if s in k)
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
        o = out[name] = {
            "device_ms": dev_ms, "call_ms": 1e3 * base_s,
            "busy_share": dev_ms / (1e3 * base_s),
            "wkv6_ms": pick("wkv6_kernel"), "ssd_ms": pick("ssd_kernel"),
            "flash_ms": pick("flash_fwd"), "n_kernels": len(per_kernel),
            "top_kernels_ms": {k[:100]: t for k, t in top}}
        log(f"phase {tag}: profiled {name}: kernels {dev_ms:.2f} ms against "
            f"a {o['call_ms']:.2f} ms unprofiled call (busy "
            f"{100 * o['busy_share']:.1f}%, idle "
            f"{100 * (1 - o['busy_share']):.1f}%); B3 wkv6 "
            f"{o['wkv6_ms']:.3f} ms, B4 ssd {o['ssd_ms']:.3f} ms, B2 flash "
            f"{o['flash_ms']:.3f} ms")
        for k, t in top:
            log(f"  {t:10.3f} ms  {k[:100]}")
    del cache
    return out


def run_recurrent(torch, kernels, serve_launch, lm, arch, tag):
    """``arch`` at full width: (a) the prototype Server, one prefill wave
    through lm.serve_prefill and 16 decode steps, counted; (b) the engine
    through launch/serve.py, which force-feeds every prompt (no prefill
    call, no scan launch); then one profiled wave and step."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.common import iter_specs
    cfg = get_config(arch)
    want = RECURRENT[arch]
    rng = np.random.default_rng(WAVE["seed"])
    prompts = [rng.integers(0, cfg.vocab_size,
                            int(rng.integers(4, WAVE["max_prompt"] + 1))
                            ).astype(np.int32) for _ in range(WAVE["slots"])]
    plen = max(len(p) for p in prompts)
    info = {"prompt_lens": sorted(len(p) for p in prompts)}

    # (a) the prototype Server: one wave of 8 prompts, 16 tokens each
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    server = serve_launch.Server(cfg, batch_slots=WAVE["slots"],
                                 max_len=plen + WAVE["max_new"] + 8,
                                 seed=WAVE["seed"], dtype=torch.float32,
                                 device="cuda")
    n_params = sum(t.numel() for t in _leaves(server.params))
    n_spec = sum(math.prod(s.shape)
                 for _, s in iter_specs(lm.param_specs(cfg, 1)))
    check(n_params == n_spec and all(
        t.is_cuda and t.dtype == torch.float32
        for t in _leaves(server.params)),
        f"{arch}: {n_params} params (spec: {n_spec}), or not fp32 on the "
        f"card")
    reqs = [serve_launch.Request(i, p, WAVE["max_new"])
            for i, p in enumerate(prompts)]
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    with timed_calls(torch, serve_launch.lm, "serve_prefill",
                     "serve_step") as tc:
        t0 = time.perf_counter()
        done, steps = server.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak_a = torch.cuda.max_memory_allocated()
    check(len(tc.seconds["serve_prefill"]) == 1 and steps == WAVE["max_new"],
          f"{arch} Server: {len(tc.seconds['serve_prefill'])} waves, "
          f"{steps} steps")
    check(all(counts[k] == v for k, v in want.items()) and
          counts["compress"] == counts["decompress"] ==
          counts["roundtrip"] == 0,
          f"{arch} Server wave launches {counts}, expected {want}")
    check(len(done) == 8 and all(len(r.out) == WAVE["max_new"]
                                 and not r.truncated for r in done),
          f"{arch} Server: a request did not finish with 16 tokens")
    check(all(0 <= t < cfg.vocab_size for r in done for t in r.out),
          f"{arch} Server: token ids out of range")
    check(all(bool(torch.isfinite(t).all()) for t in _leaves(server.cache)
              if t.is_floating_point()), f"{arch} Server: non-finite state")
    n_tok = sum(len(r.out) for r in done)
    wave_s = tc.seconds["serve_prefill"][0]
    step_med = float(np.median(tc.seconds["serve_step"]))
    info["server"] = {
        "wall_s": wall, "tok_per_s": n_tok / wall, "tokens": n_tok,
        # every request of the wave finishes at the last step
        "latency_p50_s": wall, "latency_p95_s": wall,
        "prefill_wave_s": wave_s, "prefill_len": plen,
        "decode_step_s_median": step_med, "decode_steps": steps,
        "launches": counts, "peak_mem_bytes": peak_a, "n_params": n_params}
    log(f"phase {tag}: {arch} full width ({n_params} params, fp32), "
        f"Server: one prefill wave of 8 prompts (lengths "
        f"{info['prompt_lens']}, padded to {plen}) in {wave_s:.4f} s, "
        f"{steps} decode steps (median {1e3 * step_med:.2f} ms); {n_tok} "
        f"tokens in {wall:.3f} s: {n_tok / wall:.2f} tok/s, latency p50 "
        f"{wall:.3f} s / p95 {wall:.3f} s; launches {counts}; peak "
        f"{peak_a / 2**30:.2f} GiB")
    del server, done
    torch.cuda.empty_cache()

    # (b) the engine through the launcher: every prompt force-fed
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    argv = ENGINE_ARGV if arch == "rwkv6-3b" else ["--arch", arch] + \
        ENGINE_ARGV
    t0 = time.perf_counter()
    engine, done, rep = serve_launch.run(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak_b = torch.cuda.max_memory_allocated()
    check(engine.cfg.name == arch, f"launcher served {engine.cfg.name}")
    check(not engine.call_seconds["prefill"]
          and not engine.call_shapes["prefill"],
          f"{arch} engine called prefill {engine.call_shapes['prefill']}")
    check(all(v == 0 for v in counts.values()),
          f"{arch} engine launched kernels while force-feeding: {counts}")
    check(len(done) == 16 and all(len(r.out) == 16 and not r.truncated
                                  for r in done),
          f"{arch} engine: a request did not finish with 16 tokens")
    check(all(len(engine.call_shapes[k]) == 1 for k in ("decode", "reset")),
          f"{arch} engine: more than one shape per call "
          f"{engine.call_shapes}")
    dec = engine.call_seconds["decode"]
    info["engine"] = {
        "wall_s": wall, "report": rep, "launches": counts,
        "decode_steps": len(dec),
        "decode_step_s_median": float(np.median(dec)),
        "peak_mem_bytes": peak_b}
    log(f"phase {tag}: {arch} engine (launch/serve.py "
        f"{' '.join(argv)}): {rep['tok_per_s']:.2f} tok/s, latency p50 "
        f"{rep['latency_p50_s']:.3f} s / p95 {rep['latency_p95_s']:.3f} s, "
        f"TTFT p50 {rep['ttft_p50_s']:.3f} s; {len(dec)} decode steps "
        f"(median {1e3 * info['engine']['decode_step_s_median']:.2f} ms), "
        f"no prefill call, launches {counts}; peak "
        f"{peak_b / 2**30:.2f} GiB")
    info["profile"] = profile_recurrent(
        torch, lm, cfg, engine.params, plen, wave_s,
        info["engine"]["decode_step_s_median"], tag)
    del engine
    torch.cuda.empty_cache()
    return info


# ---------------------------------------------------------------------------
# phase 12: recurrent serving, card against CPU at smoke size
# ---------------------------------------------------------------------------

def recurrent_card_vs_cpu(torch, kernels, lm, convert, serve, serve_launch):
    """rwkv6-smoke and zamba2-smoke from the same params and requests on
    the card and the CPU: equal tokens from one Server wave and from an
    engine run that recycles slots (the nested cache reset), and prefill
    logits within SERVE_LOGITS_RTOL."""
    from repro_torch.configs.registry import get_smoke_config
    out = {}
    for arch, scan in (("rwkv6-3b", "wkv6"), ("zamba2-2.7b", "ssd")):
        cfg = get_smoke_config(arch)
        p_cpu = lm.init_params(cfg, seed=1, device="cpu")
        p_card = convert.params_from_numpy(convert.params_to_numpy(p_cpu),
                                           device="cuda")
        rng = np.random.default_rng(4)
        prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
                   for n in (40, 13, 27, 9, 33)]
        spec = serve.ServeSpec(slots=3, max_len=96, prefill_len=48,
                               max_new=12)
        toks, launches = {}, {}
        for dev, p in (("card", p_card), ("cpu", p_cpu)):
            d = "cuda" if dev == "card" else "cpu"
            kernels.reset_launch_counts()
            server = serve_launch.Server(cfg, batch_slots=3, max_len=96,
                                         device=d)
            server.params = p
            sdone, _ = server.run([serve_launch.Request(i, q.copy(), 6)
                                   for i, q in enumerate(prompts)])
            reqs = serve.make_requests(6, 0.0, 48, 12, cfg.vocab_size,
                                       seed=5)
            edone = serve.ServeEngine(cfg, p, spec).run(reqs)
            toks[dev] = ([(r.rid, r.out, r.truncated) for r in sdone],
                         [(r.rid, r.out, r.truncated) for r in edone])
            launches[dev] = kernels.launch_counts()
        check(launches["card"][scan] > 0,
              f"{arch}: the card run did not launch {scan}")
        check(toks["card"] == toks["cpu"],
              f"{arch}: card and CPU generated different tokens")
        batch = rng.integers(0, cfg.vocab_size, (3, 40)).astype(np.int32)
        logits = {}
        for dev, p in (("card", p_card), ("cpu", p_cpu)):
            d = "cuda" if dev == "card" else "cpu"
            cache = lm.init_cache(cfg, 3, 48, 1, torch.float32, device=d)
            with torch.no_grad():
                lg, _ = lm.serve_prefill(
                    cfg, p, {"tokens": torch.as_tensor(batch, device=d)}, 1,
                    cache)
            logits[dev] = lg.float().cpu()
        rel = float((logits["card"] - logits["cpu"]).norm()
                    / logits["cpu"].norm())
        check(rel <= SERVE_LOGITS_RTOL,
              f"{arch}: prefill logits card vs CPU rel L2 {rel}")
        n_tok = sum(len(o) for part in toks["card"] for _, o, _ in part)
        out[arch] = {"tokens": n_tok, "rel_l2_prefill_logits": rel,
                     "launches": launches["card"]}
        log(f"phase 12: {cfg.name}: card and CPU generated the same {n_tok} "
            f"tokens (Server: 5 requests over 3 slots; engine: 6 requests "
            f"over 3 slots, slots recycled); prefill logits |card - cpu| / "
            f"|cpu| = {rel:.3g} (tolerance {SERVE_LOGITS_RTOL}); card "
            f"launches {launches['card']}")
    return out


# ---------------------------------------------------------------------------
# phase 13: the flash attention backward against its plain version
# ---------------------------------------------------------------------------

#: the cases of phase 6 (the reference's ATTN_CASES, hd 16 and 120), a
#: GQA hd-128 case and S != T both ways, each (S, T, H, KV, hd, causal,
#: window)
BWD_CASES = ATTN_CASES + [
    (256, 256, 28, 4, 128, True, None),
    (192, 128, 4, 2, 64, True, 48),
]
#: max |err| / max |want| of each gradient against the plain version on
#: the same inputs: fp32 sums in another order (1e-4); bf16 gradients are
#: rounded once from fp32 sums (2e-2)
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: bf16 gradients against the fp32 plain version on the same (bf16-valued)
#: inputs: each element within BWD_BF16_ROUNDINGS bf16 roundings (2^-8 of
#: itself) plus 1% of the gradient's max (the bf16 output O enters D =
#: rowsum(dO o O), and dS = P (dP - D) cancels where dP is near D)
BWD_BF16_ROUNDINGS = 3.0
#: the shapes the training paths give the backward: the trainer's
#: (qwen2-7b widths, one 4096-token sequence a microbatch) and the
#: federated LM's (tiny_lm_long: K = 4 clients x batch 10 folded into the
#: batch dim, 128 tokens, 2 heads of 16)
BWD_SHAPES = {
    "trainer (qwen2-7b widths)": dict(B=1, S=4096, H=28, KV=4, hd=128),
    "federated LM (tiny_lm_long)": dict(B=40, S=128, H=2, KV=2, hd=16),
}


def _grad_errs(got, want):
    return [float((a.float() - b.float()).abs().max()
                  / b.float().abs().max().clamp_min(1e-30))
            for a, b in zip(got, want)]


def ptxas_usage(build_log: str) -> dict:
    """{kernel symbol: {"registers", "spill_stores", "spill_loads"}} from
    the ``-Xptxas -v`` log of a build (empty when the build was reused)."""
    out, fn = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m[1]
            out[fn] = {}
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[fn].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[fn]["registers"] = int(m[1])
    return out


def _short(fn: str) -> str:
    """A backward kernel's symbol as name<D>, or name<type> for D's."""
    m = re.search(r"(flash_bwd_\w+?_kernel)I(?:Li(\d+)E|(\w+?)E)", fn)
    if not m:
        return fn
    return f"{m[1]}<{m[2] or ('f32' if m[3] == 'f' else 'bf16')}>"


def check_bwd_build(lib_path: str, build_log: str) -> dict:
    """The backward's SASS and ptxas report: HGMMA and UTMALDG in each bf16
    (wgmma) dK/dV and dQ kernel, HMMA and no HGMMA in each fp32 (mma.sync)
    one, no other kernel than these and D's; setmaxnreg honoured.
    Returns {short name: {opcode counts, registers, spills}}."""
    sass = sass_counts(lib_path)
    usage = ptxas_usage(build_log)
    check("setmaxnreg ignored" not in build_log,
          "ptxas ignored setmaxnreg in the backward's wgmma kernels")
    out = {}
    for fn, c in sass.items():
        name = _short(fn)
        kind = re.sub(r"<.*", "", name)
        check(kind in ("flash_bwd_delta_kernel",
                       "flash_bwd_dkdv_wgmma_kernel",
                       "flash_bwd_dq_wgmma_kernel",
                       "flash_bwd_dkdv_mma_kernel", "flash_bwd_dq_mma_kernel"),
              f"unexpected kernel in flash_attention_bwd: {fn}")
        if "wgmma" in kind:
            check(c["HGMMA"] > 0 and c["UTMALDG"] > 0,
                  f"{name} lacks wgmma or TMA instructions: {c}")
        elif "mma" in kind:
            check(c["HMMA"] > 0 and c["HGMMA"] == 0,
                  f"{name} is not an mma.sync design: {c}")
        out[name] = dict(c, **usage.get(fn, {}))
    check(len(out) == 2 + 2 * 2 + 2 * 5,
          f"flash_attention_bwd kernels: {sorted(out)}")
    for name, c in sorted(out.items()):
        log(f"phase 13: {name}: {c['HGMMA']} HGMMA, {c['UTMALDG']} UTMALDG, "
            f"{c['HMMA']} HMMA; " + (
                f"{c['registers']} registers, spills {c['spill_stores']} / "
                f"{c['spill_loads']} bytes stored / loaded"
                if "registers" in c else "ptxas report not available"))
    return out


def check_flash_bwd(torch, fa, ref, lib_path, build_log):
    """The forward's lse and the backward kernels against the plain
    versions on every case, in fp32 and bf16, with dO taken contiguous,
    strided (a slice of a wider tensor) and misaligned for 16-byte loads
    (bf16: copied for TMA, counted), twice with equal bits; then times at
    the training shapes, the whole call and each of its three kernels."""
    out = {"kernels": check_bwd_build(lib_path, build_log)}
    g = torch.Generator(device="cuda").manual_seed(13)
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        worst, worst_abs, worst_lse, worst_round = 0.0, 0.0, 0.0, 0.0
        n = 0
        fa.reset_layout_copy_counts()
        for (S, T, H, KV, hd, causal, window) in BWD_CASES:
            q, k, v = attn_inputs(torch, g, 2, S, T, H, KV, hd, dtype)
            o, lse = fa.flash_attention(q, k, v, causal=causal,
                                        window=window, return_lse=True)
            _, lse_p = ref.blocked_attention(q, k, v, causal=causal,
                                             window=window, return_lse=True)
            fin = torch.isfinite(lse_p)
            check(bool((torch.isfinite(lse) == fin).all()),
                  f"bwd {dtype} {(S, T, H, KV, hd)}: lse -inf rows differ")
            worst_lse = max(worst_lse, float((lse[fin] - lse_p[fin]).abs()
                                             .max()))
            wide = torch.randn(2, S, H, hd + 8, device="cuda",
                               generator=g).to(dt)
            odd = torch.randn(2, S, H, hd + 1, device="cuda",
                              generator=g).to(dt)
            for dname, do in (("contiguous", wide[..., :hd].contiguous()),
                              ("strided", wide[..., :hd]),
                              ("misaligned", odd[..., 1:])):
                got = fa.flash_attention_backward(q, k, v, o, lse, do,
                                                  causal=causal,
                                                  window=window)
                again = fa.flash_attention_backward(q, k, v, o, lse, do,
                                                    causal=causal,
                                                    window=window)
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"bwd {dtype} {(S, T, H, KV, hd)} {dname}: two calls "
                      f"gave different bits")
                want = ref.blocked_attention_backward(
                    q, k, v, o, lse, do, causal=causal, window=window)
                for a, b in zip(got, want):
                    check(a.shape == b.shape and a.dtype == b.dtype
                          and bool(torch.isfinite(a).all()),
                          f"bwd {dtype} {(S, T, H, KV, hd)} {dname}: "
                          f"shape, dtype or non-finite")
                errs = _grad_errs(got, want)
                check(max(errs) <= BWD_TOL[dtype],
                      f"bwd {dtype} {(S, T, H, KV, hd, causal, window)} "
                      f"dO {dname}: rel errs {errs} > {BWD_TOL[dtype]}")
                worst = max(worst, max(errs))
                worst_abs = max(worst_abs, max(
                    float((a.float() - b.float()).abs().max())
                    for a, b in zip(got, want)))
                n += 1
                if dtype == "bfloat16" and dname == "contiguous":
                    f32 = [x.float() for x in (q, k, v)]
                    o32, l32 = fa.flash_attention(*f32, causal=causal,
                                                  window=window,
                                                  return_lse=True)
                    want32 = ref.blocked_attention_backward(
                        *f32, o32, l32, do.float(), causal=causal,
                        window=window)
                    for a, b in zip(got, want32):
                        b = b.float()
                        lim = (2.0 ** -8) * b.abs() + 1e-2 * b.abs().max()
                        worst_round = max(worst_round, float(
                            ((a.float() - b).abs() / lim).max()))
                    check(worst_round <= BWD_BF16_ROUNDINGS,
                          f"bwd bf16 {(S, T, H, KV, hd)}: {worst_round} "
                          f"bf16 roundings from the fp32 gradients")
        # bf16 copies the misaligned dO of each case (twice) for TMA
        copies = fa.layout_copy_counts()["flash_attention_bwd_dout"]
        want_copies = 2 * len(BWD_CASES) if dtype == "bfloat16" else 0
        check(copies == want_copies,
              f"bwd {dtype}: {copies} dO layout copies, expected "
              f"{want_copies}")
        out[dtype] = {"max_rel_err": worst, "max_abs_err": worst_abs,
                      "cases": len(BWD_CASES), "comparisons": n,
                      "lse_max_abs_err": worst_lse, "dout_copies": copies}
        if dtype == "bfloat16":
            out[dtype]["roundings_from_fp32"] = worst_round
        log(f"phase 13: flash backward {dtype}: {n} comparisons on "
            f"{len(BWD_CASES)} shapes (dO contiguous, strided, misaligned; "
            f"{copies} dO copies for TMA) within {BWD_TOL[dtype]} of each "
            f"gradient's max (worst {worst:.3g}, max abs err "
            f"{worst_abs:.3g}), every call twice with equal bits; lse max "
            f"abs err {worst_lse:.3g}"
            + (f"; bf16 within {worst_round:.3g} roundings (+1% of max) "
               f"of the fp32 gradients" if dtype == "bfloat16" else ""))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out["shapes"] = {}
    for name, P in BWD_SHAPES.items():
        for dtype in (("float32", "bfloat16") if P["hd"] == 128
                      else ("float32",)):
            res = time_flash_bwd(torch, fa, ref, g, P, dtype)
            grids = fa.bwd_grids(P["B"], P["S"], P["S"], P["H"], P["KV"])
            res["grid"] = {}
            for which, (gx, gy) in grids.items():
                ctas = fa.bwd_ctas_per_sm(getattr(torch, dtype), P["hd"],
                                          which)
                res["grid"][which] = {"grid": [gx, gy], "ctas_per_sm": ctas,
                                      "waves": gx * gy / (ctas * sms)}
            out["shapes"][f"{name} {dtype}"] = res
            gd = "; ".join(f"{w} grid {v['grid']}, {v['ctas_per_sm']} "
                           f"CTA/SM, {v['waves']:.2f} waves"
                           for w, v in res["grid"].items())
            pt = ", ".join(f"{k} {t:.4f}" for k, t in res["parts_ms"].items())
            log(f"phase 13: flash backward {dtype} {name} B={P['B']} "
                f"S=T={P['S']} H={P['H']} KV={P['KV']} hd={P['hd']} causal: "
                f"kernel {res['ms']:.4f} ms (runs {res['ms_runs']}; in a "
                f"CUDA graph {res['graph_ms']:.4f} ms, each kernel alone: "
                f"{pt} ms), plain {res['plain_ms']:.4f} ms, SDPA backward "
                + (f"{res['library_ms']:.4f} ms" if res["library_ms"]
                   is not None else f"n/a ({res['library_note']})")
                + f", bound {res['bound_ms']:.4f} ms ({res['bound_by']}; "
                f"{100 * res['bound_ms'] / res['ms']:.1f}% of it), on the "
                f"tensor cores {res['tc_bound_ms']:.4f} ms "
                f"({100 * res['tc_bound_ms'] / res['ms']:.1f}%); "
                f"{res['flops'] / res['ms'] / 1e9:.1f} TFLOP/s of the 5 "
                f"products; {gd}")
    return out


def time_flash_bwd(torch, fa, ref, g, P, dtype, causal=True):
    """Backward kernels (the whole call, twice with equal bits; then in a
    CUDA graph, and each of its three kernels alone in one), plain version
    and SDPA's backward (the yardstick, timed here only and never called
    by the port) at one shape, beside the bound."""
    B, S, H, KV, hd = P["B"], P["S"], P["H"], P["KV"], P["hd"]
    q, k, v = attn_inputs(torch, g, B, S, S, H, KV, hd, dtype)
    do = torch.randn(B, S, H, hd, device="cuda",
                     generator=g).to(getattr(torch, dtype))
    o, lse = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    # both sides of the backward below read this o and lse: hold them to
    # the plain forward first, so a wrong forward cannot pass unseen
    _, lse_p = ref.blocked_attention(q, k, v, causal=causal,
                                     return_lse=True)
    o_err = float((o.float() - ref.attention_gqa(q, k, v, causal=causal)
                   .float()).abs().max())
    lse_err = float((lse - lse_p).abs().max())
    check(o_err < ATTN_TOL[dtype] and lse_err < LSE_ATOL,
          f"bwd {dtype} {P} causal={causal}: the forward's o (max abs err "
          f"{o_err}) or lse ({lse_err}) disagrees with the plain version")
    del lse_p
    kern = lambda: fa.flash_attention_backward(  # noqa: E731
        q, k, v, o, lse, do, causal=causal)
    plain = lambda: ref.blocked_attention_backward(  # noqa: E731
        q, k, v, o, lse, do, causal=causal)
    first, second = kern(), kern()
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(first, second)),
          f"bwd {dtype} {P}: two calls gave different bits")
    want = plain()
    errs = _grad_errs(first, want)
    check(max(errs) <= BWD_TOL[dtype],
          f"bwd {dtype} {P}: rel errs {errs} > {BWD_TOL[dtype]}")
    del first, second, want
    note, library = None, None
    try:
        qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_(True)
                      for x in (q, k, v))
        so = torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=causal, enable_gqa=True)
        dos = do.transpose(1, 2)

        def library():
            return torch.autograd.grad(so, (qs, ks, vs), dos,
                                       retain_graph=True)
        library()
        torch.cuda.synchronize()
    except Exception as e:  # the yardstick only: never on the path
        library, note = None, f"{type(e).__name__}: {e}"
    iters = 3 if S >= 4096 else 10
    p1 = event_time_ms(torch, plain, 1 if S >= 4096 else 3)
    k1 = event_time_ms(torch, kern, iters)
    l1 = event_time_ms(torch, library, iters) if library else None
    # device time without the host's launch cost: the whole call and each
    # kernel alone in CUDA graphs
    graph = graph_time_ms(torch, kern, iters)
    parts = {part: graph_time_ms(torch, lambda part=part:
                                 fa.flash_attention_backward(
                                     q, k, v, o, lse, do, causal=causal,
                                     only=part), iters)
             for part in fa.BWD_KERNELS}
    k2 = event_time_ms(torch, kern, iters)
    p2 = event_time_ms(torch, plain, 1 if S >= 4096 else 3)
    b = attention_bwd_bound(B, S, S, H, KV, hd, causal, None, dtype)
    return dict(b, ms=min(k1, k2), ms_runs=[k1, k2], graph_ms=graph,
                parts_ms=parts, plain_ms=min(p1, p2), plain_ms_runs=[p1, p2],
                library_ms=l1, library_note=note, rel_errs=errs,
                fwd_max_abs_err=o_err, lse_max_abs_err=lse_err)


# ---------------------------------------------------------------------------
# phases 14-15: the federated LM
# ---------------------------------------------------------------------------

#: the reference's federated-LM scenario (benchmarks/run.py _lm_spec) at
#: tiny_lm_long: 24 clients, 3 tiers, K = 4, 128-token sequences
FEDLM = {
    "data.model": "tiny_lm_long", "data.n_clients": 24,
    "data.classes_per_client": 2, "data.samples_per_client": 24,
    "data.vocab_size": 64, "data.seq_len": 128,
    "data.attention_backend": "flash", "data.seed": 9,
    "tiers.n_tiers": 3, "tiers.clients_per_round": 4, "tiers.n_unstable": 2,
    "strategy.name": "fedat", "transport.codec": "quantize8",
    "engine.total_updates": 16, "engine.eval_every": 8,
    "engine.local_epochs": 1,
}
#: phase 15: a small tiny_lm FedAT run on the card and on the CPU, from
#: the same params0 and permutations, raw links
FEDLM_SMALL = {
    "data.model": "tiny_lm", "data.n_clients": 12,
    "data.samples_per_client": 24, "data.seq_len": 32,
    "data.attention_backend": "flash", "tiers.n_tiers": 3,
    "tiers.clients_per_round": 4, "tiers.n_unstable": 2,
    "tiers.delay_bands": [[0.0, 0.0], [0.0, 0.5], [0.5, 1.0]],
    "engine.local_epochs": 1, "engine.total_updates": 4,
    "engine.eval_every": 2, "strategy.name": "fedat",
    "transport.codec": "none",
}
#: relative L2 of the global model, card against CPU, after phase 15's 4
#: updates.  The CPU tests measure the port against the reference at
#: 3.8e-7 on the same kind of run and the reference against itself from a
#: params0 one ulp away at 1.4e-7 (ROADMAP C); the card rounds differently
#: at every product of every local step, so the bound leaves a margin of
#: about 100x over those
FEDLM_CARD_VS_CPU_RTOL = 1e-4


def run_federated_lm(torch, api, kernels):
    """tiny_lm_long through api.build(spec).run() on the card, counts from
    0: a flash forward and backward per layer per local step, a forward
    per layer per eval chunk, 2 roundtrip launches per update."""
    spec = api.ExperimentSpec().with_overrides(FEDLM)
    run = api.build(spec, device="cuda")
    env = run.env
    cfg = env.model.config
    check(cfg.attention_backend == "flash" and cfg.name == "tiny-lm-long",
          f"federated LM bound {cfg.name} / {cfg.attention_backend}")
    ex = env.executor()
    rounds, evals = [], []
    orig_round, orig_eval = ex.fedat_round, env.eval_fn

    def timed_round(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = orig_round(*a, **k)
        torch.cuda.synchronize()
        rounds.append(time.perf_counter() - t0)
        return res

    def counted_eval(params, x, y, mask):
        C, N = y.shape
        evals.append(-(-C // max(1, 1024 // max(N, 1))))  # apply calls
        return orig_eval(params, x, y, mask)

    ex.fedat_round, env.eval_fn = timed_round, counted_eval
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = run.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    del ex.fedat_round
    env.eval_fn = orig_eval
    peak = torch.cuda.max_memory_allocated()
    m = res.metrics
    n_rounds = len(rounds)
    cap = int(env.train["y"].shape[1])
    steps = env.sc.local_epochs * (cap // env.sc.batch_size)
    L = cfg.n_layers
    want = {"flash_attention": n_rounds * steps * L + sum(evals) * L,
            "flash_attention_bwd": n_rounds * steps * L,
            "roundtrip": 2 * n_rounds}
    check(n_rounds == 16 and m.rounds[-1] == 16,
          f"federated LM: {n_rounds} rounds, metrics {m.rounds}")
    check(all(counts[k] == v for k, v in want.items())
          and all(n == 0 for k, n in counts.items() if k not in want),
          f"federated LM launches {counts}, expected {want} ({n_rounds} "
          f"rounds x {steps} local steps x {L} layers, {sum(evals)} eval "
          f"chunks)")
    w = run.strategy.global_params()
    check(all(v.is_cuda and bool(torch.isfinite(v).all())
              for v in w.values()), "federated LM: non-finite global model")
    check(all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in m.acc),
          f"federated LM accuracies {m.acc}")
    # the global model's loss on the first clients' test samples
    t = env._test_dev
    xs, ys, ms = t["x"][:4], t["y"][:4], t["mask"][:4]
    with torch.no_grad():
        lw = env.model.loss({k: v[None].expand(4, *v.shape)
                             for k, v in w.items()}, xs, ys, ms)
    loss = float((lw * ms.sum(1)).sum() / ms.sum())
    check(math.isfinite(loss), f"federated LM: loss {loss}")
    info = {"spec_hash": res.spec_hash, "rounds": n_rounds, "wall_s": wall,
            "events_per_s": n_rounds / wall,
            "ms_per_round": 1e3 * sum(rounds) / n_rounds,
            "local_steps_per_round": steps, "eval_chunks": sum(evals),
            "launches": counts, "expected_launches": want,
            "acc": m.acc, "test_loss": loss, "peak_mem_bytes": peak,
            "n_params": sum(v.numel() for v in env.params0.values())}
    log(f"phase 14: federated LM (tiny_lm_long, seq 128, 24 clients, 3 "
        f"tiers, K=4, quantize8): {n_rounds} updates in {wall:.3f} s "
        f"({info['events_per_s']:.4f} events/s, {info['ms_per_round']:.2f} "
        f"ms/round over {steps} local steps), acc {m.acc}, test loss "
        f"{loss:.4f}, peak {peak / 2**20:.1f} MiB, launches {counts}")
    return info


def federated_lm_card_vs_cpu(torch, api, SimEnv):
    """tiny_lm FedAT, raw links, 4 updates, from the same params0 and
    permutations on the card and the CPU: relative L2 of the global
    models."""
    spec = api.ExperimentSpec().with_overrides(FEDLM_SMALL)
    sc = spec.to_sim_config()
    p0 = SimEnv(sc, device="cpu").params0
    w = {}
    for name, d in (("card", "cuda"), ("cpu", "cpu")):
        env = SimEnv(sc, device=d, params0=p0)
        run = api.build(spec, env=env)
        run.run()
        w[name] = flat(run.strategy.w_global)
    moved = float((w["cpu"] - flat(p0)).norm())
    rel = float((w["card"] - w["cpu"]).norm() / w["cpu"].norm())
    check(moved > 0, "phase 15: the global model did not move")
    log(f"phase 15: federated LM card vs CPU after 4 FedAT updates "
        f"(tiny_lm, raw links): |card - cpu| / |cpu| = {rel:.3g} "
        f"(tolerance {FEDLM_CARD_VS_CPU_RTOL})")
    check(rel <= FEDLM_CARD_VS_CPU_RTOL,
          f"federated LM card and CPU disagree: {rel}")
    return {"rel_l2_w_global": rel, "moved_l2": moved}


# ---------------------------------------------------------------------------
# phase 16: the trainer at qwen2-7b widths
# ---------------------------------------------------------------------------

#: the cuts: depth 28 -> 3 layers and global batch 256 -> 8 at train_4k's
#: 4096 tokens.  Depth: AdamW in fp32 for all 28 layers would need about
#: 122 GB; 4 layers would fit the card (about 40 GB with grads, moments
#: and the accumulator), but the card's machine takes at most 45 GiB of
#: disk writes a run: the phase writes one checkpoint of params, m and v
#: (21.5 GB at 3 layers; the resumed run writes none)
TRAIN_LAYERS = 3
TRAIN_BATCH = 8
#: the resumed run repeats step 3 from the step-2 checkpoint: its loss
#: must equal the uninterrupted run's (the forward of a restored state is
#: deterministic); the bound covers a last-bit difference
TRAIN_RESUME_RTOL = 1e-6


def run_trainer(torch, kernels):
    """launch/train.py's code path at qwen2-7b widths: 2 steps ending in
    a checkpoint, then step 3 in the same process (timed) and step 4
    (profiled); then a restart with --resume from the step-2 checkpoint
    that repeats step 3, whose loss must equal the uninterrupted one, with
    --ckpt-every 0: the restore still runs (train.run, before the runner),
    and no checkpoint is written, so step 2's is the only one left."""
    import shutil
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.core import steps as steps_mod
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import train
    cfg = get_config("qwen2-7b").replace(n_layers=TRAIN_LAYERS)
    shape = ShapeConfig("train_4k", 4096, TRAIN_BATCH, "train")
    check(cfg.microbatch == 8 and cfg.remat and cfg.scan_layers,
          f"qwen2-7b trains with microbatch {cfg.microbatch}, remat "
          f"{cfg.remat}")
    ckdir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    argv = ["--arch", "qwen2-7b", "--ckpt-dir", str(ckdir), "--seed", "0",
            "--device", "cuda"]
    mb = cfg.microbatch
    per_step = {"flash_attention": 2 * mb * cfg.n_layers,   # remat: twice
                "flash_attention_bwd": mb * cfg.n_layers}
    out = {"layers": cfg.n_layers, "batch": TRAIN_BATCH, "seq": 4096,
           "microbatch": mb}
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        a = train.run(train.parser().parse_args(argv + ["--steps", "2"]),
                      cfg=cfg, shape=shape)
        torch.cuda.synchronize()
        wall_a = time.perf_counter() - t0
        counts_a = kernels.launch_counts()
        want = {k: 2 * v for k, v in per_step.items()}
        n_params = sum(t.numel() for t in _leaves(a.state["params"]))
        check(a.end_step == 2 and len(a.losses) == 2
              and all(math.isfinite(x) for x in a.losses),
              f"trainer: steps {a.start_step}..{a.end_step}, losses "
              f"{a.losses}")
        check(a.runner_stats["failures"] == 0,
              f"trainer: GuardedRunner caught {a.runner_stats['failures']} "
              f"failures (a kernel fault must not be retried silently)")
        check(all(counts_a[k] == v for k, v in want.items())
              and all(n == 0 for k, n in counts_a.items() if k not in want),
              f"trainer launches {counts_a}, expected {want}")
        on_disk = sorted(p.name for p in ckdir.iterdir())
        check(on_disk == [f"step_{2:010d}"], f"checkpoints {on_disk}")
        # step 3 uninterrupted, timed; step 4 profiled
        fns = steps_mod.make_single_pod_step(
            cfg, TrainConfig(total_steps=3), device="cuda")
        pipe = TokenPipeline(cfg, shape, seed=0)
        state, a.state = a.state, None
        state, prof = profile_train_step(torch, fns, state, pipe.batch(2),
                                         pipe.batch(3))
        peak = torch.cuda.max_memory_allocated()
        del state
        torch.cuda.empty_cache()
        # the restart: --resume from step 2 repeats step 3
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        b = train.run(train.parser().parse_args(
            argv + ["--steps", "3", "--resume", "--ckpt-every", "0"]),
            cfg=cfg, shape=shape)
        torch.cuda.synchronize()
        wall_b = time.perf_counter() - t0
        counts_b = kernels.launch_counts()
        b.state = None
        on_disk = sorted(p.name for p in ckdir.iterdir())
        check(on_disk == [f"step_{2:010d}"],
              f"the resumed run with --ckpt-every 0 left {on_disk}")
        check(b.start_step == 2 and b.end_step == 3 and len(b.losses) == 1,
              f"resumed run: steps {b.start_step}..{b.end_step}")
        check(b.runner_stats["failures"] == 0,
              f"resumed trainer caught {b.runner_stats['failures']} failures")
        check(all(counts_b[k] == v for k, v in per_step.items()),
              f"resumed trainer launches {counts_b}, expected {per_step}")
        step3 = prof["step3"]
        # the step's products, counted on meta tensors as the dry-run
        # counts a cell (launch/dryrun.py step_flops)
        from repro_torch.launch import dryrun
        flops = dryrun.step_flops(cfg, shape)
        step_flops = sum(flops.values())
        achieved = step_flops / step3["step_s"]
        d = abs(b.losses[0] - step3["loss"])
        check(b.metrics[0]["lr_scale"] == step3["lr_scale"],
              f"resumed step 3 lr_scale {b.metrics[0]['lr_scale']} vs "
              f"{step3['lr_scale']}")
        check(d <= TRAIN_RESUME_RTOL * abs(step3["loss"]),
              f"resumed step 3 loss {b.losses[0]} vs {step3['loss']}")
        out.update({
            "n_params": n_params, "losses": a.losses + [step3["loss"]],
            "grad_norms": [r["grad_norm"] for r in a.metrics]
            + [step3["grad_norm"]],
            "lr_scales": [r["lr_scale"] for r in a.metrics]
            + [step3["lr_scale"]],
            "resumed_loss": b.losses[0], "resume_abs_diff": d,
            "resumed_grad_norm": b.metrics[0]["grad_norm"],
            "wall_s": wall_a, "resume_wall_s": wall_b,
            "launches": counts_a, "expected_launches": want,
            "resume_launches": counts_b, "peak_mem_bytes": peak,
            "runner_stats": a.runner_stats, "profile": prof,
            "step_flops": step_flops, "step_flops_by_op": flops,
            "achieved_tflops": achieved / 1e12,
            "mfu": achieved / FP32_OPS_PER_S})
        log(f"phase 16: trainer at qwen2-7b widths ({n_params} params: "
            f"{cfg.n_layers} of 28 layers, d_model {cfg.d_model}, GQA "
            f"{cfg.n_heads}/{cfg.n_kv_heads}, hd {cfg.head_dim}, d_ff "
            f"{cfg.d_ff}, vocab {cfg.vocab_size}; batch {TRAIN_BATCH} of "
            f"256 x 4096 tokens, microbatch {mb}, remat, fp32 AdamW): "
            f"losses {out['losses']}, grad_norms {out['grad_norms']}; "
            f"steps 1-2 and a checkpoint in {wall_a:.1f} s; step 3 "
            f"{step3['step_s']:.3f} s: {step_flops:.4g} FLOP (meta count), "
            f"{achieved / 1e12:.2f} TFLOP/s, mfu {achieved / FP32_OPS_PER_S:.4f} "
            f"of the fp32 peak {FP32_OPS_PER_S / 1e12:.0f} TFLOP/s; resumed "
            f"from step 2: step 3 loss "
            f"{b.losses[0]} (|diff| {d:.3g}) in {wall_b:.1f} s with its "
            f"restore (no checkpoint written); peak {peak / 2**30:.2f} GiB; launches "
            f"{counts_a} (resume {counts_b}); runner {a.runner_stats}")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    return out


def profile_train_step(torch, fns, state, batch3, batch4):
    """Step 3 timed (host clock, synchronised) and step 4 under
    torch.profiler: busy share and the flash kernels' share of device
    time.  Returns (state, info)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = fns.train_step(state, batch3)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    info = {"step3": {"step_s": step_s, "loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]),
                      "lr_scale": float(m["lr_scale"])}}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = fns.train_step(state, batch4)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    per_kernel = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        per_kernel[e.key] = per_kernel.get(e.key, 0.0) + \
            e.self_device_time_total / 1e3
    dev_ms = sum(per_kernel.values())
    info["step4_profiled_s"] = prof_s
    if dev_ms == 0:
        log("phase 16: profiler saw no kernel time: busy share not measured")
        info["device_ms"] = None
        return state, info
    fwd = sum(t for k, t in per_kernel.items() if "flash_fwd" in k)
    bwd = sum(t for k, t in per_kernel.items() if "flash_bwd" in k)
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    info.update({"device_ms": dev_ms, "busy_share": dev_ms / (1e3 * step_s),
                 "flash_fwd_ms": fwd, "flash_bwd_ms": bwd,
                 "flash_fwd_share": fwd / dev_ms,
                 "flash_bwd_share": bwd / dev_ms,
                 "top_kernels_ms": {k[:100]: t for k, t in top}})
    log(f"phase 16: step 3 {step_s:.3f} s (loss {info['step3']['loss']}); "
        f"step 4 profiled: kernels {dev_ms:.1f} ms (busy "
        f"{100 * info['busy_share']:.1f}% of step 3's time), flash "
        f"forward {fwd:.1f} ms ({100 * fwd / dev_ms:.2f}%), backward "
        f"{bwd:.1f} ms ({100 * bwd / dev_ms:.2f}%)")
    for k, t in top:
        log(f"  {t:10.2f} ms  {k[:100]}")
    return state, info


# ---------------------------------------------------------------------------
# phase 17: FedAT under the fault plane, killed and resumed
# ---------------------------------------------------------------------------

#: phase 3's configuration with every fault family on, 8 updates.  Tier 0
#: commits about once a simulated second, so the 8 updates span about 10
#: simulated seconds and every window sits inside that.  The host-side
#: event trace is the same on any device; run for fault seeds 0-11 on the
#: CPU with the round bodies stubbed out, seed 5 gives two blackouts
#: (tiers 4 and 0, at 1.77-3.77 and 2.58-4.58 s) that start and end in the
#: run, a round discarded into one, 3 poisoned rounds and 3 clients
#: churned out of their rounds.  The updates of this run have delta norms
#: of 0.37-0.67 (and one of 2.2) on the CPU, so a clip of 0.5 cuts some
FAULTS = {
    "engine.total_updates": 8,
    "faults.churn_rate": 0.1, "faults.churn_window": [0.5, 6.0],
    "faults.churn_downtime": 3.0, "faults.blackouts": 2,
    "faults.blackout_window": [1.0, 4.0], "faults.blackout_duration": 2.0,
    "faults.nan_rate": 0.3, "faults.update_clip": 0.5,
    "faults.checkpoint_every": 2, "faults.seed": 5,
}
#: phase 17's card-against-CPU check: phase 4's small run with the gate
#: on in both rounds (one client poisoned a round, deltas clipped)
SMALL_FAULTS = {"faults.nan_rate": 1.0, "faults.update_clip": 0.3}
FAULT_DIR = ROOT / "build" / "chip_smoke_faults"


class FaultCounters:
    """Counts each fault family over one run: blackout starts and returns
    and rounds discarded into a blackout (the strategy's hooks), gated and
    poisoned rounds (the executor's arguments), clients churned out of
    their rounds (down by churn at completion, not by permanent dropout),
    and, on the card with no host read until :meth:`close`, the clients
    the gate zero-weighted and the updates it clipped."""

    def __init__(self, run):
        from repro_torch.core import faults, steps
        self.steps, self.run = steps, run
        st, ex = run.strategy, run.env.executor()
        self.n = {"blackout_starts": 0, "blackout_returns": 0,
                  "discarded_rounds": 0, "gated_rounds": 0,
                  "poisoned_rounds": 0, "churn_dropped_clients": 0}
        self._dev = []
        on_fault, on_event = st.on_fault, st.on_event
        fedat_round, self._gate = ex.fedat_round, steps.gate_updates

        def count_fault(env, ctx, now, actor):
            self.n["blackout_starts" if actor[0] == faults.BLACKOUT
                   else "blackout_returns"] += 1
            return on_fault(env, ctx, now, actor)

        def count_event(env, ctx, now, actor):
            m, ids = actor
            if not st.tier_alive[m]:
                self.n["discarded_rounds"] += 1
            else:
                up = env.dropout_at[ids] > now
                self.n["churn_dropped_clients"] += int(
                    (up & ~env.alive(now)[ids]).sum())
            return on_event(env, ctx, now, actor)

        def count_round(*a, **k):
            self.n["gated_rounds"] += k.get("gate") is not None
            self.n["poisoned_rounds"] += bool(
                k.get("poison") is not None and k["poison"].any())
            return fedat_round(*a, **k)

        def count_gate(cp, w, ref, clip):
            k = w.shape[0]
            ok, sq = w > 0, 0
            for key in sorted(cp):
                ok = ok & cp[key].isfinite().reshape(k, -1).all(dim=1)
                d = cp[key].float() - ref[key][None].float()
                sq = sq + d.reshape(k, -1).square().sum(dim=1)
            self._dev.append((((w > 0) & ~ok).sum(),
                              (ok & (sq.sqrt() > clip)).sum()))
            return self._gate(cp, w, ref, clip)

        st.on_fault, st.on_event = count_fault, count_event
        ex.fedat_round = count_round
        steps.gate_updates = count_gate

    def close(self) -> dict:
        del self.run.env.executor().fedat_round
        del self.run.strategy.on_fault, self.run.strategy.on_event
        self.steps.gate_updates = self._gate
        self.n["gate_zeroed_clients"] = sum(int(z) for z, _ in self._dev)
        self.n["clipped_updates"] = sum(int(c) for _, c in self._dev)
        return dict(self.n)


class CheckpointTimes:
    """Host seconds of each CheckpointManager save (the caller's part: the
    device-to-host copy), background write (npz, manifest, fsyncs,
    rename) and restore, keyed by the manager's directory."""

    NAMES = ("save", "_write", "restore")

    def __init__(self):
        from repro_torch.checkpoint import ckpt
        self.cls = ckpt.CheckpointManager
        self.orig = {n: getattr(self.cls, n) for n in self.NAMES}
        self.s = {n: [] for n in self.NAMES}
        for n, f in self.orig.items():
            setattr(self.cls, n, self._timed(n, f))

    def _timed(self, name, f):
        def timed(mgr, *a, **k):
            t0 = time.perf_counter()
            out = f(mgr, *a, **k)
            self.s[name].append((mgr.dir, time.perf_counter() - t0))
            return out
        return timed

    def close(self):
        for n, f in self.orig.items():
            setattr(self.cls, n, f)

    def engine(self, name):
        return [t for d, t in self.s[name] if d.endswith("engine")]


def _trajectory(m):
    return [m.times, m.rounds, m.acc, m.acc_var, m.bytes_up, m.bytes_down]


def _bits_equal(a, b) -> bool:
    import torch
    return sorted(a) == sorted(b) and all(torch.equal(a[k], b[k])
                                          for k in a)


def run_faults(torch, api, kernels, SimEnv, dev, phase3_events_per_s):
    """FedAT under every fault family at phase 3's width: two runs in this
    process must agree bitwise; a third, a CLI child process, is killed
    with SIGKILL once its second engine snapshot is on disk and resumed
    here, and must agree with them bitwise; 2 gated updates on the card
    against the CPU; every fault family must have fired."""
    import os
    import shutil
    import signal
    spec = api.ExperimentSpec().with_overrides(dict(FULL, **FAULTS))
    every = spec.faults.checkpoint_every
    shutil.rmtree(FAULT_DIR, ignore_errors=True)
    FAULT_DIR.mkdir(parents=True)
    try:
        runs, out = [], {}
        timer = CheckpointTimes()
        try:
            for i in (1, 2):
                run = api.build(spec, device=dev)
                counters = FaultCounters(run) if i == 1 else None
                torch.cuda.synchronize()
                kernels.reset_launch_counts()
                t0 = time.perf_counter()
                res = run.run(checkpoint_dir=str(FAULT_DIR / f"run{i}"))
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if i == 1:
                    counts = kernels.launch_counts()
                    fired = counters.close()
                    saves = timer.engine("save")
                    writes = timer.engine("_write")
                runs.append((res, run))
                out[f"run{i}_wall_s"] = wall
        finally:
            timer.close()
        (res1, run1), (res2, run2) = runs
        m = res1.metrics
        check(m.rounds and m.rounds[-1] == 8, f"phase 17: rounds {m.rounds}")
        check(all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in m.acc),
              f"phase 17: accuracies {m.acc}")
        check(all(bool(torch.isfinite(v).all())
                  for v in run1.strategy.global_params().values()),
              "phase 17: non-finite global model")
        check(_trajectory(res2.metrics) == _trajectory(m)
              and _bits_equal(run2.strategy.w_global, run1.strategy.w_global)
              and _bits_equal(run2.strategy.tier_models,
                              run1.strategy.tier_models),
              "phase 17: two uninterrupted runs on the card disagree")
        committed = fired["gated_rounds"]
        check(counts == {"compress": 0, "decompress": 0,
                         "roundtrip": 2 * committed, "flash_attention": 0,
                         "flash_attention_bwd": 0, "wkv6": 0,
                         "wkv6_bwd_dstate": 0, "wkv6_bwd": 0, "ssd": 0,
                         "ssd_bwd_dstate": 0, "ssd_bwd": 0}
              and committed == 8,
              f"phase 17: launch counts {counts} for {committed} gated "
              f"rounds, expected 2 roundtrip launches a round")
        silent = [k for k, v in fired.items() if v == 0]
        check(not silent, f"phase 17: fault families that did not fire: "
                          f"{silent} ({fired})")
        step_dir = FAULT_DIR / "run1" / "engine" / f"step_{8:010d}"
        snap_bytes = sum(p.stat().st_size for p in step_dir.iterdir())

        # the kill: a CLI child process, SIGKILL once its second engine
        # snapshot is complete on disk, then the resume in this process
        spec_path = FAULT_DIR / "spec.json"
        spec_path.write_text(spec.to_json())
        ck3 = FAULT_DIR / "run3"
        second = ck3 / "engine" / f"step_{2 * every:010d}"
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.api.cli", "--device", dev,
             "--spec", str(spec_path), "--checkpoint-dir", str(ck3)],
            cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE, text=True)
        try:
            while proc.poll() is None and not second.is_dir():
                check(time.perf_counter() - t0 < 300,
                      "phase 17: the child wrote no second snapshot in 300 s")
                time.sleep(0.02)
            alive = proc.poll() is None
            proc.send_signal(signal.SIGKILL)
        finally:
            if proc.poll() is None:
                proc.kill()
            err = proc.communicate()[1]
        check(alive, f"phase 17: the child ended (code {proc.returncode}) "
                     f"before the kill: {err[-2000:]}")
        check(proc.returncode == -signal.SIGKILL,
              f"phase 17: child exit code {proc.returncode}")
        kill_s = time.perf_counter() - t0
        left = sorted(p.name for p in (ck3 / "engine").iterdir())
        timer = CheckpointTimes()
        try:
            run3 = api.build(spec, device=dev)
            t0 = time.perf_counter()
            res3 = run3.run(checkpoint_dir=str(ck3), resume_engine=True)
            torch.cuda.synchronize()
            resume_wall = time.perf_counter() - t0
            restores = timer.engine("restore")
        finally:
            timer.close()
        check(_trajectory(res3.metrics) == _trajectory(m)
              and _bits_equal(run3.strategy.w_global, run1.strategy.w_global)
              and _bits_equal(run3.strategy.tier_models,
                              run1.strategy.tier_models),
              "phase 17: the resumed run disagrees with the uninterrupted "
              "ones")

        agree = card_vs_cpu(torch, api, SimEnv, dev, SMALL_FAULTS, "17",
                            "2 gated FedAT quantize8 updates")
        eps = 8 / out["run1_wall_s"]
        out.update({
            "spec_hash": res1.spec_hash, "events_per_s": eps,
            "phase3_events_per_s": phase3_events_per_s,
            "launches": counts, "fired": fired, "acc": m.acc,
            "sim_time": m.times[-1], "snapshot_save_s": saves,
            "snapshot_write_s": writes, "snapshot_bytes": snap_bytes,
            "restore_s": restores, "kill_after_s": kill_s,
            "snapshots_at_kill": left, "resume_wall_s": resume_wall,
            "card_vs_cpu": agree})
        log(f"phase 17: FedAT quantize8 full width under faults, 8 updates "
            f"({m.times[-1]:.2f} simulated s): {out['run1_wall_s']:.3f} s, "
            f"{eps:.4f} events/s (phase 3: {phase3_events_per_s:.4f}), "
            f"acc {m.acc}; second run {out['run2_wall_s']:.3f} s, bitwise "
            f"equal; fired {fired}; launches {counts}")
        log(f"phase 17: {len(saves)} engine snapshots of {snap_bytes} bytes: "
            f"save {min(saves):.4f}-{max(saves):.4f} s on the caller, write "
            f"{min(writes):.4f}-{max(writes):.4f} s in the background; child "
            f"killed {kill_s:.1f} s after its start with {left} on disk; "
            f"restore {restores[0]:.4f} s, resumed run {resume_wall:.3f} s, "
            f"trajectory and final params bitwise equal to the "
            f"uninterrupted runs")
        return out
    finally:
        shutil.rmtree(FAULT_DIR, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 18: a federated LM checkpoint served on the card
# ---------------------------------------------------------------------------

#: phase 14's scenario with churn, blackouts and poisoned uplinks, engine
#: snapshots every 4 updates.  Its 16 updates span about 63 simulated
#: seconds; fault seed 2 (of 0-9, traced on the CPU with the round bodies
#: stubbed) gives two blackouts (tiers 1 and 0, 11.9-19.9 and 14.6-22.6 s)
#: with 2 rounds discarded into them, 6 poisoned rounds and a client
#: churned out of its round
FEDLM_FAULTS = dict(FEDLM, **{
    "faults.churn_rate": 0.1, "faults.churn_window": [2.0, 30.0],
    "faults.churn_downtime": 8.0, "faults.blackouts": 2,
    "faults.blackout_window": [5.0, 25.0], "faults.blackout_duration": 8.0,
    "faults.nan_rate": 0.3, "faults.checkpoint_every": 4, "faults.seed": 2})
SERVE_ARGS = ["--requests", "8", "--slots", "4", "--prompt-len", "16",
              "--max-new", "8", "--seed", "3"]


def run_fedlm_checkpoint(torch, api, cli, serve, kernels):
    """tiny_lm_long under faults through the CLI with --checkpoint-dir on
    the card (counts from 0), then ``cli serve --resume-from`` of its
    checkpoint on the card and on the CPU: the same tokens; a load under
    another spec's hash is refused."""
    import shutil
    spec = api.ExperimentSpec().with_overrides(FEDLM_FAULTS)
    d = FAULT_DIR / "fedlm"
    shutil.rmtree(FAULT_DIR, ignore_errors=True)
    d.mkdir(parents=True)
    try:
        spec_path = FAULT_DIR / "fedlm.json"
        spec_path.write_text(spec.to_json())
        # the CLI's run takes this cached environment; wrap its executor
        # and eval to count rounds and eval chunks (phase 14's launch rule)
        env = api.get_env(spec, "cuda")
        ex = env.executor()
        rounds, evals = [], []
        orig_round, orig_eval = ex.fedat_round, env.eval_fn

        def counted_round(*a, **k):
            rounds.append(k.get("poison") is not None and k["poison"].any())
            return orig_round(*a, **k)

        def counted_eval(params, x, y, mask):
            C, N = y.shape
            evals.append(-(-C // max(1, 1024 // max(N, 1))))
            return orig_eval(params, x, y, mask)

        ex.fedat_round, env.eval_fn = counted_round, counted_eval
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            (res,) = cli.main(["--device", "cuda", "--spec", str(spec_path),
                               "--checkpoint-dir", str(d)])
            torch.cuda.synchronize()
        finally:
            del ex.fedat_round
            env.eval_fn = orig_eval
        wall = time.perf_counter() - t0
        train = kernels.launch_counts()
        cfg = env.model.config
        steps = env.sc.local_epochs * (int(env.train["y"].shape[1])
                                       // env.sc.batch_size)
        L, n = cfg.n_layers, len(rounds)
        want = {"flash_attention": n * steps * L + sum(evals) * L,
                "flash_attention_bwd": n * steps * L, "roundtrip": 2 * n}
        check(n == 16 and res.metrics.rounds[-1] == 16 and any(rounds)
              and train == dict({k: 0 for k in train}, **want),
              f"phase 18: {n} rounds ({sum(rounds)} poisoned), launches "
              f"{train}, expected {want}")
        check(sorted(p.name for p in (d / "engine").iterdir())[-1]
              == f"step_{16:010d}" and (d / "spec.json").exists(),
              "phase 18: the run left no final engine snapshot or sidecar")

        reps = {}
        for device in ("cuda", "cpu"):
            rep_path = FAULT_DIR / f"serve_{device}.json"
            kernels.reset_launch_counts()
            cli.main(["serve", "--resume-from", str(d), "--device", device,
                      *SERVE_ARGS, "--out", str(rep_path)])
            if device == "cuda":
                torch.cuda.synchronize()
                served = kernels.launch_counts()
            reps[device] = json.loads(rep_path.read_text())
        card, cpu = reps["cuda"], reps["cpu"]
        check(card["spec_hash"] == spec.hash() and card["step"] == 16,
              f"phase 18: served spec {card['spec_hash']} step "
              f"{card['step']}")
        check(card["tokens"] == cpu["tokens"],
              f"phase 18: card and CPU served other tokens: "
              f"{card['tokens']} / {cpu['tokens']}")
        check(served["flash_attention"] > 0
              and served["flash_attention"] % L == 0
              and served["flash_attention_bwd"] == 0,
              f"phase 18: serving launches {served}")
        other = spec.with_overrides({"engine.lr": 0.123})
        try:
            serve.load_checkpoint(str(d), expect_spec=other, device="cuda")
            refused = False
        except api.SpecError as e:
            refused = "was written by spec" in str(e)
        check(refused, "phase 18: a load under another spec's hash was "
                       "not refused")
        n_tok = sum(len(v) for v in card["tokens"].values())
        info = {"spec_hash": res.spec_hash, "wall_s": wall,
                "events_per_s": 16 / wall, "acc": res.metrics.acc,
                "poisoned_rounds": int(sum(rounds)),
                "train_launches": train, "expected_launches": want,
                "serve_launches": served, "served_tokens": n_tok,
                "serve_card": {k: card[k] for k in (
                    "tok_per_s", "latency_p50_s", "requests", "shapes")},
                "serve_cpu_tok_per_s": cpu["tok_per_s"]}
        log(f"phase 18: federated LM under faults (tiny_lm_long, 16 "
            f"updates, {int(sum(rounds))} poisoned) through the CLI with "
            f"--checkpoint-dir: {wall:.3f} s ({16 / wall:.4f} events/s), "
            f"launches {train}; served from its checkpoint on the card: "
            f"{card['requests']} requests, {n_tok} tokens equal to the "
            f"CPU's, {card['tok_per_s']:.1f} tok/s, launches {served}; "
            f"another spec's hash refused")
        return info
    finally:
        shutil.rmtree(FAULT_DIR, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 19: the population plane at a million clients
# ---------------------------------------------------------------------------

#: the reference's population scenario (benchmarks/run.py:457-471, its 1M
#: row) at the paper CNN's CIFAR-10 width, with the completion process
#: on: rows capped at 4 x 24 = 96 (76 train rows), K = 32 over 5 tiers,
#: one local epoch of batch 10 (7 local steps a round).  The streamed
#: batch is 32 x 76 x (3072 x 4 + 4 + 1) B = 29.9 MB a round.
POPULATION = {
    "data.model": "cnn", "data.image_hw": 32, "data.n_classes": 10,
    "data.n_clients": 1_000_000, "data.classes_per_client": 2,
    "data.samples_per_client": 24, "data.seed": 8,
    "tiers.n_tiers": 5, "tiers.clients_per_round": 32,
    "tiers.n_unstable": 1_000_000 // 16,
    "engine.local_epochs": 1, "engine.batch_size": 10,
    "engine.total_updates": 10, "engine.eval_every": 10,
    "strategy.name": "fedat", "transport.codec": "quantize8",
    "population.plane": "streaming",
    "population.availability": "bernoulli:0.9:20",
    "population.responsiveness": "lognormal:0.25",
    "population.completion": "bernoulli:0.95",
    "population.eval_clients": 64, "population.seed": 1,
}
#: phase 19's card-against-CPU check: phase 4's small run on the
#: streaming plane with every process on (1-second slots)
SMALL_POPULATION = {
    "population.plane": "streaming",
    "population.availability": "bernoulli:0.9:1",
    "population.responsiveness": "lognormal:0.25",
    "population.completion": "bernoulli:0.9:1",
    "population.eval_clients": 8, "population.seed": 1,
}


def peak_rss_bytes() -> int:
    """This process's peak host resident set (Linux reports KiB)."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def _population_spec(api, n, **over):
    return api.ExperimentSpec().with_overrides(dict(POPULATION, **{
        "data.n_clients": n, "tiers.n_unstable": max(n // 16, 1)}, **over))


def population_parity(torch, api, dev):
    """The phase's spec at N = 256 on the stacked plane (the train stack
    resident on the card) and the streaming plane: bitwise equal Metrics,
    w_global and tier models."""
    out = []
    for plane in ("stacked", "streaming"):
        run = api.build(_population_spec(
            api, 256, **{"population.plane": plane}), device=dev)
        out.append((run, run.run().metrics))
        api.clear_env_cache()
    (a, ma), (b, mb) = out
    check(a.env.train_dev is not None and b.env.train_dev is None,
          "phase 19: the planes' stacks are not where they belong")
    resident = sum(v.numel() * v.element_size()
                   for v in a.env.train_dev.values())
    check(_trajectory(ma) == _trajectory(mb)
          and _bits_equal(a.strategy.w_global, b.strategy.w_global)
          and _bits_equal(a.strategy.tier_models, b.strategy.tier_models),
          "phase 19: streaming and stacked planes disagree at N = 256")
    return {"resident_train_bytes": resident, "rounds": ma.rounds,
            "acc": ma.acc}


def run_population(torch, api, kernels, SimEnv, dev):
    """FedAT quantize8 over a million streamed clients through
    ``api.build(spec).run()``, counts from 0: 2 roundtrip launches a
    committed round and no other kernel, no resident train stack, the
    data-plane bytes flat against 1,000 clients; then streaming against
    stacked at N = 256 and a small run on the card against the CPU."""
    spec = api.ExperimentSpec().with_overrides(POPULATION)
    t0 = time.perf_counter()
    run = api.build(spec, device=dev)
    build_s = time.perf_counter() - t0
    rss = peak_rss_bytes()
    env, ex = run.env, run.env.executor()
    pop = env.population
    check(env.streaming and env.train is None and env.train_dev is None,
          "phase 19: the streaming plane holds a resident train stack")
    check((pop.n, pop.cap, pop.cap_train) == (1_000_000, 96, 76),
          f"phase 19: population {pop.n}, caps {pop.cap}/{pop.cap_train}")
    n_params = sum(v.numel() for v in env.params0.values())
    check(n_params == 122570, f"phase 19: CNN has {n_params} params")

    mat_s, data_s, round_s = [], [], []
    materialize, round_data, fedat_round = \
        pop.materialize, ex._round_data, ex.fedat_round

    def timed_materialize(ids):
        t0 = time.perf_counter()
        out = materialize(ids)
        mat_s.append(time.perf_counter() - t0)
        return out

    def timed_data(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = round_data(*a)
        torch.cuda.synchronize()
        data_s.append(time.perf_counter() - t0)
        return out

    def timed_round(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fedat_round(*a, **k)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        return out

    pop.materialize, ex._round_data = timed_materialize, timed_data
    ex.fedat_round = timed_round
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = run.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    del pop.materialize, ex._round_data, ex.fedat_round
    peak = torch.cuda.max_memory_allocated()

    m = res.metrics
    rounds = len(round_s)
    check(rounds == 10 and m.rounds and m.rounds[-1] == 10,
          f"phase 19: {rounds} rounds, Metrics rounds {m.rounds}")
    check(all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in m.acc),
          f"phase 19: accuracies {m.acc}")
    check(all(bool(torch.isfinite(v).all())
              for v in run.strategy.w_global.values()),
          "phase 19: non-finite global model")
    check(counts == {"compress": 0, "decompress": 0, "roundtrip": 2 * rounds,
                     "flash_attention": 0, "flash_attention_bwd": 0,
                     "wkv6": 0, "wkv6_bwd_dstate": 0, "wkv6_bwd": 0,
                     "ssd": 0, "ssd_bwd_dstate": 0, "ssd_bwd": 0},
          f"phase 19: launch counts {counts}, expected {2 * rounds} "
          f"roundtrip launches and no other")
    check(len(mat_s) == len(data_s) == rounds,
          f"phase 19: {len(mat_s)} materializations for {rounds} rounds")
    check(ex.stream_bytes == pop.batch_nbytes(32),
          f"phase 19: streamed {ex.stream_bytes} bytes a round, expected "
          f"{pop.batch_nbytes(32)}")
    upload_s = [d - t for d, t in zip(data_s, mat_s)]
    dp, batch = env.data_plane_bytes(), ex.stream_bytes
    api.clear_env_cache()
    del run, env, ex, pop

    # the flat-memory bound: the same spec at 1,000 clients
    small = api.build(_population_spec(api, 1000, **{
        "engine.total_updates": 2, "engine.eval_every": 2}), device=dev)
    small.run()
    dp_1k = small.env.data_plane_bytes()
    api.clear_env_cache()
    del small
    check(abs(dp / dp_1k - 1.0) <= 0.10,
          f"phase 19: data-plane bytes {dp} at 1M against {dp_1k} at 1k")
    parity = population_parity(torch, api, dev)
    agree = card_vs_cpu(torch, api, SimEnv, dev, SMALL_POPULATION, "19",
                        "2 FedAT quantize8 updates on the streaming plane")
    info = {
        "spec_hash": res.spec_hash, "rounds": rounds, "wall_s": wall,
        "events_per_s": rounds / wall,
        "ms_per_round": 1e3 * float(np.median(round_s)),
        "ms_per_round_each": [1e3 * r for r in round_s],
        "materialize_ms_each": [1e3 * t for t in mat_s],
        "upload_ms_each": [1e3 * t for t in upload_s],
        "materialize_ms": 1e3 * float(np.median(mat_s)),
        "upload_ms": 1e3 * float(np.median(upload_s)),
        "batch_bytes": batch,
        "build_s": build_s, "peak_rss_bytes_after_build": rss,
        "peak_mem_bytes": peak, "launches": counts,
        "data_plane_bytes": dp, "data_plane_bytes_1k": dp_1k,
        "acc": m.acc, "sim_time": m.times[-1], "parity_256": parity,
        "card_vs_cpu": agree,
    }
    log(f"phase 19: FedAT quantize8 over {POPULATION['data.n_clients']:,} "
        f"streamed clients (K=32, 7 local steps a round): built in "
        f"{build_s:.2f} s (process peak host RSS {rss / 2**30:.2f} GiB), "
        f"{rounds} rounds in {wall:.3f} s "
        f"({info['events_per_s']:.4f} events/s, {info['ms_per_round']:.2f} "
        f"ms/round median), materialize {info['materialize_ms']:.2f} ms "
        f"and upload {info['upload_ms']:.2f} ms a round (medians) of "
        f"{batch} bytes; acc {m.acc}, peak {peak / 2**20:.1f} MiB, "
        f"launches {counts}")
    log(f"phase 19: data-plane bytes {dp} at 1M, {dp_1k} at 1k "
        f"(ratio {dp / dp_1k:.4f}); N = 256 stacked "
        f"({parity['resident_train_bytes']} resident bytes) and streaming "
        f"bitwise equal")
    return info


# ---------------------------------------------------------------------------
# phase 20: the topology plane at full width
# ---------------------------------------------------------------------------

#: the reference's topology scenario (benchmarks/run.py:542-562) at phase
#: 3's width: 2 silos x 2 edges of K_edge = 5 over 100 clients of 500
#: samples, one flat tier (the edges are the latency tiers inside each
#: silo), WAN delays on every link class, silo 1's WAN 4x silo 0's,
#: compensation 0.5, quantize8 on all three links: 7 roundtrip launches a
#: silo round (3 downlink, 1 client_edge uplink, 2 edge_silo, 1
#: silo_global)
TOPOLOGY = dict(FULL, **{
    "tiers.n_tiers": 1, "tiers.n_unstable": 0,
    "topology.n_silos": 2, "topology.edges_per_silo": 2,
    "topology.clients_per_edge": 5,
    "topology.delay.client_edge": [0.5, 1.5],
    "topology.delay.edge_silo": [1.0, 3.0],
    "topology.delay.silo_global": [20.0, 60.0],
    "topology.silo_skew": 3.0, "topology.compensation": 0.5,
    "topology.codec.client_edge": "quantize8",
    "topology.codec.edge_silo": "quantize8",
    "topology.codec.silo_global": "quantize8",
})
#: roundtrip launches a silo round: the downlink chain (3), the
#: client_edge uplink (1), one edge_silo per edge (2), silo_global (1)
TOPOLOGY_LAUNCHES = 7
#: the crash-resume check, cut in depth: 6 updates, snapshots every 2
TOPOLOGY_RESUME = {"engine.total_updates": 6, "engine.eval_every": 2,
                   "faults.checkpoint_every": 2}
#: phase 20's card-against-CPU check: phase 4's small run as a 2 x 2 tree
SMALL_TOPOLOGY = {
    "tiers.n_tiers": 1, "topology.n_silos": 2, "topology.edges_per_silo": 2,
    "topology.clients_per_edge": 2, "topology.delay.silo_global": [1.0, 3.0],
    "topology.compensation": 0.5, "topology.codec.edge_silo": "quantize8",
    "topology.codec.silo_global": "quantize8",
}
TOPOLOGY_DIR = ROOT / "build" / "chip_smoke_topology"


class _Abort(Exception):
    pass


def degenerate_tree(torch, api, dev):
    """1 silo, 1 edge, zero-width delay band at phase 4's width, one flat
    tier: bitwise the flat FedAT quantize8 run on the card."""
    base = dict(SMALL, **{"tiers.n_tiers": 1, "engine.total_updates": 4,
                          "engine.eval_every": 2})
    runs = []
    for over in ({}, {"topology.delay.silo_global": [0.0, 0.0]}):
        run = api.build(api.ExperimentSpec().with_overrides(
            dict(base, **over)), device=dev)
        runs.append((run, run.run().metrics))
    (a, ma), (b, mb) = runs
    check(b.env.topology is not None and a.env.topology is None,
          "phase 20: the degenerate tree did not build a topology")
    check(_trajectory(ma) == _trajectory(mb)
          and _bits_equal(a.strategy.w_global, b.strategy.w_global)
          and _bits_equal(a.strategy.tier_models, b.strategy.tier_models),
          "phase 20: the degenerate tree differs from the flat run")
    return {"rounds": mb.rounds, "acc": mb.acc}


def topology_resume(torch, api, dev):
    """Two runs with engine snapshots every 2 updates, then a run cut at
    its third eval (snapshots 2 and 4 on disk) resumed from the second
    snapshot: all three bitwise equal (trajectory, w_global, the silo and
    dispatch stacks, the per-link ledger)."""
    import shutil
    spec = api.ExperimentSpec().with_overrides(dict(TOPOLOGY,
                                                    **TOPOLOGY_RESUME))
    shutil.rmtree(TOPOLOGY_DIR, ignore_errors=True)
    TOPOLOGY_DIR.mkdir(parents=True)
    try:
        runs = []
        for i in (1, 2):
            run = api.build(spec, device=dev)
            m = run.run(checkpoint_dir=str(TOPOLOGY_DIR / f"run{i}")).metrics
            runs.append((run, m))
        seen = []

        def bomb(point):
            seen.append(point)
            if len(seen) == 3:
                raise _Abort
        cut = str(TOPOLOGY_DIR / "cut")
        try:
            api.build(spec, device=dev).run(on_eval=bomb, checkpoint_dir=cut)
            fail("phase 20: the cut run was not cut")
        except _Abort:
            pass
        left = sorted(p.name for p in (TOPOLOGY_DIR / "cut" /
                                       "engine").glob("step_*"))
        check(left == [f"step_{2:010d}", f"step_{4:010d}"],
              f"phase 20: snapshots at the cut: {left}")
        run3 = api.build(spec, device=dev)
        t0 = time.perf_counter()
        runs.append((run3, run3.run(checkpoint_dir=cut,
                                    resume_engine=True).metrics))
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(TOPOLOGY_DIR, ignore_errors=True)
    (a, ma) = runs[0]
    for b, mb in runs[1:]:
        check(_trajectory(mb) == _trajectory(ma)
              and all(_bits_equal(getattr(a.strategy, n),
                                  getattr(b.strategy, n))
                      for n in ("w_global", "tier_models", "dispatch"))
              and a.strategy.link_bytes == b.strategy.link_bytes,
              "phase 20: snapshotted or resumed silo runs disagree")
    return {"snapshots_at_cut": left, "resume_wall_s": resume_s,
            "rounds": ma.rounds}


def profile_silo_round(torch, run, kernels):
    """One more silo round under torch.profiler (outside the counted
    run): B1's device time and launches in it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    env, st = run.env, run.strategy
    topo = env.topology
    ids = [m[:topo.k_edge] for m in topo.edge_members[0]]
    cw = np.full(topo.n_silos, 1.0 / topo.n_silos, np.float32)
    torch.cuda.synchronize()
    before = kernels.launch_counts()["roundtrip"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        env.executor().fedat_topology_round(
            st.w_global, st.tier_models, st.dispatch, 0, ids, 12345,
            codecs=st.link_codecs, use_prox=True, cross_weights=cw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = kernels.launch_counts()["roundtrip"] - before
    dev_ms, codec_ms, events = 0.0, 0.0, 0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        dev_ms += e.self_device_time_total / 1e3
        if "roundtrip_kernel" in e.key:
            codec_ms += e.self_device_time_total / 1e3
            events += e.count
    check(launches == TOPOLOGY_LAUNCHES,
          f"phase 20: the profiled silo round made {launches} roundtrip "
          f"launches, expected {TOPOLOGY_LAUNCHES}")
    if dev_ms == 0:
        log("phase 20: profiler saw no kernel time: B1's share not measured")
        return {"profiled_wall_ms": wall_ms, "device_ms": None,
                "codec_launches": launches}
    return {"profiled_wall_ms": wall_ms, "device_ms": dev_ms,
            "codec_ms": codec_ms, "codec_kernel_events": events,
            "codec_launches": launches}


def run_topology(torch, api, kernels, SimEnv, dev):
    """FedAT quantize8 over the 2 x 2 tree at phase 3's width through
    ``api.build(spec).run()``, counts from 0: 7 roundtrip launches a
    committed silo round and no other kernel, the per-link ledger equal to
    the host-side sum over the committed rounds; then the degenerate tree,
    crash-resume and a small tree on the card against the CPU."""
    from repro_torch.core.topology import LINK_CLASSES
    spec = api.ExperimentSpec().with_overrides(TOPOLOGY)
    t0 = time.perf_counter()
    run = api.build(spec, device=dev)
    build_s = time.perf_counter() - t0
    env, ex = run.env, run.env.executor()
    topo = env.topology
    check((topo.n_silos, topo.edges_per_silo, topo.k_edge) == (2, 2, 5),
          f"phase 20: tree {topo.n_silos} x {topo.edges_per_silo}, "
          f"K_edge {topo.k_edge}")
    live, round_s = [], []
    orig = ex.fedat_topology_round

    def timed(w, silos, dispatch, s, ids_edges, seed, **k):
        live.append([len(i) for i in ids_edges])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(w, silos, dispatch, s, ids_edges, seed, **k)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        return out

    ex.fedat_topology_round = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = run.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    del ex.fedat_topology_round
    peak = torch.cuda.max_memory_allocated()

    m, st = res.metrics, run.strategy
    rounds = len(round_s)
    check(rounds == 10 and m.rounds and m.rounds[-1] == 10,
          f"phase 20: {rounds} silo rounds, Metrics rounds {m.rounds}")
    check(all(math.isfinite(a) and 0.0 <= a <= 1.0 for a in m.acc),
          f"phase 20: accuracies {m.acc}")
    check(all(bool(torch.isfinite(v).all()) for v in st.w_global.values()),
          "phase 20: non-finite global model")
    check(counts == {"compress": 0, "decompress": 0,
                     "roundtrip": TOPOLOGY_LAUNCHES * rounds,
                     "flash_attention": 0, "flash_attention_bwd": 0,
                     "wkv6": 0, "wkv6_bwd_dstate": 0, "wkv6_bwd": 0,
                     "ssd": 0, "ssd_bwd_dstate": 0, "ssd_bwd": 0},
          f"phase 20: launch counts {counts}, expected "
          f"{TOPOLOGY_LAUNCHES} roundtrip launches x {rounds} silo rounds "
          f"and no other")
    # the ledger, summed on the host from the committed rounds' live
    # counts (quantize8's wire ratio depends on the leaf sizes only)
    mb = env.model_bytes
    ratio = dict(zip(LINK_CLASSES, (c.measure_ratio(env.params0)
                                    for c in st.link_codecs)))
    want = {k: 0.0 for k in LINK_CLASSES}
    for n in live:
        want["client_edge"] += 2 * sum(n) * mb * ratio["client_edge"]
        want["edge_silo"] += 2 * sum(1 for x in n if x) * mb \
            * ratio["edge_silo"]
        want["silo_global"] += 2 * mb * ratio["silo_global"]
    check(st.link_bytes == want,
          f"phase 20: link bytes {st.link_bytes}, expected {want}")
    profile = profile_silo_round(torch, run, kernels)
    del run, env, ex
    # the checks; the resumed runs reuse the cached environment
    part_s = {}
    t0 = time.perf_counter()
    resume = topology_resume(torch, api, dev)
    api.clear_env_cache()
    part_s["resume"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    degenerate = degenerate_tree(torch, api, dev)
    part_s["degenerate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    agree = card_vs_cpu(torch, api, SimEnv, dev, SMALL_TOPOLOGY, "20",
                        "2 silo rounds of a 2 x 2 tree")
    part_s["card_vs_cpu"] = time.perf_counter() - t0
    api.clear_env_cache()
    info = {
        "spec_hash": res.spec_hash, "rounds": rounds, "wall_s": wall,
        "events_per_s": rounds / wall,
        "ms_per_round": 1e3 * float(np.median(round_s)),
        "ms_per_round_each": [1e3 * r for r in round_s],
        "live_per_edge": live, "link_bytes": dict(st.link_bytes),
        "peak_mem_bytes": peak, "launches": counts, "acc": m.acc,
        "sim_time": m.times[-1], "profile": profile, "build_s": build_s,
        "check_s": part_s, "degenerate": degenerate, "resume": resume,
        "card_vs_cpu": agree,
    }
    codec = ("not measured" if profile["device_ms"] is None else
             f"{profile['codec_ms']:.4f} ms of {profile['device_ms']:.1f} "
             f"ms device time in {profile['codec_kernel_events']} events")
    log(f"phase 20: FedAT quantize8 over a 2 x 2 tree at full width, "
        f"{rounds} silo rounds ({m.times[-1]:.1f} simulated s) in "
        f"{wall:.3f} s ({info['events_per_s']:.4f} events/s, "
        f"{info['ms_per_round']:.2f} ms a silo round median), acc {m.acc}, "
        f"peak {peak / 2**20:.1f} MiB, launches {counts}; link bytes "
        f"{st.link_bytes}; B1 in a profiled silo round: {codec}")
    log(f"phase 20: degenerate tree bitwise the flat run; snapshots "
        f"{resume['snapshots_at_cut']} at the cut, resumed in "
        f"{resume['resume_wall_s']:.3f} s, bitwise equal; environment "
        f"built in {build_s:.2f} s, checks took {part_s} s")
    return info


# ---------------------------------------------------------------------------
# phases 21-23: the moe, vlm and audio families
# ---------------------------------------------------------------------------

#: phase 21: granite-moe-3b-a800m at published widths and depth (32
#: layers, 40 experts top-8, about 13 GB of fp32 params) through
#: launch/serve.py: 8 requests over 8 slots, prompts of up to 256 tokens in
#: one prefill wave 256 positions wide (so each row is one 256-token
#: routing group with capacity 64: the reference's capacity path, pad
#: tokens included), 8 new tokens each
MOE_SERVE_ARGV = ["--requests", "8", "--slots", "8", "--prompt-len", "256",
                  "--max-new", "8", "--seed", "0", "--device", "cuda"]
#: deepseek-moe-16b at published widths, cut to 4 of its 28 layers (all
#: 28 take about 67 GB in fp32; 4 hold the shared experts at hd 128)
DEEPSEEK_LAYERS = 4
#: routing on the card against the CPU: combine weights (router
#: probabilities) within this absolute error; dispatch bitwise
ROUTE_ATOL = 1e-6
#: phase 22: paligemma-3b at published widths and depth (18 layers, about
#: 11.7 GB of fp32 params): 4 slots of 256 patch embeddings + 64 text
#: tokens through lm.serve_prefill, then 8 greedy lm.serve_step calls
VLM_WAVE = dict(slots=4, patches=256, text=64, steps=8)
#: phase 23: each family trained at published widths, cut to 2 layers and
#: a global batch of 8 x 4096 tokens (microbatch 8 as published: one
#: sequence a microbatch), two steps, no checkpoint
FAMILY_TRAIN = ("granite-moe-3b-a800m", "paligemma-3b", "hubert-xlarge")
FAMILY_TRAIN_LAYERS = 2
FAMILY_TRAIN_BATCH = 8
#: phase 23 card against CPU at smoke size: the loss within this relative
#: error, the gradient probe within this relative L2
FAMILY_LOSS_RTOL = 1e-5
FAMILY_GRAD_RTOL = 1e-4
#: B2 at hubert-xlarge's training shape: one 4096-frame sequence a
#: microbatch, 16 heads of 80, bidirectional (the model path's first
#: non-causal hd-80 launch)
HUBERT_ATTN = PATH_ATTN_SHAPES["hubert-xlarge training"]


class route_stats:
    """Wraps ``models/moe.py``'s ``_route`` for a ``with`` block: each
    call's group shape, whether it was dropless, and the assignments it
    kept (a device tensor, read after the block)."""

    def __init__(self, moe_mod):
        self.moe, self.calls = moe_mod, []

    def __enter__(self):
        self.orig = self.moe._route

        def counted(cfg, router_w, xg, dropless=False):
            out = self.orig(cfg, router_w, xg, dropless)
            self.calls.append((tuple(xg.shape[:-1]), dropless,
                               out[1].sum()))
            return out
        self.moe._route = counted
        return self

    def __exit__(self, *exc):
        self.moe._route = self.orig

    def dropped_shares(self, top_k: int, dropless: bool):
        """1 - kept / (tokens x top_k) of each call of the given kind."""
        return [1.0 - float(kept) / (math.prod(shape) * top_k)
                for shape, dl, kept in self.calls if dl == dropless]


def moe_wave_split(torch, lm, moe_mod, attn_mod, engine, decode_step_s):
    """One more prefill wave at the engine's shape, outside the counted
    run: its warm time and the share of it in the MoE FFNs (the dense
    dispatch and expert products) and in attention, each call
    synchronised; then a profiled wave and decode step
    (:func:`profile_serving`) against the warm wave and the counted run's
    median step."""
    cfg, B, P = engine.cfg, engine.spec.slots, engine.spec.prefill_len
    toks = torch.randint(0, cfg.vocab_size, (B, P),
                         generator=torch.Generator().manual_seed(5)).to(
        "cuda", torch.int32)

    def wave():
        with torch.no_grad():
            lm.serve_prefill(cfg, engine.params, {"tokens": toks}, 1,
                             engine.cache)
        torch.cuda.synchronize()

    wave()
    t0 = time.perf_counter()
    wave()
    wave_s = time.perf_counter() - t0
    with timed_calls(torch, moe_mod, "moe_ffn") as tm, \
            timed_calls(torch, attn_mod, "prefill_attention") as ta:
        t0 = time.perf_counter()
        wave()
        synced_s = time.perf_counter() - t0
    moe_s, attn_s = sum(tm.seconds["moe_ffn"]), sum(
        ta.seconds["prefill_attention"])
    return {"wave_s": wave_s, "synced_wave_s": synced_s, "moe_ffn_s": moe_s,
            "moe_ffn_share": moe_s / synced_s,
            "prefill_attention_s": attn_s,
            "prefill_attention_share": attn_s / synced_s,
            "profile": profile_serving(
                torch, engine, {"prefill_wave_s": [wave_s],
                                "decode_step_s_median": decode_step_s},
                tag="21")}


def run_moe_serving(torch, kernels, serve_launch, lm, moe_mod, attn_mod,
                    arch, layers=None):
    """An moe arch through launch/serve.py at published widths (depth cut
    to ``layers`` where given), counts from 0: one flash launch per layer
    per prefill wave and no other kernel; the dropped-token share of each
    routed layer of the wave."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with route_stats(moe_mod) as rs:
        t0 = time.perf_counter()
        engine, done, rep = serve_launch.run(
            ["--arch", arch] + MOE_SERVE_ARGV, cfg=cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in _leaves(engine.params))
    waves = len(engine.call_seconds["prefill"])
    steps = len(engine.call_seconds["decode"])
    check(waves == 1, f"{arch}: {waves} prefill waves, expected 1")
    check(counts["flash_attention"] == waves * cfg.n_layers
          and all(n == 0 for k, n in counts.items()
                  if k != "flash_attention"),
          f"{arch}: launches {counts}, expected {waves} x {cfg.n_layers} "
          f"flash and no other kernel")
    check(len(done) == 8 and all(len(r.out) == 8 and not r.truncated
                                 for r in done),
          f"{arch}: requests {[(r.rid, len(r.out)) for r in done]}")
    check(all(0 <= t < cfg.vocab_size for r in done for t in r.out),
          f"{arch}: token ids out of range")
    check(all(len(v) == 1 for v in engine.call_shapes.values()),
          f"{arch}: more than one input shape per call: "
          f"{engine.call_shapes}")
    check(bool(torch.isfinite(engine.cache.k).all()),
          f"{arch}: non-finite KV cache")
    m = cfg.moe
    wave_drop = rs.dropped_shares(m.top_k, dropless=False)
    decode_drop = rs.dropped_shares(m.top_k, dropless=True)
    check(len(wave_drop) == waves * cfg.n_layers,
          f"{arch}: {len(wave_drop)} grouped routings in the wave")
    check(all(d == 0.0 for d in decode_drop),
          f"{arch}: a dropless decode routing dropped tokens")
    info = {"arch": arch, "layers": cfg.n_layers, "n_params": n_params,
            "wall_s": wall, "report": rep, "peak_mem_bytes": peak,
            "launches": counts, "prefill_waves": waves,
            "decode_steps": steps,
            "prefill_wave_s": list(engine.call_seconds["prefill"]),
            "decode_step_s_median": float(np.median(
                engine.call_seconds["decode"])),
            "capacity": moe_mod.capacity(cfg, moe_mod.GROUP),
            "wave_dropped_share": wave_drop,
            "wave_dropped_share_mean": float(np.mean(wave_drop)),
            "prompt_lens": sorted(len(r.prompt) for r in done)}
    log(f"phase 21: {arch} ({cfg.n_layers} layers, {n_params} params, fp32; "
        f"{m.n_experts} experts top-{m.top_k}, capacity {info['capacity']} "
        f"a 256-token group) served 8 requests x 8 tokens in {wall:.3f} s: "
        f"{rep['tok_per_s']:.2f} tok/s, TTFT p50 {rep['ttft_p50_s']:.3f} "
        f"s; prefill wave {info['prefill_wave_s'][0]:.4f} s, decode step "
        f"median {1e3 * info['decode_step_s_median']:.2f} ms over {steps} "
        f"steps; flash launches {counts['flash_attention']}; dropped share "
        f"of the wave's assignments {info['wave_dropped_share_mean']:.4f} "
        f"(layers {min(wave_drop):.4f}-{max(wave_drop):.4f}, pad tokens "
        f"included); peak {peak / 2**30:.2f} GiB")
    return info, engine


def moe_card_vs_cpu(torch, kernels, lm, convert, serve, moe_mod):
    """The moe smoke configs on the card and the CPU from the same params:
    layer 0's routing of the same inputs (grouped and dropless) bitwise
    in its dispatch, engine tokens equal with a 256-wide prefill (the
    grouped path), prefill logits within SERVE_LOGITS_RTOL."""
    from repro_torch.configs.registry import get_smoke_config
    out = {}
    for arch in ("granite-moe-3b-a800m", "deepseek-moe-16b"):
        cfg = get_smoke_config(arch)
        p_cpu = lm.init_params(cfg, seed=1, device="cpu")
        p_card = convert.params_from_numpy(convert.params_to_numpy(p_cpu),
                                           device="cuda")
        rng = np.random.default_rng(4)
        cmb_err = 0.0
        for shape in ((2, 256), (3, 40)):
            x = rng.standard_normal(shape + (cfg.d_model,)).astype(
                np.float32)
            got = {}
            for dev, p in (("card", p_card), ("cpu", p_cpu)):
                xg, dropless = moe_mod.group_tokens(
                    torch.as_tensor(x, device="cuda" if dev == "card"
                                    else "cpu"))
                with torch.no_grad():
                    cmb, dis, _ = moe_mod._route(
                        cfg, p["layers"]["moe"]["router"][0], xg, dropless)
                got[dev] = (cmb.float().cpu(), dis.cpu())
            check(torch.equal(got["card"][1], got["cpu"][1]),
                  f"{arch} {shape}: routing on the card differs from the CPU")
            cmb_err = max(cmb_err, float((got["card"][0]
                                          - got["cpu"][0]).abs().max()))
        check(cmb_err <= ROUTE_ATOL, f"{arch}: combine |card - cpu| "
              f"{cmb_err} > {ROUTE_ATOL}")
        plen, max_new = 256, 6
        spec = serve.ServeSpec(slots=2, max_len=plen + 4 * max_new,
                               prefill_len=plen, max_new=max_new)
        toks = {}
        kernels.reset_launch_counts()
        for dev, p in (("card", p_card), ("cpu", p_cpu)):
            reqs = serve.make_requests(4, 0.0, plen, max_new,
                                       cfg.vocab_size, seed=2)
            done = serve.ServeEngine(cfg, p, spec).run(reqs)
            toks[dev] = {r.rid: (r.out, r.truncated) for r in done}
        launches = kernels.launch_counts()["flash_attention"]
        check(launches > 0, f"{arch}: the card run did not use the kernel")
        check(toks["card"] == toks["cpu"],
              f"{arch}: card and CPU generated different tokens")
        batch = np.random.default_rng(3).integers(
            0, cfg.vocab_size, (2, plen)).astype(np.int32)
        logits = {}
        for dev, p in (("card", p_card), ("cpu", p_cpu)):
            d = "cuda" if dev == "card" else "cpu"
            cache = lm.init_cache(cfg, 2, plen, 1, torch.float32, device=d)
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
        out[arch] = {"tokens": n_tok, "combine_max_abs_err": cmb_err,
                     "rel_l2_prefill_logits": rel,
                     "flash_launches": launches}
        log(f"phase 21: {arch} smoke: routing bitwise on the card and the "
            f"CPU (combine |card - cpu| {cmb_err:.3g}), the same {n_tok} "
            f"tokens (4 requests, 256-wide prefill), prefill logits rel L2 "
            f"{rel:.3g} (tolerance {SERVE_LOGITS_RTOL})")
    return out


def _vlm_batch(torch, cfg, slots, patches, text, device, seed=0):
    rng = np.random.default_rng(seed)
    return {"patch_embeds": torch.as_tensor(rng.standard_normal(
                (slots, patches, cfg.d_model)).astype(np.float32),
                device=device),
            "tokens": torch.as_tensor(rng.integers(
                0, cfg.vocab_size, (slots, text)).astype(np.int32),
                device=device)}


def _vlm_generate(torch, lm, cfg, params, batch, steps, device,
                  last_pos=None, timed=False):
    """Prefill the patches and text, then ``steps`` greedy decode steps;
    returns (prefill logits, tokens (B, steps + 1), prefill s, step s)."""
    B, S = batch["tokens"].shape[0], batch["patch_embeds"].shape[1] + \
        batch["tokens"].shape[1]
    cache = lm.init_cache(cfg, B, S + steps, 1, torch.float32, device=device)
    sync = torch.cuda.synchronize if timed else (lambda: None)
    with torch.no_grad():
        sync()
        t0 = time.perf_counter()
        logits, cache = lm.serve_prefill(cfg, params, batch, 1, cache,
                                         last_pos=last_pos)
        nxt = torch.argmax(logits[:, :cfg.vocab_size], -1).to(torch.int32)
        sync()
        wave_s = time.perf_counter() - t0
        pos = (torch.full((B,), S, dtype=torch.int32, device=device)
               if last_pos is None else last_pos + 1)
        toks, step_s = [nxt], []
        for _ in range(steps):
            t0 = time.perf_counter()
            lg, cache = lm.serve_step(cfg, params, nxt, pos, 1, cache)
            nxt = torch.argmax(lg[:, :cfg.vocab_size], -1).to(torch.int32)
            sync()
            step_s.append(time.perf_counter() - t0)
            toks.append(nxt)
            pos = pos + 1
    return logits, torch.stack(toks, 1).cpu(), wave_s, step_s


def run_vlm_serving(torch, kernels, lm):
    """paligemma-3b at published widths and depth: one prefill of
    VLM_WAVE's patches and text and its greedy decode steps, counts from
    0: no kernel launch (a prefix-LM mask takes the blocked path, the
    reference's rule; decode attends through the cache)."""
    from repro_torch.configs.registry import get_config
    cfg = get_config("paligemma-3b")
    W = VLM_WAVE
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, 0, device="cuda")
    n_params = sum(t.numel() for t in _leaves(params))
    batch = _vlm_batch(torch, cfg, W["slots"], W["patches"], W["text"],
                       "cuda")
    kernels.reset_launch_counts()
    logits, toks, wave_s, step_s = _vlm_generate(
        torch, lm, cfg, params, batch, W["steps"], "cuda", timed=True)
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    check(all(n == 0 for n in counts.values()),
          f"paligemma-3b: launches {counts}, expected none (flash 0: the "
          f"prefix-LM mask takes the blocked path)")
    check(bool(torch.isfinite(logits).all()), "paligemma-3b: non-finite "
          "prefill logits")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "paligemma-3b: token ids out of range")
    n_tok = toks.numel()
    info = {"n_params": n_params, "slots": W["slots"],
            "positions": W["patches"] + W["text"], "launches": counts,
            "prefill_wave_s": wave_s, "decode_step_s": step_s,
            "decode_step_s_median": float(np.median(step_s)),
            "tok_per_s": n_tok / (wave_s + sum(step_s)),
            "peak_mem_bytes": peak}
    log(f"phase 22: paligemma-3b full width ({n_params} params, fp32): "
        f"prefill of {W['slots']} x ({W['patches']} patches + {W['text']} "
        f"tokens) {wave_s:.4f} s, {W['steps']} decode steps median "
        f"{1e3 * info['decode_step_s_median']:.2f} ms, {n_tok} tokens at "
        f"{info['tok_per_s']:.2f} tok/s; launches {counts} (B2 0: the "
        f"prefix-LM mask runs blocked); peak {peak / 2**30:.2f} GiB")
    del params
    return info


def vlm_card_vs_cpu(torch, kernels, lm, convert):
    """paligemma-smoke on the card and the CPU from the same params and
    batch, left-aligned prompts of three lengths: prefill logits within
    SERVE_LOGITS_RTOL and the same greedy tokens."""
    from repro_torch.configs.registry import get_smoke_config
    cfg = get_smoke_config("paligemma-3b")
    p_cpu = lm.init_params(cfg, seed=1, device="cpu")
    p_card = convert.params_from_numpy(convert.params_to_numpy(p_cpu),
                                       device="cuda")
    res = {}
    for dev, p in (("card", p_card), ("cpu", p_cpu)):
        d = "cuda" if dev == "card" else "cpu"
        batch = _vlm_batch(torch, cfg, 3, 16, 32, d, seed=6)
        last = torch.tensor([47, 40, 30], dtype=torch.int32, device=d)
        lg, toks, _, _ = _vlm_generate(torch, lm, cfg, p, batch, 6, d,
                                       last_pos=last)
        res[dev] = (lg.float().cpu(), toks)
    rel = float((res["card"][0] - res["cpu"][0]).norm()
                / res["cpu"][0].norm())
    check(rel <= SERVE_LOGITS_RTOL,
          f"paligemma smoke: prefill logits card vs CPU rel L2 {rel}")
    check(torch.equal(res["card"][1], res["cpu"][1]),
          "paligemma smoke: card and CPU generated different tokens")
    log(f"phase 22: paligemma smoke: prefill logits |card - cpu| / |cpu| "
        f"= {rel:.3g} (tolerance {SERVE_LOGITS_RTOL}), the same "
        f"{res['card'][1].numel()} greedy tokens")
    return {"rel_l2_prefill_logits": rel, "tokens": res["card"][1].numel()}


def run_family_training(torch, kernels):
    """launch/train.py (``train.run``: the guarded runner, its ce_loss and
    aux_loss logging) for each of FAMILY_TRAIN at published widths, cut to
    FAMILY_TRAIN_LAYERS layers and a global batch of FAMILY_TRAIN_BATCH x
    4096: two steps each with ``--ckpt-every 0`` (no checkpoint written),
    counts from 0 per arch."""
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import ShapeConfig
    import shutil
    from repro_torch.launch import train
    shape = ShapeConfig("train_4k", 4096, FAMILY_TRAIN_BATCH, "train")
    ckdir = ROOT / "build" / "chip_smoke_family_train"
    shutil.rmtree(ckdir, ignore_errors=True)
    out = {}
    for arch in FAMILY_TRAIN:
        cfg = get_config(arch).replace(n_layers=FAMILY_TRAIN_LAYERS)
        mb, L = cfg.microbatch, cfg.n_layers
        check(mb == 8 and cfg.remat and cfg.scan_layers,
              f"{arch} trains with microbatch {mb}, remat {cfg.remat}")
        argv = ["--arch", arch, "--steps", "2", "--ckpt-dir", str(ckdir),
                "--ckpt-every", "0", "--seed", "0", "--device", "cuda"]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        res = train.run(train.parser().parse_args(argv), cfg=cfg,
                        shape=shape)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        n_params = sum(t.numel() for t in _leaves(res.state["params"]))
        res.state = None
        rows, secs = res.metrics, res.step_seconds
        batch_s = res.batch_seconds
        check(res.end_step == 2 and len(rows) == 2
              and res.runner_stats["failures"] == 0,
              f"{arch}: steps {res.start_step}..{res.end_step}, runner "
              f"{res.runner_stats}")
        check(not any(ckdir.iterdir()),
              f"{arch}: --ckpt-every 0 wrote {sorted(ckdir.iterdir())}")
        # flash per step: a forward per layer per microbatch, twice under
        # remat, and a backward; the vlm prefix runs blocked (none)
        flash = 0 if cfg.family == "vlm" else mb * L
        want = {"flash_attention": 2 * 2 * flash,
                "flash_attention_bwd": 2 * flash}
        check(all(counts[k] == v for k, v in want.items())
              and all(n == 0 for k, n in counts.items() if k not in want),
              f"{arch}: launches {counts} over 2 steps, expected {want}")
        check(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                  for r in rows), f"{arch}: losses {rows}")
        check(all((r["aux_loss"] > 0) == (cfg.family == "moe")
                  for r in rows),
              f"{arch}: aux losses {[r['aux_loss'] for r in rows]}")
        out[arch] = {"layers": L, "batch": FAMILY_TRAIN_BATCH, "seq": 4096,
                     "microbatch": mb, "n_params": n_params,
                     "step_s": secs, "batch_s": batch_s, "metrics": rows,
                     "launches": counts,
                     "launches_per_step": {k: v // 2 for k, v in
                                           counts.items()},
                     "peak_mem_bytes": peak,
                     "tokens_per_s": FAMILY_TRAIN_BATCH * 4096 / secs[1]}
        log(f"phase 23: {arch} trained through launch/train.py at published "
            f"widths ({L} layers, {n_params} params, batch "
            f"{FAMILY_TRAIN_BATCH} x 4096, microbatch {mb}, remat, fp32 "
            f"AdamW, no checkpoint): steps {[round(s, 3) for s in secs]} s "
            f"(making the host batch {[round(s, 3) for s in batch_s]} s "
            f"more), "
            f"losses {[r['loss'] for r in rows]}, ce_loss "
            f"{[r['ce_loss'] for r in rows]}, aux_loss "
            f"{[r['aux_loss'] for r in rows]}; flash launches a step "
            f"{counts['flash_attention'] // 2} forward, "
            f"{counts['flash_attention_bwd'] // 2} backward"
            f"{' (non-causal)' if not cfg.causal else ''}; peak "
            f"{peak / 2**30:.2f} GiB")
        torch.cuda.empty_cache()
    return out


def family_training_card_vs_cpu(torch, kernels, lm, convert):
    """One loss and gradient probe of each FAMILY_TRAIN smoke config on
    the card (through the flash kernels, forward and backward, for moe
    and audio; counted) and the CPU, from the same params and pipeline
    batch (256 positions: the moe grouped path).  The probe is the token
    embedding, or frontend_proj for audio (tests/test_models_smoke.py's)."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models.common import flatten_tree, unflatten_tree
    out = {}
    for arch in FAMILY_TRAIN:
        cfg = get_smoke_config(arch)
        p_cpu = lm.init_params(cfg, seed=2, device="cpu")
        batch = TokenPipeline(cfg, ShapeConfig("s", 256, 2, "train"),
                              seed=3).batch(0)
        probe = "frontend_proj" if cfg.family == "audio" else "embed"
        res = {}
        for dev in ("cuda", "cpu"):
            kernels.reset_launch_counts()
            flat = flatten_tree(convert.params_from_numpy(
                convert.params_to_numpy(p_cpu), device=dev))
            flat[probe].requires_grad_(True)
            b = {k: torch.as_tensor(np.asarray(v), device=dev)
                 for k, v in batch.items()}
            loss, metrics = lm.loss_fn(cfg, unflatten_tree(flat), b, 1)
            (g,) = torch.autograd.grad(loss, [flat[probe]])
            res[dev] = (float(loss.detach()),
                        float(metrics["aux_loss"].detach()), g.float().cpu())
            if dev == "cuda":
                launches = kernels.launch_counts()
        fl = {k: launches[k] for k in ("flash_attention",
                                       "flash_attention_bwd")}
        check(all((n > 0) == (cfg.family != "vlm") for n in fl.values()),
              f"{arch} smoke: the card run launched {fl} (the flash "
              f"kernels both ways for moe and audio, none for the vlm "
              f"prefix)")
        dl = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
        dg = float((res["cuda"][2] - res["cpu"][2]).norm()
                   / res["cpu"][2].norm())
        check(dl <= FAMILY_LOSS_RTOL,
              f"{arch} smoke: loss card {res['cuda'][0]} vs CPU "
              f"{res['cpu'][0]}")
        check(dg <= FAMILY_GRAD_RTOL,
              f"{arch} smoke: grad of {probe} card vs CPU rel L2 {dg}")
        out[arch] = {"loss_rel_err": dl, "grad_rel_l2": dg, "probe": probe,
                     "loss": res["cuda"][0], "aux_loss": res["cuda"][1],
                     "flash_launches": fl}
        log(f"phase 23: {arch} smoke: loss card vs CPU rel {dl:.3g} "
            f"(tolerance {FAMILY_LOSS_RTOL}), grad of {probe} rel L2 "
            f"{dg:.3g} (tolerance {FAMILY_GRAD_RTOL}); card launches {fl}")
    return out


def time_hubert_attention(torch, fa, ref):
    """B2 forward and backward at HUBERT_ATTN (non-causal, hd 80), fp32
    as the path runs it: kernel, plain version, SDPA and the bound."""
    g = torch.Generator(device="cuda").manual_seed(21)
    fwd = time_flash(torch, fa, ref, g, HUBERT_ATTN, "float32",
                     causal=HUBERT_ATTN["causal"])
    bwd = time_flash_bwd(torch, fa, ref, g, HUBERT_ATTN, "float32",
                         causal=HUBERT_ATTN["causal"])
    for name, t in (("forward", fwd), ("backward", bwd)):
        log(f"phase 23: flash {name} at hubert's shape "
            f"{HUBERT_ATTN} non-causal fp32: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, SDPA "
            f"{'not measured' if t['library_ms'] is None else '%.4f ms' % t['library_ms']}, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    return {"forward": fwd, "backward": bwd}


# ---------------------------------------------------------------------------
# phase 24: the recurrent families trained, and the scans' backward
# ---------------------------------------------------------------------------

#: phase 24: each recurrent family trained at published widths, cut in
#: depth (rwkv6-3b to 2 of 32 layers, as phase 23 cuts; zamba2-2.7b to 6
#: of 54, one shared-attention application: n_layers must be a multiple
#: of attn_every = 6), a global batch of 8 x 4096 tokens (microbatch 8:
#: one sequence a microbatch), two steps, no checkpoint
RECURRENT_TRAIN = {"rwkv6-3b": 2, "zamba2-2.7b": 6}
RECURRENT_TRAIN_BATCH = 8
#: the backward kernels' shapes on that path: one 4096-token microbatch
#: of rwkv6-3b (40 heads of 64) and of zamba2-2.7b (80 SSD heads, P = N =
#: 64), a ragged S (not a multiple of the kernels' chunk of 32) at full
#: width, and strong decays: logw = -8 (WKV6), da from -U(0, 8) (SSD: a
#: 32-token chunk sums to about 128, past the 88 where the reference's
#: gradient overflows)
WKV_TRAIN = dict(B=1, S=4096, H=40, N=64)
SSD_TRAIN = dict(B=1, S=4096, H=80, P=64, N=64)
WKV_BWD_RAGGED = dict(B=2, S=1000, H=40, N=64)
SSD_BWD_RAGGED = dict(B=2, S=1000, H=80, P=64, N=64)
#: each gradient of a backward kernel against its plain version on the
#: same inputs, as max |err| / max |plain| (fp32; measured on an H100 at
#: the training shape and a ragged S: at most 3.0e-6 for WKV6, 2.8e-6 for
#: SSD)
SCAN_BWD_RTOL = 1e-4
#: under strong decays a gradient can be a small sum of large terms that
#: cancel (dlogw at logw = -8: its max is 0.054 against terms of order
#: 10), where fp32 itself is off by more than SCAN_BWD_RTOL (the fp32
#: plain version by 3.8e-4 of it on the CPU).  There both the kernel and
#: the fp32 plain version are held to the plain version in float64, and
#: the kernel's error must be within SCAN_BWD_RTOL or this factor of the
#: fp32 plain version's own
SCAN_BWD_F32_FACTOR = 4.0
#: phase 24's card against CPU at smoke size: the loss within this
#: relative error, every parameter's gradient within this relative L2
RECURRENT_LOSS_RTOL = 1e-5
RECURRENT_GRAD_RTOL = 1e-4


def scan_bwd_bound(kind, B, S, H, N, P=None):
    """Least time for one backward launch, fp32: the function's inputs
    (the forward's, the state in and dy) read once and its gradients
    written once; operations of the chunked form at BOUND_CHUNK (a
    multiply-add counts 2, an exp 1).  WKV6, per chunk and head: the four
    (C, N) x (N, N) products (v dS^T, dy S^T, kd dS, rd^T dy), the lower
    triangle of dy v^T and of A^T dy ((C(C-1)/2 + C) N each), and for the
    strictly-lower pairs A and the two pairwise sums of dr and dk (3 of
    C(C-1)/2 N multiply-adds, C(C-1)/2 N exps).  SSD, per chunk and head:
    the four (C, P) x (P, N)-sized products (B dh^T, dye h, xd dh, dye^T
    C), the lower triangles of dy x^T and M^T dy (P) and of dG^T C and
    dG B (N), and C B^T once per batch row."""
    C = BOUND_CHUNK
    pairs, vis = C * (C - 1) // 2, C * (C + 1) // 2
    chunks = -(-S // C)
    if kind == "wkv6":
        nbytes = 4 * (9 * B * S * H * N + 2 * B * H * N * N + 2 * H * N)
        flops = wkv6_bwd_flops(B, S, H, N, C) + B * H * chunks * pairs * N
    else:
        nbytes = 4 * (4 * B * S * H * P + 4 * B * S * N + 2 * B * S * H
                      + 2 * B * H * P * N)
        flops = (ssd_bwd_flops(B, S, H, P, N, C)
                 + B * chunks * H * (vis + 2 * C))
    return _bound(nbytes, flops, "float32")


def scan_dstate_bound(kind, B, S, H, N, P=None):
    """Least time for pass 1 of a backward alone (``*_bwd_dstate``): its
    inputs (WKV6: r, logw, dy; SSD: C, da, dy) and the final state's
    gradient read once, the state's gradient after every chunk and at the
    start written once; the one product a chunk and head (rd^T dy, 2 C N
    N, or dye^T C, 2 C P N) and its decays (an exp, a multiply and an add
    per element: 3 C N, or 3 C for SSD's scalar decay and C P multiplies
    for dye), at BOUND_CHUNK."""
    C = BOUND_CHUNK
    chunks = -(-S // C)
    if kind == "wkv6":
        nbytes = 4 * (3 * B * S * H * N + (chunks + 2) * B * H * N * N)
        flops = B * H * chunks * (2 * C * N * N + 3 * C * N)
    else:
        nbytes = 4 * (B * S * H * P + B * S * N + B * S * H
                      + (chunks + 2) * B * H * P * N)
        flops = B * H * chunks * (2 * C * P * N + C * P + 3 * C)
    return _bound(nbytes, flops, "float32")


def _bwd_case(torch, g, kind, case, strong):
    """Callables over one case's inputs and cotangents: the kernel's
    backward ("kern", reading the chunk states its forward wrote) and the
    plain version's in a given dtype ("plain": fp32 by default, float64 as
    the oracle of the strong-decay case); pass 1 alone and its plain
    version ("pass1", "pass1_plain"); pass 2 alone given pass 1's output
    ("pass2"); the forward kernel's training instantiation (writing the
    chunk states) and its serving one ("fwd_train", "fwd_serve")."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv6_scan, ssd
    if kind == "wkv6":
        r, k, v, logw, u, s0 = wkv_inputs(torch, g, dtype="float32",
                                          strong=strong, **case)
        ins = (r, k, v, logw, u, s0)
        dy, dst = torch.randn_like(r), torch.randn_like(s0)
        B, S, H, N = r.shape
        cs = torch.empty((B, H, rwkv6_scan.n_chunks(S), N, N),
                         device="cuda")
        st = s0.clone()
        rwkv6_scan.wkv6(*ins[:5], st, chunk_states=cs)
        return {
            "kern": lambda: rwkv6_scan.wkv6_backward(
                *ins, dy, dst, chunk_states=cs),
            "plain": lambda dt=torch.float32: ref.wkv6_chunked_backward(
                *(t.to(dt) for t in ins + (dy, dst)), chunk=SCAN_CHUNK),
            "pass1": lambda: rwkv6_scan.wkv6_backward_dstates(
                r, logw, dy, dst),
            "pass1_plain": lambda: ref.wkv6_chunk_dstates(
                r, logw, dy, dst, SCAN_CHUNK),
            "pass2": lambda ds: rwkv6_scan.wkv6_backward_chunks(
                r, k, v, logw, u, cs, ds, dy),
            "fwd_train": lambda: rwkv6_scan.wkv6(*ins[:5], st,
                                                 chunk_states=cs),
            "fwd_serve": lambda: rwkv6_scan.wkv6(*ins[:5], st)}
    x, Bm, Cm, da, h0 = ssd_inputs(torch, g, dtype="float32", **case)
    if strong:
        da = -8.0 * torch.rand(da.shape, device="cuda", generator=g)
    ins = (x, Bm, Cm, da, h0)
    dy, dst = torch.randn_like(x), torch.randn_like(h0)
    B, S, H, P = x.shape
    cs = torch.empty((B, H, ssd.n_chunks(S), P, Bm.shape[-1]),
                     device="cuda")
    st = h0.clone()
    ssd.ssd_scan(*ins[:4], st, chunk_states=cs)
    return {
        "kern": lambda: ssd.ssd_backward(*ins, dy, dst, chunk_states=cs),
        "plain": lambda dt=torch.float32: ref.ssd_chunked_backward(
            *(t.to(dt) for t in ins + (dy, dst)), chunk=SCAN_CHUNK),
        "pass1": lambda: ssd.ssd_backward_dstates(Cm, da, dy, dst),
        "pass1_plain": lambda: ref.ssd_chunk_dstates(Cm, da, dy, dst,
                                                     SCAN_CHUNK),
        "pass2": lambda ds: ssd.ssd_backward_chunks(x, Bm, Cm, da, cs, ds,
                                                    dy),
        "fwd_train": lambda: ssd.ssd_scan(*ins[:4], st, chunk_states=cs),
        "fwd_serve": lambda: ssd.ssd_scan(*ins[:4], st)}


def scan_bwd_passes(torch, kind, case):
    """Each pass's registers, shared memory, CTAs per SM, resident warps
    per SM, grid and waves on the card at ``case``; spills from the build
    log when this process built the library."""
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import rwkv6_scan, ssd
    mod = rwkv6_scan if kind == "wkv6" else ssd
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = case["N"] if kind == "wkv6" else case["P"]
    grids = {1: case["B"] * case["H"] * -(-rows // 16),
             2: case["B"] * case["H"] * -(-case["S"] // SCAN_CHUNK)}
    usage = ptxas_usage(str(kbuild.BUILD_INFO.get(f"{kind}_bwd", {})
                            .get("log", "")))
    out = {}
    for which, name in ((1, f"{kind}_bwd_dstate"), (2, f"{kind}_bwd")):
        a = mod.bwd_attrs(which)
        check(a["ctas_per_sm"] > 0, f"{name}: no CTA fits on an SM ({a})")
        spill = next((u for fn, u in usage.items()
                      if f"{name}_kernel" in fn), {})
        a.update(grid=grids[which],
                 warps_per_sm=a["ctas_per_sm"] * a["threads"] // 32,
                 waves=grids[which] / (a["ctas_per_sm"] * sms),
                 spill_stores=spill.get("spill_stores"),
                 spill_loads=spill.get("spill_loads"))
        out[name] = a
        log(f"phase 24: {name}: {a['registers']} registers, "
            f"{a['smem_bytes'] / 1024:.1f} KiB shared memory a CTA, "
            f"{a['ctas_per_sm']} CTAs ({a['warps_per_sm']} warps) an SM; "
            f"grid {a['grid']} at {case}: {a['waves']:.2f} waves; spills "
            f"{a['spill_stores']} / {a['spill_loads']} bytes")
    return out


def check_scan_bwd(torch, kind):
    """B3's or B4's backward against its plain version on the card at the
    training microbatch, a ragged S and strong decays (SCAN_BWD_RTOL, or
    SCAN_BWD_F32_FACTOR against float64 where fp32 is ill-conditioned),
    pass 1's state gradients against its plain version, two calls on the
    same inputs bitwise equal; then timed at the training shape beside the
    plain version and the bound, each pass alone, and the forward kernel's
    training and serving instantiations at the same shape."""
    g = torch.Generator(device="cuda").manual_seed(
        24 if kind == "wkv6" else 25)
    names = (("r", "k", "v", "logw", "u", "state0") if kind == "wkv6" else
             ("x", "B", "C", "da", "h0"))
    full, ragged = ((WKV_TRAIN, WKV_BWD_RAGGED) if kind == "wkv6" else
                    (SSD_TRAIN, SSD_BWD_RAGGED))
    errs, strong_errs, pass1_errs = {}, {}, {}
    for label, case, strong in (("training shape", full, False),
                                ("ragged S", ragged, False),
                                ("strong decay", ragged, True)):
        fns = _bwd_case(torch, g, kind, case, strong)
        got, want = fns["kern"](), fns["plain"]()
        again = fns["kern"]()
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(t).all()) for t in got),
              f"{kind}_bwd {label} {case}: non-finite gradients")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{kind}_bwd {label} {case}: two calls on the same inputs "
              f"differ")
        e = {n: _rel(a, b) for n, a, b in zip(names, got, want)}
        if not strong:
            check(max(e.values()) <= SCAN_BWD_RTOL,
                  f"{kind}_bwd {label} {case}: errors {e} > "
                  f"{SCAN_BWD_RTOL}")
            errs[label] = e
            p_got, p_want = fns["pass1"](), fns["pass1_plain"]()
            e1 = {n: _rel(a, b) for n, a, b in zip(
                ("dstates", "dstate0"), p_got, p_want)}
            check(max(e1.values()) <= SCAN_BWD_RTOL,
                  f"{kind}_bwd_dstate {label} {case}: errors {e1} > "
                  f"{SCAN_BWD_RTOL}")
            pass1_errs[label] = e1
            log(f"phase 24: {kind}_bwd_dstate {label} {case}: max |err| / "
                f"max |plain| " + ", ".join(f"{n} {x:.3g}"
                                            for n, x in e1.items()))
            del p_got, p_want
        else:
            exact = fns["plain"](torch.float64)
            ek = {n: _rel(a, b) for n, a, b in zip(names, got, exact)}
            ep = {n: _rel(a, b) for n, a, b in zip(names, want, exact)}
            bad = {n: (ek[n], ep[n]) for n in names if ek[n] > max(
                SCAN_BWD_RTOL, SCAN_BWD_F32_FACTOR * ep[n])}
            check(not bad, f"{kind}_bwd {label} {case}: (kernel, fp32 "
                  f"plain) errors against float64 {bad}")
            strong_errs = {"vs_plain": e, "kernel_vs_f64": ek,
                           "plain_vs_f64": ep}
        log(f"phase 24: {kind}_bwd {label} {case}: max |err| / max |plain| "
            + ", ".join(f"{n} {x:.3g}" for n, x in e.items())
            + "; two calls bitwise equal"
            + ("" if not strong else "; against float64: kernel "
               + ", ".join(f"{n} {x:.3g}" for n, x in ek.items())
               + "; fp32 plain "
               + ", ".join(f"{n} {x:.3g}" for n, x in ep.items())))
        del fns, got, again, want
        torch.cuda.empty_cache()
    fns = _bwd_case(torch, g, kind, full, False)
    times = _time_pair(torch, fns["kern"], fns["plain"])
    ds, _ = fns["pass1"]()
    p1 = [event_time_ms(torch, fns["pass1"]) for _ in range(2)]
    p2 = [event_time_ms(torch, lambda: fns["pass2"](ds)) for _ in range(2)]
    p1_plain = event_time_ms(torch, fns["pass1_plain"], 3)
    fwd = {k: min(event_time_ms(torch, fns[k]) for _ in range(2))
           for k in ("fwd_train", "fwd_serve")}
    del ds
    fb = (wkv_bound(dtype="float32", **full) if kind == "wkv6" else
          ssd_bound(dtype="float32", **full))
    rows = full["N"] if kind == "wkv6" else full["P"]
    # the training instantiation also writes the chunk-start states
    fwd_bound = _bound(fb["bytes"] + 4 * full["B"] * full["H"] * -(
        -full["S"] // SCAN_CHUNK) * rows * full["N"], fb["flops"], "float32")
    b1 = scan_dstate_bound(kind, **full)
    o = dict(scan_bwd_bound(kind, **full), **times, shape=full,
             max_abs_err=max(max(e.values()) for e in errs.values()),
             errors=errs, strong=strong_errs, library_ms=None, bitwise=True,
             pass1_ms=min(p1), pass1_ms_runs=p1, pass2_ms=min(p2),
             pass2_ms_runs=p2, pass1_plain_ms=p1_plain,
             pass1_bound_ms=b1["bound_ms"], pass1_bound_by=b1["bound_by"],
             pass1_errors=pass1_errs,
             pass1_max_abs_err=max(max(e.values())
                                   for e in pass1_errs.values()),
             passes=scan_bwd_passes(torch, kind, full),
             fwd_train_ms=fwd["fwd_train"], fwd_serve_ms=fwd["fwd_serve"],
             fwd_train_bound_ms=fwd_bound["bound_ms"],
             fwd_train_bound_by=fwd_bound["bound_by"])
    log(f"phase 24: {kind}_bwd at the training shape {full}: kernel "
        f"{o['ms']:.4f} ms a call (runs {o['ms_runs'][0]:.4f}/"
        f"{o['ms_runs'][1]:.4f}; pass 1 {o['pass1_ms']:.4f}, pass 2 "
        f"{o['pass2_ms']:.4f} alone), plain {o['plain_ms']:.4f} ms, bound "
        f"{o['bound_ms']:.4f} ms ({o['bound_by']}: {o['flops'] / 1e9:.2f} "
        f"GFLOP at C = {BOUND_CHUNK}, {o['bytes'] / 1e6:.1f} MB), on the "
        f"tensor cores {o['tc_bound_ms']:.4f} ms; no library call computes "
        f"it.  Pass 1: plain {p1_plain:.4f} ms, bound {b1['bound_ms']:.4f} "
        f"ms ({b1['bound_by']})")
    log(f"phase 24: {kind} forward at the training shape {full}: training "
        f"instantiation (chunk states written) {fwd['fwd_train']:.4f} ms, "
        f"bound {fwd_bound['bound_ms']:.4f} ms ({fwd_bound['bound_by']}); "
        f"serving instantiation {fwd['fwd_serve']:.4f} ms")
    del fns
    torch.cuda.empty_cache()
    return o


def run_recurrent_training(torch, kernels):
    """launch/train.py (``train.run``) for each of RECURRENT_TRAIN at
    published widths cut in depth, a global batch of
    RECURRENT_TRAIN_BATCH x 4096: two steps each with ``--ckpt-every 0``,
    counts from 0 per arch, each checked exactly against the count the
    port's code gives."""
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import ShapeConfig
    import shutil
    from repro_torch.launch import train
    shape = ShapeConfig("train_4k", 4096, RECURRENT_TRAIN_BATCH, "train")
    ckdir = ROOT / "build" / "chip_smoke_recurrent_train"
    shutil.rmtree(ckdir, ignore_errors=True)
    out = {}
    for arch, layers in RECURRENT_TRAIN.items():
        cfg = get_config(arch).replace(n_layers=layers)
        mb, L = cfg.microbatch, cfg.n_layers
        check(mb == 8 and cfg.remat,
              f"{arch} trains with microbatch {mb}, remat {cfg.remat}")
        if cfg.family == "ssm":
            # per step: each layer's WKV6 forward per microbatch twice
            # (once more in the checkpointed recompute), its backward once
            want = {"wkv6": 2 * 2 * mb * L, "wkv6_bwd_dstate": 2 * mb * L,
                    "wkv6_bwd": 2 * mb * L}
        else:
            # per step: each mamba2 layer's SSD forward per microbatch
            # twice (remat) and its backward once; the shared block, not
            # under remat, a flash forward and backward per application
            apps = L // cfg.attn_every
            check(apps * cfg.attn_every == L, f"{arch}: {L} layers")
            want = {"ssd": 2 * 2 * mb * L, "ssd_bwd_dstate": 2 * mb * L,
                    "ssd_bwd": 2 * mb * L,
                    "flash_attention": 2 * mb * apps,
                    "flash_attention_bwd": 2 * mb * apps}
        argv = ["--arch", arch, "--steps", "2", "--ckpt-dir", str(ckdir),
                "--ckpt-every", "0", "--seed", "0", "--device", "cuda"]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        res = train.run(train.parser().parse_args(argv), cfg=cfg,
                        shape=shape)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        n_params = sum(t.numel() for t in _leaves(res.state["params"]))
        prof = profile_recurrent_step(torch, cfg, res.state, shape, arch)
        res.state = None
        rows, secs = res.metrics, res.step_seconds
        check(res.end_step == 2 and len(rows) == 2
              and res.runner_stats["failures"] == 0,
              f"{arch}: steps {res.start_step}..{res.end_step}, runner "
              f"{res.runner_stats}")
        check(not ckdir.exists() or not any(ckdir.iterdir()),
              f"{arch}: --ckpt-every 0 wrote {sorted(ckdir.iterdir())}")
        check(all(counts[k] == v for k, v in want.items())
              and all(n == 0 for k, n in counts.items() if k not in want),
              f"{arch}: launches {counts} over 2 steps, expected {want}")
        check(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                  for r in rows), f"{arch}: losses {rows}")
        out[arch] = {"layers": L, "batch": RECURRENT_TRAIN_BATCH,
                     "seq": 4096, "microbatch": mb, "n_params": n_params,
                     "step_s": secs, "batch_s": res.batch_seconds,
                     "metrics": rows, "launches": counts,
                     "expected_launches": want,
                     "launches_per_step": {k: v // 2 for k, v in
                                           counts.items()},
                     "peak_mem_bytes": peak,
                     "tokens_per_s": RECURRENT_TRAIN_BATCH * 4096 / secs[1],
                     "profile": prof}
        log(f"phase 24: {arch} trained through launch/train.py at published "
            f"widths ({L} of {get_config(arch).n_layers} layers, {n_params} "
            f"params, batch {RECURRENT_TRAIN_BATCH} x 4096, microbatch {mb}, "
            f"remat, fp32 AdamW, no checkpoint): steps "
            f"{[round(s, 3) for s in secs]} s, "
            f"{out[arch]['tokens_per_s']:.0f} tokens/s at step 2, losses "
            f"{[r['loss'] for r in rows]}, grad_norms "
            f"{[r['grad_norm'] for r in rows]}; launches a step "
            f"{out[arch]['launches_per_step']}; peak {peak / 2**30:.2f} GiB")
        torch.cuda.empty_cache()
    return out


#: phase 24's profiled step: each kernel class by substrings of its name
STEP_CLASSES = (("scan forward", ("wkv6_kernel", "ssd_kernel")),
                ("scan backward", ("wkv6_bwd", "ssd_bwd")),
                ("B2 forward", ("flash_fwd",)),
                ("B2 backward", ("flash_bwd",)),
                ("GEMM", ("gemm", "nvjet", "cutlass", "xmma")))


def profile_recurrent_step(torch, cfg, state, shape, arch):
    """Step 3 of a recurrent arch (after train.run's two) under
    torch.profiler: its host seconds (synchronised), the device time of
    each STEP_CLASSES class and the rest, and the busy share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import steps as steps_mod
    from repro_torch.data.pipeline import TokenPipeline
    fns = steps_mod.make_single_pod_step(cfg, TrainConfig(total_steps=3),
                                         device="cuda")
    batch = TokenPipeline(cfg, shape, seed=0).batch(2)
    torch.cuda.synchronize()
    # the card's activity only: the kernels' names and device time are all
    # the split needs
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, m = fns.train_step(state, batch)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    check(math.isfinite(float(m["loss"])), f"{arch}: profiled step 3 loss "
          f"{float(m['loss'])}")
    per_kernel = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            per_kernel[e.key] = per_kernel.get(e.key, 0.0) + \
                e.self_device_time_total / 1e3
    dev_ms = sum(per_kernel.values())
    # the profile's records go now, not during a later timed step
    del prof
    gc.collect()
    out = {"step_s": step_s, "device_ms": dev_ms}
    if dev_ms == 0:
        log(f"phase 24: {arch}: the profiler saw no kernel time: shares not "
            f"measured")
        return out
    shares = dict.fromkeys([c for c, _ in STEP_CLASSES] + ["rest"], 0.0)
    for k, t in per_kernel.items():
        name = next((c for c, subs in STEP_CLASSES
                     if any(x in k.lower() for x in subs)), "rest")
        shares[name] += t
    out.update({"busy_share": dev_ms / (1e3 * step_s), "class_ms": shares,
                "top_kernels_ms": {k[:100]: t for k, t in sorted(
                    per_kernel.items(), key=lambda kv: -kv[1])[:8]}})
    log(f"phase 24: {arch} step 3 profiled: {step_s:.3f} s, kernels "
        f"{dev_ms:.1f} ms (busy {100 * out['busy_share']:.1f}%): "
        + ", ".join(f"{c} {t:.1f} ms ({100 * t / dev_ms:.1f}%)"
                    for c, t in shares.items()))
    for k, t in out["top_kernels_ms"].items():
        log(f"  {t:10.2f} ms  {k}")
    return out


def recurrent_training_card_vs_cpu(torch, kernels, lm, convert):
    """One loss and the gradient of every parameter of rwkv6-smoke and
    zamba2-smoke on the card (through the scan kernels both ways and, for
    zamba2, the flash kernels; counted) and the CPU, from the same params
    and a pipeline batch of 2 x 200 tokens (200: the scans' last chunk is
    ragged)."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models.common import flatten_tree, unflatten_tree
    out = {}
    for arch in RECURRENT_TRAIN:
        cfg = get_smoke_config(arch)
        p_cpu = lm.init_params(cfg, seed=2, device="cpu")
        batch = TokenPipeline(cfg, ShapeConfig("s", 200, 2, "train"),
                              seed=3).batch(0)
        res = {}
        for dev in ("cuda", "cpu"):
            kernels.reset_launch_counts()
            flat = flatten_tree(convert.params_from_numpy(
                convert.params_to_numpy(p_cpu), device=dev))
            for t in flat.values():
                t.requires_grad_(True)
            b = {k: torch.as_tensor(np.asarray(v), device=dev)
                 for k, v in batch.items()}
            loss, _ = lm.loss_fn(cfg, unflatten_tree(flat), b, 1)
            grads = torch.autograd.grad(loss, list(flat.values()))
            res[dev] = (float(loss.detach()),
                        {n: g.float().cpu() for n, g in zip(flat, grads)})
            if dev == "cuda":
                launches = {k: n for k, n in kernels.launch_counts().items()
                            if n}
        scans = (("wkv6", "wkv6_bwd_dstate", "wkv6_bwd")
                 if cfg.family == "ssm" else
                 ("ssd", "ssd_bwd_dstate", "ssd_bwd", "flash_attention",
                  "flash_attention_bwd"))
        check(all(launches.get(k, 0) > 0 for k in scans),
              f"{arch} smoke: the card run launched {launches}")
        dl = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
        dg = {n: float((g - res["cpu"][1][n]).norm()
                       / res["cpu"][1][n].norm().clamp_min(1e-30))
              for n, g in res["cuda"][1].items()}
        worst = max(dg, key=dg.get)
        check(dl <= RECURRENT_LOSS_RTOL,
              f"{arch} smoke: loss card {res['cuda'][0]} vs CPU "
              f"{res['cpu'][0]}")
        check(dg[worst] <= RECURRENT_GRAD_RTOL,
              f"{arch} smoke: grad of {worst} card vs CPU rel L2 "
              f"{dg[worst]}")
        out[arch] = {"loss_rel_err": dl, "grad_rel_l2": dg,
                     "worst_leaf": worst, "loss": res["cuda"][0],
                     "launches": launches}
        log(f"phase 24: {arch} smoke: loss card vs CPU rel {dl:.3g} "
            f"(tolerance {RECURRENT_LOSS_RTOL}); every one of {len(dg)} "
            f"gradient leaves within rel L2 {dg[worst]:.3g} (worst: "
            f"{worst}; tolerance {RECURRENT_GRAD_RTOL}); card launches "
            f"{launches}")
    return out


# ---------------------------------------------------------------------------
# phases 25-27: multi-device execution (the mesh)
# ---------------------------------------------------------------------------

#: phase 26: the client-sharded round at phase 3's width on 2 ranks
SHARDED_RANKS = 2
SHARDED_UPDATES = 4
#: the CPU tests' pins (tests/test_torch_mesh_executor.py): one quantize8
#: FedAT round within Q8_ATOL of the one-rank round, the trajectory's
#: accuracy within ACC_ATOL
SHARDED_ROUND_ATOL = 2e-3
SHARDED_ACC_ATOL = 0.1
#: phase 27: the multi-pod trainer at qwen2-7b widths, 2 ranks (one pod
#: each) sharing the card.  Depth 28 -> 2 layers: each rank holds fp32
#: params, AdamW m and v and the fp32 gradient accumulator (about 16 bytes
#: a parameter, 1.56 B parameters at 2 layers: 25 GB) plus a
#: microbatch's gradients and activations, and both ranks must fit the
#: card's 80 GB with 10% to spare; 3 layers (1.79 B) would not.  Global
#: batch 256 -> 8 x 4096 tokens, 4 a pod, microbatch 4 (one row each)
TRAIN_POD_LAYERS = 2
TRAIN_POD_BATCH = 8
TRAIN_POD_MICROBATCH = 4
TRAIN_POD_STEPS = 3

#: phase 28: 2 ranks, one row of 4096 tokens each, the same depth as
#: phase 27 so the one-rank replicated run fits beside it
FSDP_RANKS = 2
FSDP_LAYERS = 2
FSDP_STEPS = 2
#: read 0 and 0 (bitwise: the ranks' rows are the one-rank run's
#: microbatches through the same kernels, a sum of two commutes); room
#: for the clip's norm summed in another order
FSDP_LOSS_RTOL = 1e-6
FSDP_PARAM_ATOL = 1e-7


class _Collectives:
    """Counts (and host-times, around a synchronise) the collectives the
    port calls in this process, by patching torch.distributed."""

    NAMES = ("all_reduce", "broadcast", "all_gather",
             "all_gather_into_tensor", "reduce_scatter_tensor")

    def __init__(self, torch):
        import torch.distributed as dist
        self.torch, self.dist = torch, dist
        self.calls = {n: [] for n in self.NAMES}
        self._real = {n: getattr(dist, n) for n in self.NAMES}

    def __enter__(self):
        for n in self.NAMES:
            setattr(self.dist, n, self._wrap(n))
        return self

    def __exit__(self, *exc):
        for n, f in self._real.items():
            setattr(self.dist, n, f)

    def _wrap(self, name):
        real, torch = self._real[name], self.torch

        def call(t, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(t, *a, **k)
            torch.cuda.synchronize()
            self.calls[name].append((time.perf_counter() - t0,
                                     t.numel() * t.element_size(),
                                     k.get("group")))
            return out
        return call

    def counts(self):
        return {n: len(c) for n, c in self.calls.items()}


def run_mesh_d1(torch, api, kernels):
    """Phase 25: phase 4's small FedAT quantize8 scenario with
    ``mesh.kind=host`` in this process (one rank, no process group)
    against the no-mesh run: trajectory, final global and tier models
    bitwise, the same step keys and launch counts, no collective."""
    import torch.distributed as dist
    check(not dist.is_initialized(), "phase 25: a process group exists")
    out = {}
    for name, extra in (("no_mesh", {}), ("host", {"mesh.kind": "host"})):
        spec = api.ExperimentSpec().with_overrides(dict(SMALL, **extra))
        run = api.build(spec, device="cuda")
        ex = run.env.executor()
        rounds = []
        orig = ex.fedat_round
        ex.fedat_round = lambda *a, **k: rounds.append(1) or orig(*a, **k)
        kernels.reset_launch_counts()
        with _Collectives(torch) as coll:
            res = run.run()
        torch.cuda.synchronize()
        del ex.fedat_round
        m = res.metrics
        out[name] = {
            "rounds": len(rounds),
            "times": m.times, "acc": m.acc, "acc_var": m.acc_var,
            "w": flat(run.strategy.w_global),
            "tiers": flat(run.strategy.tier_models),
            "keys": sorted(map(str, run.env.executor().trace_counts)),
            "launches": kernels.launch_counts(),
            "collectives": coll.counts(),
            "mesh": (None if run.env.mesh is None
                     else dict(run.env.mesh.shape))}
    a, b = out["no_mesh"], out["host"]
    rounds = a["rounds"]
    check(b["mesh"] == {"data": 1, "model": 1},
          f"phase 25: host mesh {b['mesh']}")
    for k in ("rounds", "times", "acc", "acc_var", "keys", "launches"):
        check(a[k] == b[k], f"phase 25: {k} differ: {a[k]} vs {b[k]}")
    check(bits_equal(a["w"], b["w"]) and bits_equal(a["tiers"], b["tiers"]),
          "phase 25: the one-rank mesh run's models differ from the no-mesh "
          "run's")
    check(a["launches"]["roundtrip"] == 2 * rounds,
          f"phase 25: launches {a['launches']} for {rounds} rounds")
    check(not any(b["collectives"].values()),
          f"phase 25: collectives {b['collectives']}")
    info = {"rounds": rounds, "launches": b["launches"], "keys": b["keys"],
            "collectives": b["collectives"], "acc": b["acc"]}
    log(f"phase 25: FedAT quantize8 (phase 4's scenario) with mesh.kind=host "
        f"on one rank: mesh {b['mesh']}, trajectory, global and tier models "
        f"bitwise the no-mesh run's, keys {b['keys']}, launches "
        f"{b['launches']['roundtrip']} roundtrips ({rounds} rounds), "
        f"collectives {b['collectives']}")
    return info


def _rank_out(path_fmt: str, rank: int) -> Path:
    return Path(path_fmt.format(rank))


def rank_phase26(torch, out_fmt: str) -> None:
    """One rank of phase 26 (started by :func:`run_sharded_round`)."""
    import torch.distributed as dist
    from repro_torch import api, kernels
    from repro_torch.compress import transport
    from repro_torch.core import aggregation
    from repro_torch.launch import mesh as mesh_mod
    dev = mesh_mod.init_from_env(torch.device("cuda"))
    spec = api.ExperimentSpec().with_overrides(dict(
        FULL, **{"engine.total_updates": SHARDED_UPDATES,
                 "mesh.kind": "host"}))
    run = api.build(spec, device=dev)
    env = run.env
    ex = env.executor()
    out = {"rank": mesh_mod.rank(), "world": mesh_mod.world_size(),
           "backend": dist.get_backend(), "data_axis": env.data_axis,
           "device": str(dev)}
    # one round from params0, as the CPU test's (ids 0..K-1, seed 7)
    M = env.tm.n_tiers
    w, t = ({k: v.clone() for k, v in env.params0.items()},
            {k: torch.stack([v] * M) for k, v in env.params0.items()})
    ids = np.arange(env.sc.clients_per_round, dtype=np.int32)
    w1, _ = ex.fedat_round(w, t, 0, ids, 7,
                           codec=transport.get_codec("quantize8"),
                           use_prox=True,
                           cross_weights=aggregation.uniform_weights_host(M))
    np.save(_rank_out(out_fmt, out["rank"]).with_suffix(".round.npy"),
            flat(w1).numpy())
    # the run, counts from 0
    round_s = []
    orig = ex.fedat_round

    def timed_round(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = orig(*a, **k)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        return res

    ex.fedat_round = timed_round
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with _Collectives(torch) as coll:
        t0 = time.perf_counter()
        res = run.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    m = res.metrics
    np.save(_rank_out(out_fmt, out["rank"]).with_suffix(".w.npy"),
            flat(run.strategy.global_params()).numpy())
    np.save(_rank_out(out_fmt, out["rank"]).with_suffix(".t.npy"),
            flat(run.strategy.tier_models).numpy())
    ar = coll.calls["all_reduce"]
    out.update({
        "launches": kernels.launch_counts(), "rounds": len(round_s),
        "round_s": round_s, "wall_s": wall,
        "events_per_s": len(round_s) / wall, "times": m.times,
        "acc": m.acc, "collectives": coll.counts(),
        "all_reduce_s": [c[0] for c in ar],
        "all_reduce_bytes": [c[1] for c in ar],
        "keys": sorted(map(str, ex.trace_counts)),
        "peak_mem_bytes": torch.cuda.max_memory_allocated()})
    _rank_out(out_fmt, out["rank"]).write_text(json.dumps(out))
    mesh_mod.shutdown()


def run_sharded_round(torch, api, phase3_events_per_s: float):
    """Phase 26: FedAT quantize8 at phase 3's width with ``mesh.kind=host``
    on 2 ranks sharing the card over gloo (5 of the round's 10 clients a
    rank), against the one-rank run in this process."""
    import shutil
    from repro_torch.compress import transport
    from repro_torch.core import aggregation
    from repro_torch.launch import mesh as mesh_mod
    work = ROOT / "build" / "chip_smoke_ranks"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    fmt = str(work / "p26_rank{}.json")
    t0 = time.perf_counter()
    res = mesh_mod.run_ranks([str(ROOT / "chip_smoke.py"), "--rank-phase",
                              "26", "--rank-out", fmt], SHARDED_RANKS,
                             timeout=600, store_dir=str(work))
    ranks_s = time.perf_counter() - t0
    for r, (rc, so, se) in enumerate(res):
        check(rc == 0, f"phase 26: rank {r} exited {rc}: {se[-3000:]}")
    ranks = [json.loads(_rank_out(fmt, r).read_text())
             for r in range(SHARDED_RANKS)]
    # the one-rank run: the same spec without the mesh, on the card
    spec = api.ExperimentSpec().with_overrides(dict(
        FULL, **{"engine.total_updates": SHARDED_UPDATES}))
    run = api.build(spec, device="cuda")
    env = run.env
    M = env.tm.n_tiers
    w1, _ = env.executor().fedat_round(
        {k: v.clone() for k, v in env.params0.items()},
        {k: torch.stack([v] * M) for k, v in env.params0.items()}, 0,
        np.arange(env.sc.clients_per_round, dtype=np.int32), 7,
        codec=transport.get_codec("quantize8"), use_prox=True,
        cross_weights=aggregation.uniform_weights_host(M))
    w1 = flat(w1).numpy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = run.run().metrics
    torch.cuda.synchronize()
    one_eps = len(one.times) and SHARDED_UPDATES / (time.perf_counter() - t0)
    w_one = flat(run.strategy.global_params()).numpy()
    t_one = flat(run.strategy.tier_models).numpy()
    rounds = ranks[0]["rounds"]
    round_diff, w, tiers = [], [], []
    for r, info in enumerate(ranks):
        check(info["world"] == SHARDED_RANKS and info["data_axis"] == 2
              and info["backend"] == "gloo",
              f"phase 26: rank {r}: world {info['world']}, data axis "
              f"{info['data_axis']}, backend {info['backend']}")
        want = {k: 0 for k in info["launches"]}
        want["roundtrip"] = 2 * info["rounds"]
        check(info["launches"] == want,
              f"phase 26: rank {r} launches {info['launches']}, expected "
              f"{want} (one roundtrip a link a round)")
        check(info["collectives"]["all_reduce"] == info["rounds"]
              and not info["collectives"]["broadcast"],
              f"phase 26: rank {r} collectives {info['collectives']}")
        check(info["times"] == one.times,
              f"phase 26: rank {r} event times {info['times']} vs the "
              f"one-rank run's {one.times}")
        check(all(abs(a - b) <= SHARDED_ACC_ATOL
                  for a, b in zip(info["acc"], one.acc)),
              f"phase 26: accuracy {info['acc']} vs {one.acc}")
        check(all("data2" in k for k in info["keys"]),
              f"phase 26: keys {info['keys']}")
        rd = np.load(_rank_out(fmt, r).with_suffix(".round.npy"))
        round_diff.append(float(np.abs(rd - w1).max()))
        w.append(np.load(_rank_out(fmt, r).with_suffix(".w.npy")))
        tiers.append(np.load(_rank_out(fmt, r).with_suffix(".t.npy")))
    check(max(round_diff) <= SHARDED_ROUND_ATOL,
          f"phase 26: one sharded round differs from the one-rank round by "
          f"{round_diff} (bound {SHARDED_ROUND_ATOL})")
    check(ranks[0]["times"] == ranks[1]["times"]
          and np.array_equal(w[0], w[1]) and np.array_equal(tiers[0],
                                                            tiers[1]),
          "phase 26: the ranks disagree on the times or the models")
    # Eq. 3 weighs a tier by the update count of its mirror tier (M-1-m),
    # so while only tier 0 has committed the global model is tier 4's
    # untrained slot, params0, bit for bit, on both runs: every round of
    # this run starts from params0, and the tier models (tier 0's slot the
    # last round's output, the others params0) differ from the one-rank
    # run's by one round's difference, which the one-round pin bounds
    p0 = flat(env.params0).numpy()
    check(np.array_equal(w_one, p0) and np.array_equal(w[0], p0),
          "phase 26: the global model left params0, so the rounds did not "
          "all start from it and the one-round bound on the tier models "
          "does not apply")
    tier_diff = float(np.abs(tiers[0] - t_one).max())
    check(tier_diff <= SHARDED_ROUND_ATOL,
          f"phase 26: the sharded run's tier models differ from the "
          f"one-rank run's by {tier_diff} (bound {SHARDED_ROUND_ATOL})")
    rel = float(np.linalg.norm(w[0] - w_one) / np.linalg.norm(w_one))
    rel_t = float(np.linalg.norm(tiers[0] - t_one) / np.linalg.norm(t_one))
    ar = [s for info in ranks for s in info["all_reduce_s"]]
    info = {"ranks": ranks, "ranks_wall_s": ranks_s, "rounds": rounds,
            "round_maxdiff": round_diff, "tiers_maxdiff": tier_diff,
            "w_rel_l2_vs_one_rank": rel,
            "tiers_rel_l2_vs_one_rank": rel_t, "one_rank_acc": one.acc,
            "one_rank_events_per_s": one_eps,
            "events_per_s": [r["events_per_s"] for r in ranks],
            "phase3_events_per_s": phase3_events_per_s,
            "all_reduce_ms_median": 1e3 * float(np.median(ar)),
            "all_reduce_bytes": ranks[0]["all_reduce_bytes"][0]}
    log(f"phase 26: FedAT quantize8 full width on {SHARDED_RANKS} ranks "
        f"sharing the card (gloo, 5 clients a rank): {rounds} rounds a rank, "
        f"{[r['launches']['roundtrip'] for r in ranks]} roundtrip launches "
        f"(one a link a round), {info['events_per_s']} events/s (the "
        f"one-rank run here {one_eps:.4f}, phase 3 "
        f"{phase3_events_per_s:.4f}); event times bitwise the one-rank "
        f"run's; one round within {max(round_diff):.3g} of the one-rank "
        f"round; tier models within {tier_diff:.3g} of the one-rank run's "
        f"(bound {SHARDED_ROUND_ATOL}); rel L2 from the one-rank run: tier "
        f"models {rel_t:.3g}, "
        f"global model {rel:.3g} (acc {ranks[0]['acc']} vs {one.acc}); "
        f"all_reduce of "
        f"{info['all_reduce_bytes']} B: {info['all_reduce_ms_median']:.3f} "
        f"ms median, host-clocked around a synchronise (gloo copies through "
        f"the host: no multi-card figure); peak "
        f"{[r['peak_mem_bytes'] / 2**30 for r in ranks]} GiB; the ranks ran "
        f"{ranks_s:.1f} s with their start")
    shutil.rmtree(work, ignore_errors=True)
    return info


def _checksum(torch, params) -> list:
    """Two sums of every leaf's bit patterns (plain and position-weighted),
    chunked on the card: equal trees give equal sums, and two trees that
    differ anywhere almost surely do not."""
    total = [0, 0]
    for k in sorted(params):
        v = params[k]
        if isinstance(v, dict):
            sub = _checksum(torch, v)
            total = [total[0] + sub[0], total[1] + sub[1]]
            continue
        for chunk in v.reshape(-1).split(1 << 24):
            bits = chunk.view(torch.int32).to(torch.int64)
            pos = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
            total[0] += int(bits.sum())
            total[1] += int((bits * pos).sum())
    return total


def rank_phase27(torch, out_fmt: str) -> None:
    """One rank of phase 27 (started by :func:`run_multipod`)."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.configs.base import TrainConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.core import steps as steps_mod
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train
    cfg = get_config("qwen2-7b").replace(n_layers=TRAIN_POD_LAYERS,
                                         microbatch=TRAIN_POD_MICROBATCH)
    shape = ShapeConfig("train_4k", 4096, TRAIN_POD_BATCH, "train")
    steps = []
    make = steps_mod.make_fedat_step

    def recorded(*a, **k):
        fns = make(*a, **k)

        def step(state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = fns.train_step(state, batch)
            torch.cuda.synchronize()
            steps.append({"step_s": time.perf_counter() - t0,
                          "loss": float(m["loss"]),
                          "payload_bytes": float(m["payload_bytes"]),
                          "checksum": _checksum(torch, state["params"])})
            return state, m
        return dataclasses.replace(fns, train_step=step)

    steps_mod.make_fedat_step = recorded
    ck = ROOT / "build" / "chip_smoke_multipod"
    argv = ["--arch", "qwen2-7b", "--multi-pod", "--codec", "quantize8",
            "--fedat-sync-every", "2", "--ckpt-every", "0", "--steps",
            str(TRAIN_POD_STEPS), "--seed", "0", "--device", "cuda",
            "--ckpt-dir", str(ck)]
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = train.run(train.parser().parse_args(argv), cfg=cfg, shape=shape)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps_mod.make_fedat_step = make
    params = res.state["params"]
    n = sum(x.numel() for x in _leaves(params))
    rows = sum(x.numel() // x.shape[-1] for x in _leaves(params))
    # one more step that syncs at 4 bits, on the trained state
    dev = params["embed"].device
    fns4 = make(cfg, TrainConfig(fedat_enabled=True, fedat_sync_every=1,
                                 fedat_compress_bits=4, total_steps=4),
                mesh_mod.make_host_mesh(n_pods=2), device=dev)
    batch = steps_mod.split_batch_for_pods(
        TokenPipeline(cfg, shape, seed=0).batch(TRAIN_POD_STEPS), 2)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, m4 = fns4.train_step(res.state, batch)
    torch.cuda.synchronize()
    out = {"rank": mesh_mod.rank(), "backend": dist.get_backend(),
           "pod": mesh_mod.make_host_mesh(n_pods=2).coord("pod"),
           "launches": counts, "steps": steps, "wall_s": wall,
           "losses": res.losses, "peak_mem_bytes": peak,
           "peak_mem_all_bytes": torch.cuda.max_memory_allocated(),
           "n_params": n, "rows": rows,
           "int4_payload_bytes": float(m4["payload_bytes"]),
           "int4_step_s": time.perf_counter() - t1,
           "int4_checksum": _checksum(torch, state["params"]),
           "runner_stats": res.runner_stats}
    _rank_out(out_fmt, out["rank"]).write_text(json.dumps(out))
    mesh_mod.shutdown()


def run_multipod(torch, kernels):
    """Phase 27: ``launch/train.py --multi-pod --codec quantize8
    --fedat-sync-every 2 --ckpt-every 0`` at qwen2-7b widths cut to
    ``TRAIN_POD_LAYERS`` layers, 2 ranks (one pod each) sharing the card
    over gloo."""
    import shutil
    from repro_torch.launch import mesh as mesh_mod
    work = ROOT / "build" / "chip_smoke_ranks"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    fmt = str(work / "p27_rank{}.json")
    t0 = time.perf_counter()
    res = mesh_mod.run_ranks(
        [str(ROOT / "chip_smoke.py"), "--rank-phase", "27", "--rank-out",
         fmt], 2, timeout=900, store_dir=str(work),
        env={"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
    ranks_s = time.perf_counter() - t0
    for r, (rc, so, se) in enumerate(res):
        check(rc == 0, f"phase 27: rank {r} exited {rc}: {se[-3000:]}")
    ranks = sorted((json.loads(_rank_out(fmt, r).read_text())
                    for r in range(2)), key=lambda x: x["pod"])
    L, mb = TRAIN_POD_LAYERS, TRAIN_POD_MICROBATCH
    per_step = {"flash_attention": 2 * L * mb, "flash_attention_bwd": L * mb}
    want = {k: TRAIN_POD_STEPS * v for k, v in per_step.items()}
    for info in ranks:
        c = info["launches"]
        check(info["backend"] == "gloo", f"phase 27: {info['backend']}")
        check(all(c[k] == v for k, v in want.items())
              and all(n == 0 for k, n in c.items() if k not in want),
              f"phase 27: pod {info['pod']} launches {c}, expected {want}")
        check(len(info["steps"]) == TRAIN_POD_STEPS
              and all(math.isfinite(x) for x in info["losses"]),
              f"phase 27: losses {info['losses']}")
        check(info["runner_stats"]["failures"] == 0,
              f"phase 27: runner {info['runner_stats']}")
        n, rows = info["n_params"], info["rows"]
        sent = [s["payload_bytes"] for s in info["steps"]]
        check(sent == [0.0, n + 4 * rows, 0.0],
              f"phase 27: bytes sent a step {sent}, expected a sync of "
              f"{n} int8 codes + {rows} scales at step 2")
        check(info["int4_payload_bytes"] == n // 2 + 4 * rows,
              f"phase 27: int4 sync sent {info['int4_payload_bytes']}")
    a, b = ranks
    check(a["losses"] == b["losses"], "phase 27: the pods log other losses")
    cs = [(x["checksum"], y["checksum"]) for x, y in zip(a["steps"],
                                                         b["steps"])]
    check(cs[0][0] != cs[0][1], "phase 27: the pods equal after step 1")
    check(cs[1][0] == cs[1][1], "phase 27: the pods differ after step 2's "
          "sync")
    check(a["int4_checksum"] == b["int4_checksum"],
          "phase 27: the pods differ after the int4 sync")
    n = a["n_params"]
    info = {"ranks": ranks, "ranks_wall_s": ranks_s, "layers": L,
            "batch": TRAIN_POD_BATCH, "microbatch": mb,
            "launches_per_step": per_step,
            "sync_bytes_int8": n + 4 * a["rows"], "sync_bytes_fp32": 4 * n,
            "sync_bytes_int4": a["int4_payload_bytes"],
            "step_s": [[s["step_s"] for s in r["steps"]] for r in ranks],
            "peak_mem_bytes": [r["peak_mem_bytes"] for r in ranks]}
    log(f"phase 27: multi-pod FedAT trainer at qwen2-7b widths ({n} params: "
        f"{L} layers; 2 pods of 4 x 4096 tokens, microbatch {mb}, remat, "
        f"fp32 AdamW, quantize8 sync every 2) on 2 ranks sharing the card "
        f"(gloo): losses {a['losses']}; flash {per_step} a step on each rank; "
        f"the pods differ after step 1 and are bitwise equal after step 2's "
        f"sync; a sync sends {info['sync_bytes_int8']} B (int8 + row scales) "
        f"against {info['sync_bytes_fp32']} B in fp32, "
        f"{info['sync_bytes_int4']:.0f} B at 4 bits; step seconds "
        f"{info['step_s']} (step 2 syncs); int4 sync step "
        f"{[r['int4_step_s'] for r in ranks]} s; peak "
        f"{[r['peak_mem_bytes'] / 2**30 for r in ranks]} GiB a rank; the "
        f"ranks ran {ranks_s:.1f} s with their start")
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(ROOT / "build" / "chip_smoke_multipod", ignore_errors=True)
    return info


def _fsdp_cfg(microbatch: int):
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import ShapeConfig
    cfg = get_config("qwen2-7b").replace(n_layers=FSDP_LAYERS,
                                         microbatch=microbatch)
    return cfg, ShapeConfig("train_4k", 4096, FSDP_RANKS, "train")


def _fsdp_argv() -> list:
    return ["--arch", "qwen2-7b", "--ckpt-every", "0", "--steps",
            str(FSDP_STEPS), "--seed", "0", "--device", "cuda", "--ckpt-dir",
            str(ROOT / "build" / "chip_smoke_fsdp" / "ck")]


def rank_phase28(torch, out_fmt: str) -> None:
    """One rank of phase 28 (started by :func:`run_fsdp`)."""
    import dataclasses
    import torch.distributed as dist
    from repro_torch import kernels
    from repro_torch.core import steps as steps_mod
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train
    from repro_torch.models import common, lm
    from repro_torch.runtime import sharding as shd
    cfg, shape = _fsdp_cfg(1)
    steps, coll = [], _Collectives(torch)
    make = steps_mod.make_single_pod_step

    def recorded(cfg, tcfg, mesh, **k):
        fns = make(cfg, tcfg, mesh, **k)
        fsdp = shd.FSDP.over(mesh)      # the one the step gathers through

        def step(state, batch):
            fsdp.reset_stats()
            before = {n: list(c) for n, c in coll.calls.items()}
            launches = kernels.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = fns.train_step(state, batch)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            new = {n: c[len(before[n]):] for n, c in coll.calls.items()}
            now = kernels.launch_counts()
            steps.append({
                "step_s": dt, "loss": float(m["loss"]),
                "grad_norm": float(m["grad_norm"]),
                "fsdp": dict(fsdp.stats),
                "peak_live_bytes": fsdp.peak_live_bytes,
                "collectives": {n: len(c) for n, c in new.items()},
                "collective_s": sum(x[0] for c in new.values() for x in c),
                "launches": {n: now[n] - launches.get(n, 0) for n in now}})
            return state, m
        return dataclasses.replace(fns, train_step=step)

    steps_mod.make_single_pod_step = recorded
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with coll:
        res = train.run(train.parser().parse_args(_fsdp_argv()),
                        cfg=cfg, shape=shape)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps_mod.make_single_pod_step = make
    mesh = mesh_mod.make_host_mesh()
    state = res.state
    nbytes = lambda t: sum(x.numel() * x.element_size()  # noqa
                           for x in _leaves(t))
    held = (nbytes(state["params"]) + nbytes(state["opt"]["m"])
            + nbytes(state["opt"]["v"]))
    want = sum(3 * shd.device_bytes(spec.shape, 4, shd.logical_sharding(
        spec.axes, mesh), mesh) for _, spec in common.iter_specs(
            lm.param_specs(cfg, 1)))
    whole = sum(3 * 4 * math.prod(spec.shape) for _, spec in
                common.iter_specs(lm.param_specs(cfg, 1)))
    split = {k: shd.split_dim(v) for k, v in common.flatten_tree(
        res.layouts["params"]).items()}
    rank = mesh_mod.rank()
    torch.save({k: v.detach().cpu() for k, v in common.flatten_tree(
        state["params"]).items()},
        str(_rank_out(out_fmt, rank).with_suffix(".pt")))
    out = {"rank": rank, "index": mesh.coord("data"),
           "backend": dist.get_backend(), "launches": kernels.launch_counts(),
           "steps": steps, "losses": res.losses, "wall_s": wall,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "state_bytes": held, "state_bytes_dryrun": want,
           "state_bytes_whole": whole, "split": split,
           "runner_stats": res.runner_stats}
    _rank_out(out_fmt, rank).write_text(json.dumps(out))
    mesh_mod.shutdown()


def run_fsdp(torch, kernels):
    """Phase 28: ``launch/train.py`` at qwen2-7b widths cut to
    ``FSDP_LAYERS`` layers on 2 ranks sharing the card, the state sharded
    over ``data``, against the same global batch on one rank,
    replicated."""
    import shutil
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import train
    from repro_torch.models import common
    work = ROOT / "build" / "chip_smoke_fsdp"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    fmt = str(work / "p28_rank{}.json")
    t0 = time.perf_counter()
    res = mesh_mod.run_ranks(
        [str(ROOT / "chip_smoke.py"), "--rank-phase", "28", "--rank-out",
         fmt], FSDP_RANKS, timeout=600, store_dir=str(work),
        env={"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"})
    ranks_s = time.perf_counter() - t0
    for r, (rc, so, se) in enumerate(res):
        check(rc == 0, f"phase 28: rank {r} exited {rc}: {se[-3000:]}")
    ranks = sorted((json.loads(_rank_out(fmt, r).read_text())
                    for r in range(FSDP_RANKS)), key=lambda x: x["index"])
    L, D = FSDP_LAYERS, FSDP_RANKS
    n_whole = sum(v is None for v in ranks[0]["split"].values())
    # a step at microbatch 1: gathers the embedding, each layer (forward
    # and its recompute) and the head; a reduce-scatter a gathered group
    per_step = {
        "launches": {"flash_attention": 2 * L, "flash_attention_bwd": L},
        "gathers": 2 * L + 2, "reduce_scatters": L + 2,
        "broadcast": D * (2 * L + 2),
        # reduce-scatters, the whole leaves, the metrics, the norm
        "all_reduce": (L + 2) + n_whole + 1 + 1}
    for info in ranks:
        tag = f"phase 28: rank {info['rank']}"
        check(info["backend"] == "gloo", f"{tag}: {info['backend']}")
        check(info["runner_stats"]["failures"] == 0,
              f"{tag}: runner {info['runner_stats']}")
        check(len(info["steps"]) == FSDP_STEPS
              and all(math.isfinite(x) for x in info["losses"]),
              f"{tag}: losses {info['losses']}")
        check(info["state_bytes"] == info["state_bytes_dryrun"],
              f"{tag}: holds {info['state_bytes']} B of params and moments, "
              f"the dry-run counts {info['state_bytes_dryrun']}")
        for i, st in enumerate(info["steps"]):
            c, f = st["launches"], st["fsdp"]
            check(all(c[k] == v for k, v in per_step["launches"].items())
                  and all(n == 0 for k, n in c.items()
                          if k not in per_step["launches"]),
                  f"{tag} step {i + 1}: launches {c}, expected "
                  f"{per_step['launches']}")
            check(f["gathers"] == per_step["gathers"]
                  and f["reduce_scatters"] == per_step["reduce_scatters"],
                  f"{tag} step {i + 1}: FSDP {f}, expected "
                  f"{per_step['gathers']} gathers and "
                  f"{per_step['reduce_scatters']} reduce-scatters")
            co = st["collectives"]
            check(co["broadcast"] == per_step["broadcast"]
                  and co["all_reduce"] == per_step["all_reduce"]
                  and not co["all_gather"],
                  f"{tag} step {i + 1}: collectives {co}, expected "
                  f"{per_step['broadcast']} broadcasts and "
                  f"{per_step['all_reduce']} all_reduces")
    a, b = ranks
    check(a["losses"] == b["losses"], "phase 28: the ranks log other losses")
    # the one-rank run: the same global batch, 2 rows, microbatch 2
    cfg, shape = _fsdp_cfg(FSDP_RANKS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t1 = time.perf_counter()
    one = train.run(train.parser().parse_args(_fsdp_argv()), cfg=cfg,
                    shape=shape)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t1
    one_peak = torch.cuda.max_memory_allocated()
    one_losses, one_step_s = one.losses, one.step_seconds
    one_launches = kernels.launch_counts()
    want_one = {"flash_attention": FSDP_STEPS * 2 * L * D,
                "flash_attention_bwd": FSDP_STEPS * L * D}
    check(all(one_launches[k] == v for k, v in want_one.items()),
          f"phase 28: the one-rank run launched {one_launches}, expected "
          f"{want_one}")
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                       one_losses))
    norms = [s["grad_norm"] for s in a["steps"]]
    one_norms = [m["grad_norm"] for m in one.metrics]
    norm_rel = max(abs(x - y) / abs(y) for x, y in zip(norms, one_norms))
    # the ranks' final shards against the blocks of the one-rank params
    param_diff = 0.0
    flat = common.flatten_tree(one.state["params"])
    for info in ranks:
        shards = torch.load(str(_rank_out(fmt, info["rank"]).with_suffix(
            ".pt")), mmap=True)
        for name, shard in shards.items():
            dim = info["split"][name]
            want = flat[name]
            if dim is not None:
                n = shard.shape[dim]
                want = want.narrow(dim, info["index"] * n, n)
            param_diff = max(param_diff, float(
                (shard.to(want.device) - want).abs().max()))
        del shards
    del one, flat
    torch.cuda.empty_cache()
    check(loss_rel <= FSDP_LOSS_RTOL and norm_rel <= FSDP_LOSS_RTOL,
          f"phase 28: losses {a['losses']}, grad norms {norms} vs the "
          f"one-rank run's {one_losses}, {one_norms} (rel {loss_rel:.3g}, "
          f"{norm_rel:.3g} > {FSDP_LOSS_RTOL})")
    check(param_diff <= FSDP_PARAM_ATOL,
          f"phase 28: final params {param_diff:.3g} from the one-rank run's "
          f"(bound {FSDP_PARAM_ATOL})")
    peaks = [r["peak_mem_bytes"] for r in ranks]
    check(max(peaks) < one_peak,
          f"phase 28: a rank peaked at {max(peaks)} B, the one-rank "
          f"replicated run at {one_peak} B")
    info = {"ranks": ranks, "ranks_wall_s": ranks_s, "layers": L,
            "per_step": per_step, "loss_rel_vs_one_rank": loss_rel,
            "grad_norm_rel_vs_one_rank": norm_rel, "grad_norms": norms,
            "param_maxdiff_vs_one_rank": param_diff,
            "state_bytes": [r["state_bytes"] for r in ranks],
            "state_bytes_whole": a["state_bytes_whole"],
            "peak_mem_bytes": peaks, "one_rank_peak_mem_bytes": one_peak,
            "one_rank_losses": one_losses, "one_rank_s": one_s,
            "one_rank_step_s": one_step_s,
            "step_s": [[s["step_s"] for s in r["steps"]] for r in ranks],
            "collective_s": [[s["collective_s"] for s in r["steps"]]
                             for r in ranks],
            "gather_bytes": a["steps"][-1]["fsdp"]["gather_bytes"],
            "reduce_scatter_bytes":
                a["steps"][-1]["fsdp"]["reduce_scatter_bytes"],
            "peak_live_bytes": [s["peak_live_bytes"] for s in a["steps"]]}
    log(f"phase 28: the trainer sharded over data (FSDP) at qwen2-7b widths "
        f"({L} layers; 2 x 4096 tokens, one row a rank, remat, fp32 AdamW) "
        f"on {D} ranks sharing the card (gloo): losses {a['losses']} on both "
        f"ranks, {loss_rel:.3g} relative from the one-rank replicated run's "
        f"{one_losses} (2 rows, microbatch 2; steps {one_step_s} s), grad "
        f"norms {norms} ({norm_rel:.3g}); final params within "
        f"{param_diff:.3g}; flash {per_step['launches']}, "
        f"{per_step['gathers']} gathers and {per_step['reduce_scatters']} "
        f"reduce-scatters a step ({per_step['broadcast']} broadcasts, "
        f"{per_step['all_reduce']} all_reduces); params + m + v "
        f"{info['state_bytes']} B a rank (the dry-run's arithmetic; "
        f"{info['state_bytes_whole']} B whole); peak "
        f"{[p / 2**30 for p in peaks]} GiB a rank against "
        f"{one_peak / 2**30:.2f} GiB replicated; live gathered peak "
        f"{[x / 2**30 for x in info['peak_live_bytes']]} GiB; step seconds "
        f"{info['step_s']}, of it in collectives {info['collective_s']} "
        f"(host-clocked around a synchronise; gathered "
        f"{info['gather_bytes']} B and reduce-scattered "
        f"{info['reduce_scatter_bytes']} B a step); the one-rank run "
        f"{one_s:.1f} s with its set-up; the ranks ran {ranks_s:.1f} s with "
        f"their start")
    shutil.rmtree(work, ignore_errors=True)
    return info


# ---------------------------------------------------------------------------
# phase 29: tier stacks laid over pod (shard_tiers)
# ---------------------------------------------------------------------------

#: run 1: phase 3's FedAT quantize8 with 4 tiers on (pod=2, data=2), 4
#: ranks sharing the card; run 2: phase 20's 2 x 2 silo tree on (pod=2,
#: data=1), 2 ranks.  4 updates each, as phase 26
SHARD_TIERS_RUNS = {
    4: dict(FULL, **{"tiers.n_tiers": 4, "mesh.n_pods": 2}),
    2: dict(TOPOLOGY, **{"mesh.n_pods": 2}),
}
SHARD_TIERS_UPDATES = 4


def _shard_tiers_spec(api, world: int, mesh: bool):
    over = dict(SHARD_TIERS_RUNS[world],
                **{"engine.total_updates": SHARD_TIERS_UPDATES})
    if not mesh:
        over.pop("mesh.n_pods")
    else:
        over.update({"mesh.kind": "host", "mesh.shard_tiers": True})
    return api.ExperimentSpec().with_overrides(over)


def rank_phase29(torch, out_fmt: str) -> None:
    """One rank of phase 29 (started by :func:`run_shard_tiers`): the run
    of ``SHARD_TIERS_RUNS[world]``, its round times, collectives and
    launches, the slots this rank holds and the whole stack gathered."""
    import torch.distributed as dist
    from repro_torch import api, kernels
    from repro_torch.launch import mesh as mesh_mod
    dev = mesh_mod.init_from_env(torch.device("cuda"))
    world = mesh_mod.world_size()
    run = api.build(_shard_tiers_spec(api, world, True), device=dev)
    env, ex = run.env, run.env.executor()
    topo = env.topology is not None
    name = "fedat_topology_round" if topo else "fedat_round"
    round_s = []
    orig = getattr(ex, name)

    def timed_round(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = orig(*a, **k)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        return res

    setattr(ex, name, timed_round)
    kernels.reset_launch_counts()
    with _Collectives(torch) as coll:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    s = run.strategy
    held = {k: v for k, v in s.tier_models.items()}
    whole = ex.whole_tiers(s.tier_models, len(s.counts))
    rank = mesh_mod.rank()
    np.save(_rank_out(out_fmt, rank).with_suffix(".w.npy"),
            flat(s.global_params()).numpy())
    np.save(_rank_out(out_fmt, rank).with_suffix(".t.npy"),
            flat(whole).numpy())
    pod = [c for c in coll.calls["all_reduce"] if c[2] is ex._pod_group]
    out = {"rank": rank, "world": world, "backend": dist.get_backend(),
           "mesh": dict(env.mesh.shape), "slots": list(s.slots),
           "held_rows": int(next(iter(held.values())).shape[0]),
           "stack_bytes": sum(v.numel() * v.element_size()
                              for v in held.values()),
           "whole_stack_bytes": sum(v.numel() * v.element_size()
                                    for v in whole.values()),
           "launches": kernels.launch_counts(), "rounds": len(round_s),
           "round_s": round_s, "wall_s": wall,
           "events_per_s": len(round_s) / wall, "times": res.metrics.times,
           "acc": res.metrics.acc, "collectives": {
               n: len(c) for n, c in coll.calls.items()},
           "pod_all_reduces": len(pod),
           "pod_all_reduce_s": [c[0] for c in pod],
           "pod_all_reduce_bytes": [c[1] for c in pod],
           "keys": sorted(map(str, ex.trace_counts))}
    _rank_out(out_fmt, rank).write_text(json.dumps(out))
    mesh_mod.shutdown()


def run_shard_tiers(torch, api):
    """Phase 29: the tier stack laid over ``pod`` on ranks sharing the
    card over gloo, each run against the one-rank run in this process:
    every rank holds only its pod's slots (4 tiers over 2 pods: 2 each;
    2 silos over 2 pods: 1 each), event times bitwise, the whole tier
    (silo) stack and the global model within phase 26's pin."""
    import shutil
    from repro_torch.launch import mesh as mesh_mod
    work = ROOT / "build" / "chip_smoke_ranks"
    out = {}
    for world in SHARD_TIERS_RUNS:
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        fmt = str(work / "p29_rank{}.json")
        t0 = time.perf_counter()
        res = mesh_mod.run_ranks([str(ROOT / "chip_smoke.py"),
                                  "--rank-phase", "29", "--rank-out", fmt],
                                 world, timeout=600, store_dir=str(work))
        ranks_s = time.perf_counter() - t0
        for r, (rc, so, se) in enumerate(res):
            check(rc == 0, f"phase 29: rank {r} of {world} exited {rc}: "
                           f"{se[-3000:]}")
        ranks = [json.loads(_rank_out(fmt, r).read_text())
                 for r in range(world)]
        w = [np.load(_rank_out(fmt, r).with_suffix(".w.npy"))
             for r in range(world)]
        tiers = [np.load(_rank_out(fmt, r).with_suffix(".t.npy"))
                 for r in range(world)]
        run = api.build(_shard_tiers_spec(api, world, False), device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one = run.run().metrics
        torch.cuda.synchronize()
        one_eps = SHARD_TIERS_UPDATES / (time.perf_counter() - t0)
        w_one = flat(run.strategy.global_params()).numpy()
        t_one = flat(run.strategy.tier_models).numpy()
        M = len(run.strategy.counts)
        topo = run.env.topology is not None
        pods, data = 2, world // 2
        per = M // pods
        for r, info in enumerate(ranks):
            p = r // data
            check(info["mesh"] == {"pod": pods, "data": data, "model": 1}
                  and info["backend"] == "gloo",
                  f"phase 29: rank {r}: mesh {info['mesh']}, backend "
                  f"{info['backend']}")
            check(info["slots"] == list(range(p * per, (p + 1) * per))
                  and info["held_rows"] == per
                  and info["stack_bytes"] * pods
                  == info["whole_stack_bytes"],
                  f"phase 29: rank {r} holds slots {info['slots']} "
                  f"({info['held_rows']} rows, {info['stack_bytes']} of "
                  f"{info['whole_stack_bytes']} B); pod {p} owns "
                  f"{list(range(p * per, (p + 1) * per))}")
            check(info["times"] == one.times,
                  f"phase 29: rank {r} event times {info['times']} vs the "
                  f"one-rank run's {one.times}")
            rounds = info["rounds"]
            want = {k: 0 for k in info["launches"]}
            want["roundtrip"] = (TOPOLOGY_LAUNCHES if topo else 2) * rounds
            check(info["launches"] == want,
                  f"phase 29: rank {r} launches {info['launches']}, "
                  f"expected {want}")
            # a round: Eq. 4's all_reduce over data (when D > 1) and Eq. 3's
            # over pod; the gather of the stack at the end is broadcasts
            check(info["pod_all_reduces"] == rounds
                  and info["collectives"]["all_reduce"]
                  == rounds * (1 + (data > 1)),
                  f"phase 29: rank {r} collectives {info['collectives']}, "
                  f"{info['pod_all_reduces']} over pod for {rounds} rounds")
        check(all(np.array_equal(w[0], x) for x in w)
              and all(np.array_equal(tiers[0], x) for x in tiers),
              f"phase 29 ({world} ranks): the ranks disagree on the models")
        w_diff = float(np.abs(w[0] - w_one).max())
        t_diff = float(np.abs(tiers[0] - t_one).max())
        check(w_diff <= SHARDED_ROUND_ATOL and t_diff <= SHARDED_ROUND_ATOL,
              f"phase 29 ({world} ranks): global model {w_diff}, tier "
              f"stack {t_diff} from the one-rank run's (bound "
              f"{SHARDED_ROUND_ATOL})")
        pod_s = [s for info in ranks for s in info["pod_all_reduce_s"]]
        key = "topology" if topo else "fedat"
        out[key] = {
            "ranks": ranks, "ranks_wall_s": ranks_s, "world": world,
            "events_per_s": [r["events_per_s"] for r in ranks],
            "one_rank_events_per_s": one_eps,
            "pod_all_reduce_ms_median": 1e3 * float(np.median(pod_s)),
            "pod_all_reduce_bytes": ranks[0]["pod_all_reduce_bytes"][0],
            "stack_bytes_per_rank": ranks[0]["stack_bytes"],
            "whole_stack_bytes": ranks[0]["whole_stack_bytes"],
            "global_maxdiff": w_diff, "tiers_maxdiff": t_diff,
            "bitwise": bool(w_diff == 0.0 and t_diff == 0.0)}
        o = out[key]
        log(f"phase 29: {'the 2 x 2 silo tree' if topo else 'FedAT quantize8 with 4 tiers'} "
            f"on (pod={pods}, data={data}) with shard_tiers, {world} ranks "
            f"sharing the card (gloo): slots "
            f"{[r['slots'] for r in ranks]}, {o['stack_bytes_per_rank']} B "
            f"of the {o['whole_stack_bytes']} B stack a rank; "
            f"{ranks[0]['rounds']} rounds, event times bitwise the one-rank "
            f"run's; global model within {w_diff:.3g} and the stack within "
            f"{t_diff:.3g} of the one-rank run's (bound "
            f"{SHARDED_ROUND_ATOL}; bitwise: {o['bitwise']}); "
            f"{o['events_per_s']} events/s a rank (one rank here "
            f"{one_eps:.4f}); the pod all_reduce of "
            f"{o['pod_all_reduce_bytes']} B: "
            f"{o['pod_all_reduce_ms_median']:.3f} ms median, host-clocked "
            f"around a synchronise; the ranks ran {ranks_s:.1f} s with "
            f"their start")
        shutil.rmtree(work, ignore_errors=True)
        del run
        api.clear_env_cache()
        gc.collect()
        torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every number as JSON here")
    ap.add_argument("--rank-phase", choices=["26", "27", "28", "29"],
                    help=argparse.SUPPRESS)  # one rank of phase 26-29
    ap.add_argument("--rank-out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available; this script needs an NVIDIA card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"the port's sources (src/repro_torch) are not beside "
             f"{Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    if args.rank_phase:
        {"26": rank_phase26, "27": rank_phase27, "28": rank_phase28,
         "29": rank_phase29}[args.rank_phase](torch, args.rank_out)
        return
    from repro_torch import api, kernels, serve
    from repro_torch.api import cli
    from repro_torch.core.simulation import SimEnv
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import polyline_codec as pc, ref
    from repro_torch.kernels import rwkv6_scan, ssd as ssd_scan
    from repro_torch.launch import serve as serve_launch
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import convert, lm
    from repro_torch.models import moe as moe_mod
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
            if "Compiling entry function" in line:
                log(f"  ptxas {name}: {line.split(chr(39))[1]}")
            elif "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    from repro_torch.models.registry import DataDims, build_model
    model = build_model("cnn", DataDims(n_classes=10, image_hw=32))
    shapes = {k: tuple(v.shape) for k, v in
              model.init_params(torch.Generator().manual_seed(0)).items()}
    K = FULL["tiers.clients_per_round"]

    # phase 2
    errs = compare_kernels(torch, pc, ref, dev, shapes, K)
    times = time_kernels(torch, pc, ref, dev, shapes, K)
    rt_check = compare_roundtrip(torch, pc, ref, dev, shapes, K)
    rt_times = time_roundtrip(torch, pc, ref, dev, shapes, K)

    # phase 3: the FedAT path, counts from 0 (the profile runs after)
    main_path, run = run_main_path(torch, api, kernels, dev)
    main_path["profile"] = profile_round(
        torch, run, kernels, float(np.median(main_path["ms_per_round_each"])))
    del run
    # phase 4
    agree = card_vs_cpu(torch, api, SimEnv, dev)
    # phase 5
    base = baselines(torch, api, kernels, dev)
    torch.cuda.empty_cache()

    # phase 6
    flash = check_flash(torch, fa, ref, built["flash_attention"]["path"])
    # phase 7: the serving path, counts from 0 (the profile runs after)
    serving, engine = run_serving(torch, kernels, serve_launch)
    serving["profile"] = profile_serving(torch, engine, serving)
    del engine
    torch.cuda.empty_cache()
    # phase 7, bf16: the tensor-core design on the model path, counts from 0
    serving["bf16_wave"] = run_bf16_wave(torch, kernels, serve_launch, lm)
    # phase 8
    serve_agree = serving_card_vs_cpu(torch, kernels, lm, convert, serve)

    # phase 9
    wkv = check_wkv6(torch, kops, rwkv6_scan, ref, built["wkv6"]["path"])
    ssd = check_ssd(torch, kops, ssd_scan, ref, built["ssd"]["path"])
    # phases 10-11: the recurrent families, counts from 0 per run
    recurrent = {}
    for tag, arch in (("10", "rwkv6-3b"), ("11", "zamba2-2.7b")):
        recurrent[arch] = run_recurrent(torch, kernels, serve_launch, lm,
                                        arch, tag)
    # phase 12
    recurrent_agree = recurrent_card_vs_cpu(torch, kernels, lm, convert,
                                            serve, serve_launch)

    # phase 13
    flash_bwd = check_flash_bwd(torch, fa, ref,
                                built["flash_attention_bwd"]["path"],
                                str(built["flash_attention_bwd"]["log"]))
    torch.cuda.empty_cache()
    # phase 14: the federated LM, counts from 0
    fedlm = run_federated_lm(torch, api, kernels)
    # phase 15
    fedlm_agree = federated_lm_card_vs_cpu(torch, api, SimEnv)
    torch.cuda.empty_cache()
    # phase 16: the trainer, counts from 0 per run
    trainer = run_trainer(torch, kernels)
    torch.cuda.empty_cache()
    # phase 17: FedAT under faults, killed and resumed, counts from 0
    faults = run_faults(torch, api, kernels, SimEnv, dev,
                        main_path["events_per_s"])
    # phase 18: the federated LM's checkpoint served, counts from 0
    fedlm_ckpt = run_fedlm_checkpoint(torch, api, cli, serve, kernels)
    torch.cuda.empty_cache()
    # phase 19: the population plane at 1M clients, counts from 0
    population = run_population(torch, api, kernels, SimEnv, dev)
    torch.cuda.empty_cache()
    # phase 20: the topology plane at full width, counts from 0
    topology = run_topology(torch, api, kernels, SimEnv, dev)
    torch.cuda.empty_cache()
    # phase 21: moe serving at published widths, counts from 0 per run
    moe_serving = {}
    for arch, layers in (("granite-moe-3b-a800m", None),
                         ("deepseek-moe-16b", DEEPSEEK_LAYERS)):
        moe_serving[arch], engine = run_moe_serving(
            torch, kernels, serve_launch, lm, moe_mod, attn_mod, arch,
            layers)
        if layers is None:
            moe_serving[arch]["wave_split"] = split = moe_wave_split(
                torch, lm, moe_mod, attn_mod, engine,
                moe_serving[arch]["decode_step_s_median"])
            log(f"phase 21: {arch} warm wave {split['wave_s']:.4f} s; with "
                f"each call synchronised: MoE FFNs "
                f"{100 * split['moe_ffn_share']:.1f}%, attention "
                f"{100 * split['prefill_attention_share']:.1f}% of "
                f"{split['synced_wave_s']:.4f} s")
        del engine
    moe_agree = moe_card_vs_cpu(torch, kernels, lm, convert, serve, moe_mod)
    torch.cuda.empty_cache()
    # phase 22: vlm serving at published widths, counts from 0
    vlm_serving = run_vlm_serving(torch, kernels, lm)
    vlm_agree = vlm_card_vs_cpu(torch, kernels, lm, convert)
    torch.cuda.empty_cache()
    # phase 23: the three families trained, counts from 0 per arch
    family_train = run_family_training(torch, kernels)
    family_agree = family_training_card_vs_cpu(torch, kernels, lm, convert)
    hubert_attn = time_hubert_attention(torch, fa, ref)
    torch.cuda.empty_cache()
    # phase 24: the recurrent families trained, counts from 0 per arch
    t24 = time.perf_counter()
    recurrent_train = run_recurrent_training(torch, kernels)
    recurrent_train_agree = recurrent_training_card_vs_cpu(
        torch, kernels, lm, convert)
    scan_bwd = {kind: check_scan_bwd(torch, kind) for kind in ("wkv6",
                                                                "ssd")}
    seconds = {"phase_24": time.perf_counter() - t24}
    log(f"phase 24 took {seconds['phase_24']:.1f} s")
    api.clear_env_cache()
    gc.collect()
    torch.cuda.empty_cache()
    # phases 25-27: the mesh, counts from 0 per run (and per rank)
    t25 = time.perf_counter()
    mesh_d1 = run_mesh_d1(torch, api, kernels)
    t26 = time.perf_counter()
    sharded = run_sharded_round(torch, api, main_path["events_per_s"])
    api.clear_env_cache()
    gc.collect()
    torch.cuda.empty_cache()
    t27 = time.perf_counter()
    multipod = run_multipod(torch, kernels)
    gc.collect()
    torch.cuda.empty_cache()
    # phase 28: the trainer sharded over data, counts from 0 per rank
    t28 = time.perf_counter()
    fsdp = run_fsdp(torch, kernels)
    gc.collect()
    torch.cuda.empty_cache()
    # phase 29: tier stacks laid over pod, counts from 0 per rank
    t29 = time.perf_counter()
    shard_tiers = run_shard_tiers(torch, api)
    seconds.update({"phase_25": t26 - t25, "phase_26": t27 - t26,
                    "phase_27": t28 - t27, "phase_28": t29 - t28,
                    "phase_29": time.perf_counter() - t29,
                    "script": time.perf_counter() - t_start})
    log(f"phases 25-29 took {seconds['phase_25']:.1f} / "
        f"{seconds['phase_26']:.1f} / {seconds['phase_27']:.1f} / "
        f"{seconds['phase_28']:.1f} / {seconds['phase_29']:.1f} s; the "
        f"script so far {seconds['script']:.1f} s")

    src = "src/repro_torch/kernels/csrc/polyline_codec.cu"
    # the main path's lossy step: B1a and B1b fused, per stacked uplink
    up, down = rt_times["uplink"], rt_times["downlink"]
    report = [{
        "name": "quantize_roundtrip", "route": "cuda", "source": src,
        "replaces": "src/repro/kernels/polyline_codec.py:52",
        "also_replaces": "src/repro/kernels/polyline_codec.py:69",
        "launches": main_path["launches"]["roundtrip"],
        "max_abs_err": rt_check["max_abs_err"], "ms": up["ms"],
        "plain_ms": up["plain_ms"], "bound_ms": up["bound_ms"],
        "bound_by": up["bound_by"], "library_ms": None,
        "warm_ms": up["warm_ms"], "pair_ms": up["pair_ms"],
        "floor_ms": up["floor_ms"], "yardstick_ms": up["yardstick_ms"],
        "downlink_ms": down["ms"], "downlink_bound_ms": down["bound_ms"],
        "downlink_floor_ms": down["floor_ms"],
        "faults_launches": faults["launches"]["roundtrip"],
        "fedlm_faults_launches":
            fedlm_ckpt["train_launches"]["roundtrip"],
        "population_launches": population["launches"]["roundtrip"],
        "topology_launches": topology["launches"]["roundtrip"],
        "mesh_d1_launches": mesh_d1["launches"]["roundtrip"],
        "sharded_launches_per_rank": [
            r["launches"]["roundtrip"] for r in sharded["ranks"]],
        "topology_silo_round_ms": topology["profile"].get("codec_ms")}]
    # the reference's pair, held in phase 2 and off the main path since
    # the roundtrip fused it (its launches there are 0)
    for name, line in (("compress", 52), ("decompress", 69)):
        t = times[name]
        report.append({
            "name": f"quantize_{name}", "route": "cuda", "source": src,
            "replaces": f"src/repro/kernels/polyline_codec.py:{line}",
            "launches": main_path["launches"][name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    # fp32 at the qwen2-7b prefill shape is the serving path's; bf16 (the
    # tensor-core design) and zamba2's hd 80 ride along
    f32, bf16 = (flash[d]["shapes"]["qwen2-7b prefill"]
                 for d in ("float32", "bfloat16"))
    tr32, tr16 = (flash[d]["shapes"]["qwen2-7b training"]
                  for d in ("float32", "bfloat16"))
    z32, z16 = (flash[d]["shapes"]["zamba2-2.7b shared block"]
                for d in ("float32", "bfloat16"))
    report.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:91",
        "launches": serving["launches"]["flash_attention"],
        "max_abs_err": flash["float32"]["max_abs_err"], "ms": f32["ms"],
        "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"], "library_ms": f32["library_ms"],
        "bf16_ms": bf16["ms"], "bf16_plain_ms": bf16["plain_ms"],
        "bf16_bound_ms": bf16["bound_ms"],
        "bf16_library_ms": bf16["library_ms"],
        "bf16_max_abs_err": flash["bfloat16"]["max_abs_err"],
        "bf16_launches": serving["bf16_wave"]["launches"]["flash_attention"],
        "hd80_ms": z32["ms"], "hd80_bound_ms": z32["bound_ms"],
        "hd80_library_ms": z32["library_ms"], "hd80_bf16_ms": z16["ms"],
        "hd80_bf16_bound_ms": z16["bound_ms"],
        "hd80_bf16_library_ms": z16["library_ms"],
        "train_ms": tr32["ms"], "train_plain_ms": tr32["plain_ms"],
        "train_bound_ms": tr32["bound_ms"],
        "train_library_ms": tr32["library_ms"],
        "train_bf16_ms": tr16["ms"], "train_bf16_bound_ms": tr16["bound_ms"],
        "train_bf16_library_ms": tr16["library_ms"],
        "train_launches": trainer["launches"]["flash_attention"],
        "multipod_launches_per_rank": [
            r["launches"]["flash_attention"] for r in multipod["ranks"]],
        "fsdp_launches_per_rank": [
            r["launches"]["flash_attention"] for r in fsdp["ranks"]],
        "fedlm_launches": fedlm["launches"]["flash_attention"],
        "fedlm_faults_launches":
            fedlm_ckpt["train_launches"]["flash_attention"],
        "serve_ckpt_launches":
            fedlm_ckpt["serve_launches"]["flash_attention"],
        "moe_serve_launches": {a: r["launches"]["flash_attention"]
                               for a, r in moe_serving.items()},
        "vlm_serve_launches": vlm_serving["launches"]["flash_attention"],
        "family_train_launches_per_step": {
            a: r["launches_per_step"]["flash_attention"]
            for a, r in family_train.items()},
        "hubert_noncausal_ms": hubert_attn["forward"]["ms"],
        "hubert_noncausal_plain_ms": hubert_attn["forward"]["plain_ms"],
        "hubert_noncausal_bound_ms": hubert_attn["forward"]["bound_ms"],
        "hubert_noncausal_bound_by": hubert_attn["forward"]["bound_by"],
        "hubert_noncausal_library_ms":
            hubert_attn["forward"]["library_ms"]})
    # B2's backward: fp32 at the trainer's shape is the trainer's path
    tb = flash_bwd["shapes"]
    t32 = tb["trainer (qwen2-7b widths) float32"]
    t16 = tb["trainer (qwen2-7b widths) bfloat16"]
    fl = tb["federated LM (tiny_lm_long) float32"]
    report.append({
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/ops.py:95",
        "replaces_note": "no Pallas backward: the reference trains through "
                         "jax autodiff of blocked_attention",
        "launches": trainer["launches"]["flash_attention_bwd"],
        "max_abs_err": flash_bwd["float32"]["max_abs_err"],
        "max_rel_err": flash_bwd["float32"]["max_rel_err"],
        "ms": t32["ms"], "plain_ms": t32["plain_ms"],
        "bound_ms": t32["bound_ms"], "bound_by": t32["bound_by"],
        "library_ms": t32["library_ms"], "grid": t32["grid"],
        "tc_bound_ms": t32["tc_bound_ms"], "graph_ms": t32["graph_ms"],
        "parts_ms": t32["parts_ms"],
        "bf16_ms": t16["ms"], "bf16_plain_ms": t16["plain_ms"],
        "bf16_bound_ms": t16["bound_ms"],
        "bf16_library_ms": t16["library_ms"],
        "bf16_graph_ms": t16["graph_ms"], "bf16_parts_ms": t16["parts_ms"],
        "bf16_max_rel_err": flash_bwd["bfloat16"]["max_rel_err"],
        "fedlm_launches": fedlm["launches"]["flash_attention_bwd"],
        "multipod_launches_per_rank": [
            r["launches"]["flash_attention_bwd"] for r in multipod["ranks"]],
        "fsdp_launches_per_rank": [
            r["launches"]["flash_attention_bwd"] for r in fsdp["ranks"]],
        "fedlm_ms": fl["ms"], "fedlm_plain_ms": fl["plain_ms"],
        "fedlm_bound_ms": fl["bound_ms"], "fedlm_bound_by": fl["bound_by"],
        "fedlm_library_ms": fl["library_ms"],
        "fedlm_graph_ms": fl["graph_ms"], "fedlm_parts_ms": fl["parts_ms"],
        "fedlm_faults_launches":
            fedlm_ckpt["train_launches"]["flash_attention_bwd"],
        "family_train_launches_per_step": {
            a: r["launches_per_step"]["flash_attention_bwd"]
            for a, r in family_train.items()},
        "hubert_noncausal_ms": hubert_attn["backward"]["ms"],
        "hubert_noncausal_plain_ms": hubert_attn["backward"]["plain_ms"],
        "hubert_noncausal_bound_ms": hubert_attn["backward"]["bound_ms"],
        "hubert_noncausal_tc_bound_ms":
            hubert_attn["backward"]["tc_bound_ms"],
        "hubert_noncausal_bound_by": hubert_attn["backward"]["bound_by"],
        "hubert_noncausal_library_ms":
            hubert_attn["backward"]["library_ms"],
        "hubert_noncausal_graph_ms": hubert_attn["backward"]["graph_ms"]})
    for name, src, line, arch, res in (
            ("wkv6", "wkv6.cu", "rwkv6_scan.py:68", "rwkv6-3b", wkv),
            ("ssd", "ssd.cu", "ssd.py:64", "zamba2-2.7b", ssd)):
        t, t16 = res["float32"], res["bfloat16"]   # fp32: the serving paths'
        report.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{line}",
            "launches": recurrent[arch]["server"]["launches"][name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "tc_bound_ms": t["tc_bound_ms"], "ctas_per_sm": t["ctas_per_sm"],
            "waves": t["waves"], "bf16_ms": t16["ms"],
            "bf16_plain_ms": t16["plain_ms"],
            "bf16_bound_ms": t16["bound_ms"],
            "bf16_max_abs_err": t16["max_abs_err"],
            "train_launches_per_step":
                recurrent_train[arch]["launches_per_step"][name],
            "train_ms": scan_bwd[name]["fwd_train_ms"],
            "train_bound_ms": scan_bwd[name]["fwd_train_bound_ms"],
            "train_serving_kernel_ms": scan_bwd[name]["fwd_serve_ms"]})
    # the scans' backward: no Pallas version, the reference differentiates
    # its jnp chunk scans; times at the training microbatch.  *_bwd is the
    # whole call (both passes and the wrapper's sums; pass 2 alone beside
    # it), *_bwd_dstate pass 1 alone
    for kind, src, line, arch in (
            ("wkv6", "wkv6_bwd.cu", "models/rwkv6.py:119", "rwkv6-3b"),
            ("ssd", "ssd_bwd.cu", "models/mamba2.py:78", "zamba2-2.7b")):
        t = scan_bwd[kind]
        common = {
            "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/{line}",
            "replaces_note": "no Pallas backward: the reference trains "
                             "through jax autodiff of its jnp chunk scan",
            "library_ms": None}
        for name, extra in (
                (f"{kind}_bwd", {
                    "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                    "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                    "bound_by": t["bound_by"],
                    "tc_bound_ms": t["tc_bound_ms"],
                    "pass2_ms": t["pass2_ms"], "bitwise": t["bitwise"],
                    "strong_decay_errors": t["strong"]}),
                (f"{kind}_bwd_dstate", {
                    "max_abs_err": t["pass1_max_abs_err"],
                    "ms": t["pass1_ms"], "plain_ms": t["pass1_plain_ms"],
                    "bound_ms": t["pass1_bound_ms"],
                    "bound_by": t["pass1_bound_by"]})):
            report.append(dict(
                common, name=name,
                launches=recurrent_train[arch]["launches"][name],
                launches_per_step=recurrent_train[arch][
                    "launches_per_step"][name],
                **t["passes"][name], **extra))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({
            "card": card, "torch": torch.__version__,
            "cuda": torch.version.cuda, "build_s": build_s,
            "kernels": report, "kernel_times": times,
            "roundtrip_check": rt_check, "roundtrip_times": rt_times,
            "main_path": main_path, "card_vs_cpu": agree,
            "baselines": base, "flash": flash, "serving": serving,
            "serving_card_vs_cpu": serve_agree, "wkv6": wkv, "ssd": ssd,
            "recurrent": recurrent,
            "recurrent_card_vs_cpu": recurrent_agree,
            "flash_bwd": flash_bwd, "federated_lm": fedlm,
            "federated_lm_card_vs_cpu": fedlm_agree,
            "trainer": trainer, "faults": faults,
            "fedlm_checkpoint": fedlm_ckpt, "population": population,
            "topology": topology, "moe_serving": moe_serving,
            "moe_card_vs_cpu": moe_agree, "vlm_serving": vlm_serving,
            "vlm_card_vs_cpu": vlm_agree, "family_training": family_train,
            "family_training_card_vs_cpu": family_agree,
            "hubert_attention": hubert_attn,
            "recurrent_training": recurrent_train,
            "recurrent_training_card_vs_cpu": recurrent_train_agree,
            "scan_bwd": scan_bwd, "mesh_d1": mesh_d1,
            "sharded_round": sharded, "multipod": multipod,
            "fsdp": fsdp, "shard_tiers": shard_tiers,
            "seconds": seconds}, indent=2))
    print(json.dumps({"kernels": report}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
