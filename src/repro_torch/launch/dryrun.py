"""Multi-pod dry-run: every (arch x shape x mesh) cell's bytes on one
device of the production meshes.

The port of ``repro/launch/dryrun.py``.  For each applicable cell
(configs/shapes.py ``applicable``, every registered arch x shape, on the
single-pod ``(data=16, model=16)`` and the multi-pod ``(pod=2, data=16,
model=16)`` mesh):

  * train_4k     -> the train step's state and batch (single-pod: params
                    and AdamW m/v; multi-pod: the same per pod, the pod
                    axis carrying the leading pod dim, plus the bytes a
                    device puts on the wire at each cross-pod sync, int8/
                    int4/int16/fp32 payload and row scales)
  * prefill_32k  -> params, the KV/recurrent cache and the prompt batch
  * decode_32k / long_500k -> params, a cache of seq_len and one token

The params are bf16, as the reference lowers them; every tensor is a
``meta``-device stand-in (shapes only).  A leaf's bytes on one device are
its shape divided, dimension by dimension, by the mesh axes its logical
axes resolve to (runtime/sharding.py ``device_bytes``; an uneven split
padded up).  For params and AdamW state this is what a run holds: the
trainer keeps each rank's FSDP shard of every leaf with an ``fsdp``
dimension (core/steps.py; ``chip_smoke.py`` phase 28 checks a rank's
bytes against this arithmetic).  The counts are still arithmetic: XLA's
``memory_analysis()`` and ``cost_analysis()`` and the partitioned-HLO
collective parse, which the reference reads from a compiled program,
have no counterpart in torch, so temporaries, FLOPs and the collectives
GSPMD would insert are not counted.  Writes ``<out>/dryrun_single.json`` / ``dryrun_multi.json``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both [--out experiments]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import SHAPES, applicable, registry
from repro_torch.core import steps as steps_mod
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import common, lm
from repro_torch.runtime import sharding as shd

#: cross-pod payload widths counted for a multi-pod train cell (0 = fp32)
SYNC_BITS = (16, 8, 4, 0)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def sync_bytes(cfg, tp: int, mesh) -> Dict[str, int]:
    """Bytes one device sends at a cross-pod sync, per payload width:
    each param leaf quantized per last-dim row (core/steps.py
    ``quantize_rows``: int16/int8 codes, int4 packed two a byte along
    the last dim when it is even, fp32 at 0 bits) in the leaf's own
    layout, plus one fp32 scale a row."""
    out = {}
    for bits in SYNC_BITS:
        total = 0
        for _, spec in common.iter_specs(lm.param_specs(cfg, tp)):
            shape = tuple(spec.shape)
            lay = shd.logical_sharding(spec.axes, mesh)
            if not bits:
                total += shd.device_bytes(shape, 4, lay, mesh)
                continue
            if bits == 4 and shape[-1] % 2 == 0:
                pay = shd.device_bytes(shape[:-1] + (shape[-1] // 2,), 1,
                                       lay, mesh)
            else:
                pay = shd.device_bytes(shape, 1 if bits <= 8 else 2, lay,
                                       mesh)
            rows = shd.device_bytes(shape[:-1] + (1,), 4,
                                    lay[:-1] + (None,), mesh)
            total += pay + rows
        out[str(bits)] = total
    return out


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               fedat_bits: int = 8,
               overrides: Optional[Dict[str, Any]] = None,
               rules_override: Optional[Dict[str, Any]] = None):
    """Returns (parts, meta) for one cell: ``parts`` maps each part of
    the step's inputs (``params``, ``opt_state``, ``batch``, ``cache``) to
    a list of (meta tensor, resolved layout) on the production mesh;
    (None, {"skipped": True}) for a cell ``applicable`` rules out."""
    cfg = registry.get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = SHAPES[shape_name]
    if not applicable(cfg, shape):
        return None, {"skipped": True}
    mesh = make_production_mesh(multi_pod=multi_pod)
    tp = mesh.shape["model"]
    # tiny-batch cells (long_500k: B=1) cannot shard batch over the data
    # axis: replicate batch dims, keep model-axis sharding
    dp = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    rules = dict(rules_override or {})
    if shape.global_batch < dp:
        rules.update({"batch": None, "cache_batch": None})

    def laid(tensors, axes):
        if isinstance(tensors, torch.Tensor):
            return [(tensors, shd.logical_sharding(axes, mesh))]
        if isinstance(tensors, dict):
            return [x for k in sorted(tensors)
                    for x in laid(tensors[k], axes[k])]
        return [x for t, a in zip(tensors, axes) for x in laid(t, a)]

    with shd.use_mesh(mesh, rules or None):
        axes = lm.param_axes(cfg, tp)
        parts = {"params": laid(lm.abstract_params(cfg, tp, torch.bfloat16),
                                axes)}
        batch = lm.input_specs(cfg, shape)
        if shape.kind == "train":
            m = common.shapes_from_specs(lm.param_specs(cfg, tp),
                                         torch.float32)
            parts["opt_state"] = laid(m, axes) * 2            # m and v
            if multi_pod:
                # pre-split (n_pods, B/n_pods, ...), pods x data ranks
                split = steps_mod.split_batch_for_pods(batch,
                                                       mesh.shape["pod"])
                parts["batch"] = [(t, ("pod", "data") + (None,) * (
                    t.dim() - 2)) for _, t in sorted(split.items())]
            else:
                parts["batch"] = laid(batch, lm.input_axes(cfg, shape))
        else:
            parts["cache"] = laid(lm.abstract_cache(
                cfg, shape.global_batch, shape.seq_len, tp),
                lm.cache_axes_tree(cfg, tp))
            parts["batch"] = laid(batch, lm.input_axes(cfg, shape))
        meta = {"arch": arch, "shape": shape_name,
                "mesh": "multi" if multi_pod else "single",
                "n_devices": mesh.size, "tp": tp}
        if multi_pod and shape.kind == "train":
            meta["sync_bytes_per_device"] = sync_bytes(cfg, tp, mesh)
            meta["fedat_bits"] = fedat_bits
    return parts, meta


def compile_cell(arch: str, shape_name: str, multi_pod: bool,
                 fedat_bits: int = 8, overrides=None,
                 rules_override=None) -> Dict[str, Any]:
    """One cell's per-device bytes by part and in all
    (``peak_bytes_per_device``; no temporaries), and for a multi-pod
    train cell the bytes a device sends a sync at each width."""
    t0 = time.perf_counter()
    parts, meta = lower_cell(arch, shape_name, multi_pod, fedat_bits,
                             overrides, rules_override)
    if parts is None:
        return meta
    mesh = make_production_mesh(multi_pod=multi_pod)
    meta["bytes_per_device"] = {
        k: sum(shd.device_bytes(t.shape, _itemsize(t.dtype), spec, mesh)
               for t, spec in v) for k, v in parts.items()}
    meta["peak_bytes_per_device"] = sum(meta["bytes_per_device"].values())
    meta["count_s"] = time.perf_counter() - t0
    return meta


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments")
    ap.add_argument("--fedat-bits", type=int, default=8)
    ap.add_argument("--no-serve-fsdp", action="store_true",
                    help="replicate weights over the data axis for serve "
                         "cells")
    args = ap.parse_args(argv)

    archs = registry.ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    results = []
    failures = 0
    for multi in meshes:
        tag = "multi" if multi else "single"
        for arch in archs:
            for shape in shapes:
                rules = None
                if args.no_serve_fsdp and SHAPES[shape].kind != "train":
                    rules = {"fsdp": None}
                try:
                    r = compile_cell(arch, shape, multi, args.fedat_bits,
                                     rules_override=rules)
                except Exception:
                    failures += 1
                    print(f"[dryrun] FAILED {arch} {shape} {tag}",
                          flush=True)
                    traceback.print_exc()
                    r = {"arch": arch, "shape": shape, "mesh": tag,
                         "failed": True}
                results.append(r)
                if "peak_bytes_per_device" in r:
                    gib = r["peak_bytes_per_device"] / 2**30
                    print(f"[dryrun] {arch:22s} {shape:12s} {tag:6s} "
                          f"bytes/dev={gib:7.2f}GiB", flush=True)
        with open(os.path.join(args.out, f"dryrun_{tag}.json"), "w") as f:
            json.dump([r for r in results
                       if r.get("mesh") == tag or r.get("skipped")], f,
                      indent=1)
    ok = sum(1 for r in results if "peak_bytes_per_device" in r)
    skip = sum(1 for r in results if r.get("skipped"))
    print(f"[dryrun] done: {ok} counted, {skip} skipped (documented), "
          f"{failures} FAILED", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
