#!/usr/bin/env python3
"""Where the chunk-scan kernels' time goes, by removal, on one NVIDIA card.

    python3 scripts/scan_ablation.py [--out FILE] [--dry]

Builds the WKV6 (B3) and SSD (B4) kernels of ``src/repro_torch/kernels/
csrc`` once as they are and once per variant with one part of the work
removed (a textual cut of the source; its results are wrong and are not
looked at), then times every build at chip_smoke.py's prefill shapes
(WKV_FULL, SSD_FULL) in fp32 and bf16, in two rounds, with CUDA events.
A part's cost is the base time minus the variant's.  The variants:

  * ``1xtf32``: one TF32 product where the kernels take three (3xTF32);
  * ``noloads``: no tile copies after the first chunk;
  * ``nostate``, ``noreadout``, ``nointra``: one of the three per-warp
    products of a chunk left out;
  * ssd ``noG``: M (the decayed, masked C B^T) left at zero;
  * wkv6 ``nopair``, ``nofactored``, ``notransform``: A's pairwise
    diagonal blocks, its factored blocks, or the decay of r and k left
    out.

``--dry`` only checks, without a card, that every cut still applies to the
sources.  The last line of output is the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
OUT = ROOT / "build" / "scan_ablation"

ONE_TF32 = ("  if (ALO) mma_tf32(d, a.lo, b.hi);\n"
            "  if (BLO) mma_tf32(d, a.hi, b.lo);\n", "")
VARIANTS = {
    "ssd": {
        "1xtf32": [ONE_TF32],
        "noloads": [("done\n    if (c + 1 < nchunks) issue(c + 1);", "done")],
        "nostate": [("mma3(hs[nt], a, bw);", "")],
        "noreadout": [("for (int kk = 0; kk < 8; ++kk) {\n      FragA<true> a;"
                       "\n      a.set(hs[kk][0]",
                       "for (int kk = 0; kk < 0; ++kk) {\n      FragA<true> a;"
                       "\n      a.set(hs[kk][0]")],
        "nointra": [("mma3(ya[jt], a, m);", "")],
        "noG": [("    if (warp < 2)\n      build_m<LO, true>",
                 "    if (warp < 0)\n      build_m<LO, true>"),
                ("    else\n      build_m<LO, false>(M, cs, bs, cum, warp, g, "
                 "q);", "")],
    },
    "wkv6": {
        "1xtf32": [ONE_TF32],
        "noloads": [("done\n    if (c + 1 < nchunks) issue(c + 1);", "done")],
        "nostate": [("mma3(ss[nt], a, kb);", "")],
        "noreadout": [("for (int kk = 0; kk < 8; ++kk) {\n      FragA<true> a;"
                       "\n      a.set(ss[kk][0]",
                       "for (int kk = 0; kk < 0; ++kk) {\n      FragA<true> a;"
                       "\n      a.set(ss[kk][0]")],
        "nointra": [("mma3(ya[jt], a, m);", "")],
        "nopair": [("for (int e = (tid + 64) % kThreads;",
                    "for (int e = kEntries + (tid + 64) % kThreads;")],
        "nofactored": [("    if (warp < 2)\n      factored_tile<true>",
                        "    if (warp < 0)\n      factored_tile<true>"),
                       ("    else\n      factored_tile<false>",
                        "    else if (warp < 0)\n      factored_tile<false>")],
        "notransform": [("for (int e = tid; e < kTile / 4; e += kThreads) {",
                         "for (int e = kTile + tid; e < kTile / 4; "
                         "e += kThreads) {")],
    },
}


def sources(kernel: str, cuts) -> dict:
    """{file name: text} of one variant; raises if a cut does not apply."""
    out = {}
    for name in (f"{kernel}.cu", "chunk_scan.cuh"):
        text = (CSRC / name).read_text()
        for old, new in cuts:
            if old in text:
                text = text.replace(old, new)
        out[name] = text
    base = [(CSRC / n).read_text() for n in out]
    for old, _ in cuts:
        if not any(old in b for b in base):
            raise SystemExit(f"{kernel}: the cut {old[:40]!r} no longer "
                             f"applies to the sources")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the times as JSON here")
    ap.add_argument("--dry", action="store_true")
    args = ap.parse_args()
    builds = {(k, "base"): [] for k in VARIANTS}
    builds.update({(k, v): cuts for k, vs in VARIANTS.items()
                   for v, cuts in vs.items()})
    texts = {key: sources(key[0], cuts) for key, cuts in builds.items()}
    if args.dry:
        print(f"{len(texts)} builds; every cut applies")
        return

    import torch
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build as kbuild
    if not torch.cuda.is_available():
        cs.fail("CUDA is not available; this script needs an NVIDIA card")
    card = cs.card_line()
    procs = {}
    for (kernel, name), text in texts.items():
        d = OUT / f"{kernel}_{name}"
        d.mkdir(parents=True, exist_ok=True)
        for fname, body in text.items():
            (d / fname).write_text(body)
        procs[(kernel, name)] = subprocess.Popen(
            [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / f"{kernel}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    for key, proc in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc failed for {key}:\n{log}")

    g = torch.Generator(device="cuda").manual_seed(0)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    ll = ctypes.c_longlong
    times = {}
    for dtype in ("float32", "bfloat16"):
        dt = 0 if dtype == "float32" else 1
        W, D = cs.WKV_FULL, cs.SSD_FULL
        r, k, v, logw, u, s0 = cs.wkv_inputs(torch, g, dtype=dtype, **W)
        x, Bm, Cm, da, h0 = cs.ssd_inputs(torch, g, dtype=dtype, **D)
        wy, sy = torch.empty_like(r), torch.empty_like(x)
        ws, hs = s0.clone(), h0.clone()   # the states, written in place
        # no chunk-state output (the backward's): serving's launch
        wkv_args = [*map(ptr, (r, k, v, logw, u, wy, ws)), None, dt,
                    W["B"], W["S"], W["H"], W["N"],
                    *[ll(z) for t in (r, k, v, logw) for z in t.stride()[:3]],
                    stream]
        ssd_args = [*map(ptr, (x, Bm, Cm, da, sy, hs)), None, dt, D["B"],
                    D["S"], D["H"], D["P"], D["N"],
                    *[ll(z) for z in (*x.stride()[:3], *Bm.stride()[:2],
                                      *Cm.stride()[:2], *da.stride())],
                    stream]
        for _ in range(2):
            for (kernel, name) in procs:
                lib = ctypes.CDLL(str(OUT / f"{kernel}_{name}" / "lib.so"))
                fn = lib.wkv6_fwd if kernel == "wkv6" else lib.ssd_fwd
                fn_args = wkv_args if kernel == "wkv6" else ssd_args
                ms = cs.event_time_ms(torch, lambda: fn(*fn_args), 20)
                times.setdefault(f"{kernel} {dtype} {name}", []).append(ms)
        del r, k, v, logw, x, Bm, Cm, da, wy, sy, ws, hs
    for key, t in times.items():
        kernel, dtype, name = key.split()
        base = min(times[f"{kernel} {dtype} base"])
        print(f"{key}: {' / '.join(f'{x:.4f}' for x in t)} ms"
              + ("" if name == "base" else
                 f" (the part: {base - min(t):.4f} ms)"), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "ms": times},
                                             indent=1))
    print(card, flush=True)


if __name__ == "__main__":
    main()
