#!/usr/bin/env python3
"""Where the chunk-scan kernels' time goes, by removal, on one NVIDIA card.

    python3 scripts/scan_ablation.py [--part fwd|bwd] [--out FILE] [--dry]

Builds the WKV6 (B3) and SSD (B4) kernels of ``src/repro_torch/kernels/
csrc`` and their backwards (B3 bwd, B4 bwd) once as they are and once per
variant with one part of the work removed (a textual cut of the source;
its results are wrong and are not looked at), then times every build in
two rounds, with CUDA events: the forwards at chip_smoke.py's prefill
shapes (WKV_FULL, SSD_FULL) in fp32 and bf16, each pass of the backwards
at its training shapes (WKV_TRAIN, SSD_TRAIN, fp32).  A part's cost is the
base time minus the variant's.  ``--part`` takes the forwards or the
backwards alone (default both).  The variants:

  * every kernel: ``1xtf32``, one TF32 product where the kernels take
    three (3xTF32);
  * forwards: ``noloads``, no tile copies after the first chunk;
    ``nostate``, ``noreadout``, ``nointra``, one of the three per-warp
    products of a chunk left out; ssd ``noG``, M (the decayed, masked
    C B^T) left at zero; wkv6 ``nopair``, ``nofactored``, ``notransform``,
    A's pairwise diagonal blocks, its factored blocks, or the decay of r
    and k left out;
  * backward pass 1 (``*_bwd_dstate``): ``nostore``, no state gradient
    written per chunk; ``noissue``, no copies after the first chunk;
    ``noproduct``, the chunk's one product left out; ``noscan``, the
    cumsum's shuffles left out;
  * ssd backward pass 2: ``noGdM`` (C B^T and dy x^T), ``nodx``, ``nodC``,
    ``nodB`` (their products), ``noelem`` (L, M, dG and W);
  * wkv6 backward pass 2: ``noS1`` (dy v^T, dy S^T, v dS^T), ``nofrfk``
    (the factored operands), ``nofactA`` (A below the diagonal blocks),
    ``nodiag`` (the diagonal blocks pairwise), ``nod2`` (the factored
    products of dr and dk), ``nodv``, ``nofinal`` (dr, dk, dlogw, du).

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


def _off(s: str) -> tuple:
    """A statement beginning with ``s`` never runs."""
    return (s, s.replace(s.lstrip(), "if (0) " + s.lstrip(), 1))


ONE_TF32 = ("  if (ALO) mma_tf32(d, a.lo, b.hi);\n"
            "  if (BLO) mma_tf32(d, a.hi, b.lo);\n", "")
FWD_VARIANTS = {
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
PASS1 = {
    "1xtf32": [ONE_TF32],
    "nostore": [_off("    store(out + static_cast<long long>(c) * ")],
    "noissue": [_off("    if (c > 0) issue(c - 1);")],
    "noproduct": [("    for (int k0 = 0; k0 < C; k0 += 8) {",
                   "    for (int k0 = 0; k0 < 0; k0 += 8) {")],
}
BWD_VARIANTS = {
    "ssd_bwd": dict(PASS1, **{
        "noscan": [("scan_up(sa[st][lane])", "(sa[st][lane])")],
        "noGdM": [_off("    mma_frag<C, C, D>(acc, rows_a(tC"),
                  _off("    mma_frag<C, C, D>(acc, rows_a(tg")],
        "nodx": [_off("    mma_frag<C, D, D>(bd, "),
                 _off("    mma_acc<C, D, C>(acc, [&](int m, int k) { "
                      "return tG")],
        "nodC": [_off("    mma_frag<C, D, D>(acc, rows_a(tg"),
                 _off("    mma_frag<C, D, C>(acc, rows_a(tM")],
        "nodB": [_off("    mma_acc<C, D, C>(acc, [&](int m, int k) { "
                      "return tM"),
                 _off("    mma_frag<C, D, D>(xd, ")],
        "noelem": [("    for (int j = 0; j < C / 4; ++j) {\n"
                    "      const int s = (tid & 3) + 4 * j;",
                    "    for (int j = 0; j < 0; ++j) {\n"
                    "      const int s = (tid & 3) + 4 * j;")],
    }),
    "wkv6_bwd": dict(PASS1, **{
        "noscan": [("const float cum = scan_up(lw);",
                    "const float cum = lw;")],
        "noS1": [_off("    mma_frag<C, C, D>(acc, rows_a(tg"),
                 _off("  mma_frag<C, D, D>(drd, "),
                 _off("  mma_frag<C, D, D>(dkd, ")],
        "nofrfk": [("for (int e = tid; e < 2 * 16 * D; e += NT) {",
                    "for (int e = tid; e < 0; e += NT) {")],
        "nofactA": [("  if (warp < 2)\n    factored_tile<true>",
                     "  if (warp < 0)\n    factored_tile<true>"),
                    ("  else\n    factored_tile<false>",
                     "  else if (warp < 0)\n    factored_tile<false>")],
        "nodiag": [("  for (int it = 0; it < 2; ++it) {",
                    "  for (int it = 0; it < 0; ++it) {")],
        "nod2": [("  for (int jn = 0; jn < 2; ++jn) {\n"
                  "    const int n0 = 8 * (warp + 4 * jn);",
                  "  for (int jn = 0; jn < 0; ++jn) {\n"
                  "    const int n0 = 8 * (warp + 4 * jn);")],
        "nodv": [_off("    mma_acc<C, D, C>(acc, [&](int m, int k) { "
                      "return tA"),
                 _off("    mma_acc<C, D, D>(\n        acc, [&](int m, int k) "
                      "{ return tk")],
        "nofinal": [("  for (int jn = 0; jn < 2; ++jn) {\n"
                     "    const int i0 = 8 * (warp + 4 * jn) + 2 * q;",
                     "  for (int jn = 0; jn < 0; ++jn) {\n"
                     "    const int i0 = 8 * (warp + 4 * jn) + 2 * q;")],
    }),
}
#: the headers each part's sources include
HEADERS = {"fwd": ("chunk_scan.cuh", "tf32_mma.cuh"),
           "bwd": ("scan_bwd.cuh", "chunk_scan.cuh", "tf32_mma.cuh")}


def sources(kernel: str, headers, cuts) -> dict:
    """{file name: text} of one variant; raises if a cut does not apply."""
    names = (f"{kernel}.cu", *headers)
    out = {n: (CSRC / n).read_text() for n in names}
    for old, new in cuts:
        hit = [n for n in names if old in out[n]]
        if not hit:
            raise SystemExit(f"{kernel}: the cut {old[:50]!r} no longer "
                             f"applies to the sources")
        for n in hit:
            out[n] = out[n].replace(old, new)
    return out


def fwd_calls(torch, cs, g, dtype):
    """The forwards' calls at the prefill shapes in ``dtype``: ({kernel:
    [(label, entry, arguments)]}, the tensors they read and write)."""
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    ll = ctypes.c_longlong
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    dt = 0 if dtype == "float32" else 1
    W, D = cs.WKV_FULL, cs.SSD_FULL
    r, k, v, logw, u, s0 = cs.wkv_inputs(torch, g, dtype=dtype, **W)
    x, Bm, Cm, da, h0 = cs.ssd_inputs(torch, g, dtype=dtype, **D)
    wy, sy = torch.empty_like(r), torch.empty_like(x)
    # no chunk-state output (the backward's): serving's launch; the
    # states are written in place
    wkv = [*map(ptr, (r, k, v, logw, u, wy, s0)), None, dt,
           W["B"], W["S"], W["H"], W["N"],
           *[ll(z) for t in (r, k, v, logw) for z in t.stride()[:3]], stream]
    ssd = [*map(ptr, (x, Bm, Cm, da, sy, h0)), None, dt, D["B"], D["S"],
           D["H"], D["P"], D["N"],
           *[ll(z) for z in (*x.stride()[:3], *Bm.stride()[:2],
                             *Cm.stride()[:2], *da.stride())], stream]
    return ({"wkv6": [(dtype, "wkv6_fwd", wkv)],
             "ssd": [(dtype, "ssd_fwd", ssd)]},
            [r, k, v, logw, u, s0, x, Bm, Cm, da, h0, wy, sy])


def bwd_calls(torch, cs, g):
    """Each backward pass's call at the training shapes (fp32), on the
    forward's chunk states and pass 1's state gradients from the port's
    own kernels: ({kernel: [(label, entry, arguments)]}, the tensors)."""
    from repro_torch.kernels import rwkv6_scan, ssd
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    W, D = cs.WKV_TRAIN, cs.SSD_TRAIN
    r, k, v, logw, u, s0 = cs.wkv_inputs(torch, g, dtype="float32", **W)
    wdy, wds = torch.randn_like(r), torch.randn_like(s0)
    wcs = torch.empty((W["B"], W["H"], rwkv6_scan.n_chunks(W["S"]), W["N"],
                       W["N"]), device="cuda")
    rwkv6_scan.wkv6(r, k, v, logw, u, s0.clone(), chunk_states=wcs)
    wdst, wds0 = rwkv6_scan.wkv6_backward_dstates(r, logw, wdy, wds)
    wout = [torch.empty_like(r) for _ in range(4)] + [torch.empty(
        (W["B"], W["H"], rwkv6_scan.n_chunks(W["S"]), W["N"]),
        device="cuda")]
    x, Bm, Cm, da, h0 = cs.ssd_inputs(torch, g, dtype="float32", **D)
    sdy, sdh = torch.randn_like(x), torch.randn_like(h0)
    scs = torch.empty((D["B"], D["H"], ssd.n_chunks(D["S"]), D["P"],
                       D["N"]), device="cuda")
    ssd.ssd_scan(x, Bm, Cm, da, h0.clone(), chunk_states=scs)
    sdst, sdh0 = ssd.ssd_backward_dstates(Cm, da, sdy, sdh)
    sout = [torch.empty_like(x), torch.empty((*x.shape[:3], D["N"]),
                                             device="cuda"),
            torch.empty((*x.shape[:3], D["N"]), device="cuda"),
            torch.empty_like(da)]
    wdims = [W["B"], W["S"], W["H"], W["N"], stream]
    sdims = [D["B"], D["S"], D["H"], D["P"], D["N"], stream]
    keep = [r, k, v, logw, u, wdy, wds, wcs, wdst, wds0, *wout,
            x, Bm, Cm, da, sdy, sdh, scs, sdst, sdh0, *sout]
    return ({"wkv6_bwd": [
                ("pass1", "wkv6_bwd_dstate",
                 [*map(ptr, (r, logw, wdy, wds, wdst, wds0)), *wdims]),
                ("pass2", "wkv6_bwd",
                 [*map(ptr, (r, k, v, logw, u, wcs, wdst, wdy, *wout)),
                  *wdims])],
             "ssd_bwd": [
                ("pass1", "ssd_bwd_dstate",
                 [*map(ptr, (Cm, da, sdy, sdh, sdst, sdh0)), *sdims]),
                ("pass2", "ssd_bwd",
                 [*map(ptr, (x, Bm, Cm, da, scs, sdst, sdy, *sout)),
                  *sdims])]}, keep)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", choices=("fwd", "bwd"),
                    help="only the forwards or only the backwards")
    ap.add_argument("--out", help="also write the times as JSON here")
    ap.add_argument("--dry", action="store_true")
    args = ap.parse_args()
    parts = [p for p in ("fwd", "bwd") if args.part in (None, p)]
    variants = {p: FWD_VARIANTS if p == "fwd" else BWD_VARIANTS
                for p in parts}
    texts = {(kernel, name): sources(kernel, HEADERS[p], cuts)
             for p in parts for kernel, vs in variants[p].items()
             for name, cuts in [("base", []), *vs.items()]}
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
    settings = [lambda dt=dt: fwd_calls(torch, cs, g, dt)
                for dt in ("float32", "bfloat16") if "fwd" in parts]
    if "bwd" in parts:
        settings.append(lambda: bwd_calls(torch, cs, g))
    times = {}
    for make in settings:
        calls, keep = make()
        for _ in range(2):
            for (kernel, name) in procs:
                if kernel not in calls:
                    continue
                lib = ctypes.CDLL(str(OUT / f"{kernel}_{name}" / "lib.so"))
                for label, entry, fa in calls[kernel]:
                    fn = getattr(lib, entry)
                    cs.check(fn(*fa) == 0, f"{kernel} {name} {label}: the "
                             f"launch failed")
                    ms = cs.event_time_ms(torch, lambda: fn(*fa), 20)
                    times.setdefault(f"{kernel} {label} {name}",
                                     []).append(ms)
        del calls, keep
    for key, t in times.items():
        kernel, label, name = key.split()
        base = min(times[f"{kernel} {label} base"])
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
