#!/usr/bin/env python3
"""The fused codec roundtrip's CTA shape, timed on one NVIDIA card.

    python3 scripts/codec_shapes.py [--out FILE] [--dry]

Builds ``src/repro_torch/kernels/csrc/polyline_codec.cu`` once as it is
and once per variant (a textual change of the roundtrip's constants or
of its loads and stores), then times every build's roundtrip as
chip_smoke.py phase 2 does: per tree of the paper CNN at CIFAR-10 shape,
the K = 10 stacked uplink and the downlink, L2-cold (one CUDA graph over
enough copies of the tree that its inputs exceed the 50 MB L2) and, for
the uplink, warm (the same number of calls on one copy), in two rounds.
Each build is held bitwise against the plain version first.  The
variants:

  * ``w<W>_b<B>``: W warps a CTA, B codec blocks a warp (the source's
    own is the base; its name is printed);
  * ``hints`` / ``nohints``: the base shape with the streaming cache
    hints (``__ldcs``, ``__stcs``) on the block's vector loads and stores
    added or taken away, whichever the source lacks.

``--dry`` only checks, without a card, that every change still applies to
the source.  The last line of output is the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "polyline_codec.cu"
OUT = ROOT / "build" / "codec_shapes"
SHAPES = [(2, 1), (4, 1), (8, 1), (2, 2), (4, 2), (8, 2), (4, 4)]
STREAM = [("const float4 a = x4[lane];", "const float4 a = __ldcs(x4 + lane);"),
          ("const float4 b = x4[32 + lane];",
           "const float4 b = __ldcs(x4 + 32 + lane);"),
          ("o4[lane] = make_float4(v[0], v[1], v[2], v[3]);",
           "__stcs(o4 + lane, make_float4(v[0], v[1], v[2], v[3]));"),
          ("o4[32 + lane] = make_float4(v[4], v[5], v[6], v[7]);",
           "__stcs(o4 + 32 + lane, make_float4(v[4], v[5], v[6], v[7]));")]


def shape_of(text: str):
    w = re.search(r"constexpr int kRoundtripWarps = (\d+);", text)
    b = re.search(r"constexpr int kRoundtripBlocksPerWarp = (\d+);", text)
    if not (w and b):
        raise SystemExit("the roundtrip's shape constants are not in the "
                         "source")
    return int(w.group(1)), int(b.group(1))


def variants() -> dict:
    """{name: source text}; raises if a change does not apply."""
    text = SRC.read_text()
    w0, b0 = shape_of(text)
    out = {f"w{w0}_b{b0} (base)": text}
    for w, b in SHAPES:
        if (w, b) != (w0, b0):
            out[f"w{w}_b{b}"] = re.sub(
                r"(constexpr int kRoundtripBlocksPerWarp = )\d+;", rf"\g<1>{b};",
                re.sub(r"(constexpr int kRoundtripWarps = )\d+;",
                       rf"\g<1>{w};", text))
    hinted = STREAM[0][1] in text
    s = text
    for plain, hint in STREAM:
        old, new = (hint, plain) if hinted else (plain, hint)
        if old not in s:
            raise SystemExit(f"the change {old!r} no longer applies")
        s = s.replace(old, new)
    out[f"w{w0}_b{b0}_{'nohints' if hinted else 'hints'}"] = s
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the times as JSON here")
    ap.add_argument("--dry", action="store_true")
    args = ap.parse_args()
    texts = variants()
    if args.dry:
        print(f"{len(texts)} builds: {', '.join(texts)}")
        return

    import torch
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels import polyline_codec as pc, ref
    from repro_torch.models.registry import DataDims, build_model
    if not torch.cuda.is_available():
        cs.fail("CUDA is not available; this script needs an NVIDIA card")
    card = cs.card_line()
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        d = OUT / f"v{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "polyline_codec.cu").write_text(text)
        procs[name] = (d / "lib.so", subprocess.Popen(
            [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "polyline_codec.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc failed for {name}:\n{log}")
        regs = re.findall(r"roundtrip_kernel.*?Used (\d+) registers", log,
                          re.S)
        print(f"{name}: roundtrip_kernel {regs[0] if regs else '?'} "
              f"registers", flush=True)
        libs[name] = str(path)

    import ctypes
    model = build_model("cnn", DataDims(n_classes=10, image_hw=32))
    shapes = [tuple(v.shape) for v in
              model.init_params(torch.Generator().manual_seed(0)).values()]
    g = torch.Generator(device="cuda").manual_seed(3)
    trees = {}
    for link, stack in (("uplink", 10), ("downlink", 1)):
        sizes = [stack * math.prod(s) for s in shapes]
        copies = math.ceil(cs.L2_BYTES / (4 * sum(sizes))) + 1
        trees[link] = [[torch.randn(n, device="cuda", generator=g) * 0.05
                        for n in sizes] for _ in range(copies)]
    times = {}
    for rnd in range(2):
        for name, path in libs.items():
            # every wrapper of the module now runs this build
            kbuild._LIBS["polyline_codec"] = ctypes.CDLL(path)
            pc._LIB._lib = None
            if rnd == 0:
                t = trees["uplink"][0] + [trees["uplink"][0][0][1:]]
                for o, r in zip(pc.roundtrip_blocks(t, 8),
                                ref.roundtrip_blocks(t, 8)):
                    cs.check(cs.bits_equal(o, r), f"{name} is not bitwise "
                             f"equal to the plain version")
            for link, copies in trees.items():
                ms = cs.graph_time_ms(
                    torch, lambda: [pc.roundtrip_blocks(c, 8)
                                    for c in copies], 20) / len(copies)
                times.setdefault(f"{name} {link} cold", []).append(ms)
            up = trees["uplink"]

            def warm():
                for _ in up:
                    pc.roundtrip_blocks(up[0], 8)
            times.setdefault(f"{name} uplink warm", []).append(
                cs.graph_time_ms(torch, warm, 20) / len(up))
    for key, t in times.items():
        print(f"{key}: {' / '.join(f'{x:.5f}' for x in t)} ms (best "
              f"{min(t):.5f})", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "ms": times},
                                             indent=1))
    print(card, flush=True)


if __name__ == "__main__":
    main()
