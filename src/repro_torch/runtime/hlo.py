"""Partitioned-HLO analysis: collective inventory + wire-byte estimates.

Parses ``compiled.as_text()`` (the *post-SPMD* module, so shapes are
per-device) and estimates bytes moved over ICI per device:

    all-gather       (n-1)/n * result_bytes
    all-reduce       2 (n-1)/n * result_bytes     (ring: RS + AG)
    reduce-scatter   (n-1)/n * operand_bytes ~ result*(n-1)
    all-to-all       (n-1)/n * result_bytes
    collective-permute   result_bytes

``n`` is the replica-group size parsed from the op's replica_groups.
Collectives inside while-loop bodies execute once per iteration but appear
once in the text — the roofline therefore composes per-layer unrolled
lowerings (benchmarks/roofline.py) instead of trusting a whole-graph count;
this module additionally reports which computations the ops live in so that
composition can sanity-check itself.

The port's own copy of ``repro/runtime/hlo.py``: a text parser over the
standard library's ``re``, for HLO text a caller brings; the port itself
emits none (it has no XLA).
"""
from __future__ import annotations

import re
from typing import Dict, List

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
}

_COLL_RE = re.compile(
    r"(?P<shape>[a-z0-9]+\[[0-9,]*\][^ ]*)\s+"
    r"(?P<op>all-gather|all-reduce|reduce-scatter|all-to-all|"
    r"collective-permute)(?:-start)?\(")

_GROUPS_RE = re.compile(r"replica_groups=\{\{([^}]*)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(shape_str: str) -> int:
    m = re.match(r"([a-z0-9]+)\[([0-9,]*)\]", shape_str)
    if not m:
        return 0
    dtype, dims = m.group(1), m.group(2)
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


def _tuple_shapes(line: str) -> List[str]:
    """Shapes for ops returning tuples: '(f32[..], s8[..]) all-gather(...)'"""
    m = re.match(r"\s*%?\S+\s*=\s*\(([^)]*)\)\s*(all-gather|all-to-all)", line)
    if not m:
        return []
    return re.findall(r"[a-z0-9]+\[[0-9,]*\]", m.group(1))


def _group_size(line: str) -> int:
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        return int(m.group(2))
    m = _GROUPS_RE.search(line)
    if m:
        first = m.group(1)
        return len([x for x in first.split(",") if x.strip() != ""])
    return 2


def iter_collectives(hlo_text: str):
    for line in hlo_text.splitlines():
        m = re.search(
            r"=\s*(?P<full>\(?[^=]*?)\b"
            r"(?P<op>all-gather|all-reduce|reduce-scatter|all-to-all|"
            r"collective-permute)(-start)?\(", line)
        if not m:
            continue
        op = m.group("op")
        shapes = _tuple_shapes(line)
        if not shapes:
            sm = re.search(r"=\s*([a-z0-9]+\[[0-9,]*\])", line)
            shapes = [sm.group(1)] if sm else []
        nbytes = sum(_shape_bytes(s) for s in shapes)
        yield op, nbytes, _group_size(line), line


def count_collectives(hlo_text: str) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for op, _, _, _ in iter_collectives(hlo_text):
        out[op] = out.get(op, 0) + 1
    return out


def collective_bytes(hlo_text: str) -> float:
    """Estimated per-device ICI bytes for one execution of the top-level
    computation (while-loop bodies counted once — see module docstring)."""
    total = 0.0
    for op, nbytes, n, line in iter_collectives(hlo_text):
        if "-done" in line:
            continue
        frac = (n - 1) / max(n, 1)
        if op == "all-reduce":
            total += 2 * frac * nbytes
        elif op == "collective-permute":
            total += nbytes
        else:  # all-gather / reduce-scatter / all-to-all
            total += frac * nbytes
    return total
