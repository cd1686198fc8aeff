"""Roofline bounds of the port's kernels, frozen from the formulas of its
kernel table (PERF.md), so that a kernel's share reads the same work
whatever implements it: the larger of the operations at the fp32 peak
and the bytes at the HBM rate.  Each input byte is read once and each
output byte written once."""
from typing import Dict


def bound_s(nbytes: float, flops: float, peaks: Dict[str, float]) -> float:
    return max(nbytes / peaks["hbm_bytes"], flops / peaks["fp32_flops"])


# -- B1: the link codec's fused roundtrip --------------------------------
def b1_roundtrip_bytes(values: int) -> int:
    """Each fp32 value read once and written once."""
    return 8 * values
