"""roofline.b1.fedat: the link codec's fused roundtrip (B1,
``roundtrip_kernel``): its bytes bound (each fp32 value read once and
written once) over its traced time, two launches a round (the downlink's
global model, the uplink's K client models).  Nothing is read unless the
trace holds exactly those launches."""
from portbench import devtrace
from portbench.counts import kernels

PATTERN = "roundtrip_kernel"


def read(rec):
    peaks, events = rec.get("peaks"), rec.get("device_events")
    if not peaks or not events:
        return None
    t0, t1 = rec["window"]
    n, sec = devtrace.kernel_time(events, lambda s: PATTERN in s, t0, t1)
    if n != 2 * rec["counters"]["committed_updates"] or sec <= 0:
        return None
    nbytes = kernels.b1_roundtrip_bytes(rec["counters"]["b1_values"])
    return 100.0 * kernels.bound_s(nbytes, 0, peaks) / sec
