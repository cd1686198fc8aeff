"""idle.fedat: the share of the traced window in which no device
activity ran (1 - union of kernel, copy and set intervals / window)."""


def read(rec):
    if rec.get("busy_s") is None or not rec.get("device_events"):
        return None
    t0, t1 = rec["window"]
    return 100.0 * (1.0 - rec["busy_s"] / (t1 - t0))
