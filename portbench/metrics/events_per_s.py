"""events_per_s: committed global updates (tier rounds folded into the
global model by Eq. 3) over the seconds from the window's start to the
end of the last update committed in it, host clock."""


def read(rec):
    n = rec["counters"].get("committed_updates")
    t0, t1 = rec["window"]
    return n / (t1 - t0) if n else None
