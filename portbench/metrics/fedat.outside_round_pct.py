"""fedat.outside_round_pct: the share of the window outside the rounds'
spans (``fedat_round``): the engine's event pops, Eq. 3 bookkeeping on
the host, the evals."""


def read(rec):
    d = [b - a for n, a, b in rec["spans"] if n == "fedat_round"]
    t0, t1 = rec["window"]
    return 100.0 * (1.0 - sum(d) / (t1 - t0)) if d else None
