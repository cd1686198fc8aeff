"""fedat.round_ms: mean host milliseconds of ``RoundExecutor.fedat_round``
over the window's rounds, synchronised before and after each (spans
``fedat_round``, traced run)."""


def read(rec):
    d = [b - a for n, a, b in rec["spans"] if n == "fedat_round"]
    return 1e3 * sum(d) / len(d) if d else None
