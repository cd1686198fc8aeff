"""fedat.useful_pct: the share of the client update's sample slots that
hold a live client's real sample: 100 x ``client.real_samples`` over
``client.slots``, the program's counters over the traced window."""
from portbench import program_spans


def read(rec):
    return program_spans.useful_pct(rec)
