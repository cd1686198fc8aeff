"""fedat.round_self_ms: mean device milliseconds of a ``fedat.round``
outside its ``client.update`` (the permutations, the batch gather, both
codec links, Eq. 4, Eq. 3, and the device idle while the host works inside
the round): the program's spans over the traced window."""
from portbench import program_spans


def read(rec):
    return program_spans.round_self_ms(rec)
