"""fedat.update.opt_ms: device milliseconds a FedAT round spends in
``client.opt``, the Adam update of the K clients' parameters, summed
over the client update's local steps (the program's spans over the
traced window, per ``fedat.round``)."""
from portbench import program_spans


def read(rec):
    return program_spans.per_round_ms(rec, "client.opt")
