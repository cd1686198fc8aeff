"""fedat.update.bwd_ms: device milliseconds a FedAT round spends in
``client.bwd``, ``torch.autograd.grad`` of the objective, summed over
the client update's local steps (the program's spans over the traced
window, per ``fedat.round``)."""
from portbench import program_spans


def read(rec):
    return program_spans.per_round_ms(rec, "client.bwd")
