"""How far the host runs ahead of the device at a training step's start, in
ms: the median over the traced steps after the first of the device's
arrival at ``train_step.input`` less the host's, from the program's spans."""

from portbench import spans


def read(ctx):
    return spans.step_lead_ms()
