"""The mean device time of a training step's `train_step.backward` phase, in
ms, from the program's spans over the traced steps."""

from portbench import spans


def read(ctx):
    return spans.phase_ms("train_step.backward")
