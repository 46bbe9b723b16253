"""The device's idle share over a traced stretch of training steps, in %."""

from portbench import readers


def read(ctx):
    return readers.idle_share(ctx)
