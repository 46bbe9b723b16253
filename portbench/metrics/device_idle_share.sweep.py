"""The device's idle share over a traced full-scene sweep, in %."""

from portbench import readers


def read(ctx):
    return readers.idle_share(ctx)
