"""Device operations that one training step launches, counted in the trace."""

from portbench import readers


def read(ctx):
    return readers.launches_per_iteration(ctx)
