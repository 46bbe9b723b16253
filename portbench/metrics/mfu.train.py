"""The training window's share of the card's float32 peak, in %: the FLOP
that a step needs (3 training-mode forward passes, less the input
gradient), counted from the reference model, over the window's wall time."""

from portbench import counts, readers


def read(ctx):
    return readers.flop_share(ctx, counts.train_flop(ctx.model))
