"""The sweep window's share of the card's float32 peak, in %: the FLOP of
one eval-mode forward pass a pixel, counted from the reference model, over
the window's wall time."""

from portbench import counts, readers


def read(ctx):
    return readers.flop_share(ctx, counts.forward_flop(ctx.model))
