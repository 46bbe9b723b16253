"""How far the host runs ahead of the device at a sweep band's start, in ms:
the median over each traced scene's bands after the first of the device's
arrival at ``sweep.band`` less the host's, from the program's spans."""

from portbench import spans


def read(ctx):
    return spans.band_lead_ms()
