"""The capsule layer's share of a sweep band, in %: the mean device time of
CAP's ``cap.transform`` plus ``cap.routing`` spans over that of
``sweep.band``, from the program's spans over the traced sweep."""

from portbench import spans


def read(ctx):
    times = [spans.phase_ms(name) for name in ("cap.transform", "cap.routing", "sweep.band")]
    if None in times:
        return None
    transform, routing, band = times
    return 100.0 * (transform + routing) / band
