"""The device time of a scene in which no band runs, in ms: ``sweep.setup``
plus ``sweep.map``, a mean over the traced scenes, from the program's spans."""

from portbench import spans


def read(ctx):
    return spans.scene_edges_ms()
