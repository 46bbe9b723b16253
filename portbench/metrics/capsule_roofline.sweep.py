"""The capsule layer's share of its roofline at a sweep band, in %: the
least time of the band's transform and routing (``capsules.layer_least_s``:
the reference's FLOP at the float32 peak or the layer's least bytes at the
HBM bandwidth, the larger) over the mean device time of CAP's
``cap.transform`` plus ``cap.routing`` spans in the traced sweep."""

from portbench import capsules, spans


def read(ctx):
    transform, routing = spans.phase_ms("cap.transform"), spans.phase_ms("cap.routing")
    windows = ctx.traffic["batch_rows"] * ctx.config["scene"]["width"]
    least = capsules.layer_least_s(ctx.model, windows, ctx.device_kind)
    if transform is None or routing is None or least is None:
        return None
    return 100.0 * least / ((transform + routing) / 1e3)
