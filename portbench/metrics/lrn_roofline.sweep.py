"""CONCNN's local response normalizations' share of their roofline at a
sweep band, in %: the least time of the band's LRNs (``lrn.least_s``: each
LRN's input read and its result written once, float32, at the HBM
bandwidth) over their device time a band, the mean device time of the
``concnn.lrn`` spans times the LRNs a forward (a band is one forward)."""

from portbench import lrn, spans


def read(ctx):
    lrn_ms = spans.phase_ms("concnn.lrn")
    windows = ctx.traffic["batch_rows"] * ctx.config["scene"]["width"]
    least = lrn.least_s(ctx.model, windows, ctx.device_kind)
    if lrn_ms is None or least is None:
        return None
    return 100.0 * least / (ctx.model.lrn_calls * lrn_ms / 1e3)
