"""The window gather's share of its roofline at a sweep band, in %: the
least time to move the band's bytes (``counts.gather_band_bytes``) at the
card's HBM bandwidth, over the mean device time of the gather kernel in
the traced sweep."""

from portbench import counts, readers


def read(ctx):
    k = 2 * ctx.config["neighborhood"] + 1
    scene = ctx.config["scene"]
    least = counts.gather_band_bytes(ctx.traffic["batch_rows"], scene["width"], k,
                                     scene["casi_bands"] + scene["lidar_bands"])
    return readers.kernel_roofline(ctx, "window_gather_kernel", least)
