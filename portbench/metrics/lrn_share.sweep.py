"""CONCNN's local response normalizations' share of a sweep band, in %: the
mean device time of the ``concnn.lrn`` spans times the LRNs a forward
(``model.lrn_calls``; a band is one forward) over the mean device time of
``sweep.band``, from the program's spans over the traced sweep."""

from portbench import spans


def read(ctx):
    lrn_ms, band_ms = spans.phase_ms("concnn.lrn"), spans.phase_ms("sweep.band")
    if lrn_ms is None or band_ms is None:
        return None
    return 100.0 * ctx.model.lrn_calls * lrn_ms / band_ms
