"""kernels_roofline: the iteration's least time at the card's peaks
(``work.least_seconds_per_iter``: the least bytes at the memory's rate, or
the operations at float32's, whichever binds) over the card's busy time per
iteration in the traced window, in percent; nothing on a card without a
row in ``work.PEAKS``."""

from portbench import work


def read(ctx):
    tr, peak = ctx["trace"], ctx["peak"]
    if tr is None or peak is None or tr["busy_s"] <= 0:
        return None
    least = work.least_seconds_per_iter(peak=peak, **ctx["sizes"])
    return 100.0 * least / (tr["busy_s"] / tr["iterations"])
