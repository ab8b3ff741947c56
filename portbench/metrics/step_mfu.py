"""step_mfu: the whole step's share of the card's peak: the iteration's
least time at the card's peaks (as ``kernels_roofline``) over its wall
time in the traced window (window over iterations), in percent.  It bounds
every kernel's share from above: the card's idle time and the work of every
kernel count against it."""

from portbench import work


def read(ctx):
    tr, peak = ctx["trace"], ctx["peak"]
    if tr is None or peak is None or tr["window_s"] <= 0:
        return None
    least = work.least_seconds_per_iter(peak=peak, **ctx["sizes"])
    return 100.0 * least / (tr["window_s"] / tr["iterations"])
