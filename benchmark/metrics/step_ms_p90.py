"""The 90th percentile, over every step of the window, of the interval
between consecutive steps' starts on the device timeline (a CUDA event
recorded as each step is called; all read after the window)."""

import statistics


def read(ctx):
    intervals = ctx.window.intervals_ms
    if len(intervals) < 2:
        return None
    return statistics.quantiles(intervals, n=10)[8]
