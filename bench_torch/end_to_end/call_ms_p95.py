"""The 95th percentile, over all calls of the window, of a call's wall
time: from the host entering the entry to the result on the host."""

from benchlib.stats import percentile


def read(ctx):
    return 1e3 * percentile([r.done - r.enter for r in ctx.records], 95)
