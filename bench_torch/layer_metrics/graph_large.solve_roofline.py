"""The large solve's share of its roofline: the least time the card could
take for the traced segment's last call (``roofline/graph_large.py``
from that call's counts, against the H100's published peaks) over the
device's busy time in that call, from entering the entry to the result
on the host, in percent."""

from benchlib import calls, device


def read(ctx):
    if ctx.trace is None or "resolves" not in ctx.counts:
        return None
    wins = calls.windows(ctx.trace)
    busy = calls.busy_s(ctx.trace, wins[-1]) if wins else 0.0
    if busy <= 0.0:
        return None
    least, _ = ctx.cell.reader("roofline", "graph_large").least_s(
        ctx.traffic, ctx.counts, device.PEAKS)
    return 100.0 * least / busy
