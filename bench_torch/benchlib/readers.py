"""The arithmetic that several metrics' readers share.  Each reader in
``end_to_end/`` and ``layer_metrics/`` names what it measures and takes
one of these."""

from __future__ import annotations


def rate(ctx) -> float:
    """All work of the window's calls over the window's seconds."""
    return ctx.work_per_call * len(ctx.records) / ctx.window_s


def host_us_per_call(ctx) -> float:
    """Host microseconds inside the entry, from entering it to its return
    (before the readback), the mean over the window's calls."""
    return 1e6 * sum(r.returned - r.enter for r in ctx.records) / len(
        ctx.records)


def host_us_per_step(ctx) -> float:
    """:func:`host_us_per_call` over the traffic's steps a call."""
    return host_us_per_call(ctx) / ctx.traffic["steps"]


def idle_pct(ctx):
    """The share of the traced segment in which no operation ran on the
    device, in percent; None without a trace."""
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
