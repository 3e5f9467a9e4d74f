"""A traced segment's calls as intervals on the device's clock: from the
host entering the entry to the call's result on the host, so that a
metric reads the device work of the calls and not that of their inputs
(a driver whose inputs take device time waits for them before the
entry)."""

from __future__ import annotations

from benchlib.trace import SPAN_PREFIX, Trace, union_length


def windows(tr: Trace) -> list[tuple[float, float]]:
    """``(start_s, end_s)`` of each call: a ``bench.entry`` span to the end
    of the ``bench.readback`` span after it."""
    spans = sorted((s, s + d, n) for n, s, d in tr.spans)
    out, start = [], None
    for s, e, name in spans:
        if name == SPAN_PREFIX + "entry":
            start = s
        elif name == SPAN_PREFIX + "readback" and start is not None:
            out.append((start, e))
            start = None
    return out


def ops_in(tr: Trace, window: tuple[float, float]) -> list:
    """The device operations that start inside ``window``."""
    return [op for op in tr.ops if window[0] <= op[1] < window[1]]


def busy_s(tr: Trace, window: tuple[float, float]) -> float:
    """The union of the device operations inside ``window``, clipped to
    it."""
    w0, w1 = window
    return union_length([(max(s, w0), min(s + d, w1)) for _, s, d in tr.ops
                         if s < w1 and s + d > w0])
