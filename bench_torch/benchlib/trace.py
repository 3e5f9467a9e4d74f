"""A traced segment of calls: the device's busy time, each kernel's time,
and the idle gaps by what the host was doing.

``torch.profiler`` records the segment (CPU and CUDA); its chrome trace
puts host spans and device operations on one clock.  The harness wraps
each part of a call in a span of its own (``bench.inputs``,
``bench.entry``, ``bench.readback``); an idle gap is named by the
harness span that holds its midpoint, ``bench.between`` where none does.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
import typing

import torch

#: Chrome-trace categories of work on the device.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench."


class Trace(typing.NamedTuple):
    """What a segment's trace says.

    ``ops``: ``(name, start_s, dur_s)`` of every device operation inside
    the window, in start order; ``spans``: ``(name, start_s, dur_s)`` of
    the harness's host spans; ``window_s``: the segment's length;
    ``busy_s``: the union of the device operations inside it.
    """

    ops: list
    spans: list
    window_s: float
    busy_s: float
    calls: int

    def kernel_times(self, *parts: str) -> list[float]:
        """Durations of the device operations whose name holds any of
        ``parts``."""
        return [d for name, _, d in self.ops if any(p in name for p in parts)]

    def idle_gaps(self) -> list[tuple[str, float]]:
        """``(host span, seconds)`` of every gap between device work inside
        the window, longest first."""
        gaps, t = [], 0.0
        for _, start, dur in self.ops:
            if start > t:
                gaps.append((t, start))
            t = max(t, start + dur)
        if self.window_s > t:
            gaps.append((t, self.window_s))
        out = []
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            holders = [(d, n) for n, s, d in self.spans if s <= mid <= s + d]
            name = min(holders)[1] if holders else SPAN_PREFIX + "between"
            out.append((name, g1 - g0))
        return sorted(out, key=lambda g: -g[1])

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the longest idle
        gaps, at most ``top`` of each."""
        by_name: dict[str, float] = {}
        for name, _, dur in self.ops:
            by_name[name] = by_name.get(name, 0.0) + dur
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps()[:top]]}


def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces and
    argument list (template arguments kept)."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            return name[:i].strip()
    return name.strip()


def union_length(intervals: list[tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def from_events(events: list[dict], calls: int) -> Trace:
    """A :class:`Trace` from chrome-trace events (``ts`` and ``dur`` in
    microseconds) holding one ``bench.segment`` span."""
    seg = [e for e in events if e.get("name") == SPAN_PREFIX + "segment"
           and e.get("ph") == "X" and e.get("cat") != "gpu_user_annotation"]
    if len(seg) != 1:
        raise ValueError(f"{len(seg)} segment spans in the trace, want 1")
    t0 = float(seg[0]["ts"])
    t1 = t0 + float(seg[0]["dur"])
    ops, spans = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            s0, s1 = max(s, t0), min(s + d, t1)
            if s1 > s0:
                ops.append((short_name(e["name"]), (s0 - t0) * 1e-6,
                            (s1 - s0) * 1e-6))
        elif (e.get("cat") == "user_annotation"
              and e["name"].startswith(SPAN_PREFIX)
              and e["name"] != SPAN_PREFIX + "segment"):
            spans.append((e["name"], (s - t0) * 1e-6, d * 1e-6))
    ops.sort(key=lambda o: o[1])
    busy = union_length([(s, s + d) for _, s, d in ops])
    return Trace(ops, spans, (t1 - t0) * 1e-6, busy, calls)


def record(call, n_calls: int) -> Trace:
    """Run ``call(j)`` for ``j < n_calls`` under the profiler, the device
    idle at both ends, and read the trace."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(SPAN_PREFIX + "segment"):
            for j in range(n_calls):
                call(j)
            torch.cuda.synchronize()
        time.sleep(0.01)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return from_events(events, n_calls)
