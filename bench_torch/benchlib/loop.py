"""The closed loop: one caller, calls back to back.  Call ``i`` makes its
inputs from the seed (outside the call's time), enters the program's
entry, and ends when its result is on the host."""

from __future__ import annotations

import contextlib
import math
import time
import typing

import torch


class Record(typing.NamedTuple):
    """Host clock of one call: entering the entry, its return, the result
    on the host."""

    enter: float
    returned: float
    done: float


def one_call(driver, i: int, spans: bool = False):
    """Make call ``i``: ``(record, inputs, outputs, result)``.  With
    ``spans`` each part runs inside a profiler span of its own."""
    def span(name):
        return (torch.profiler.record_function(name) if spans
                else contextlib.nullcontext())
    with span("bench.inputs"):
        inp = driver.inputs(i)
    with span("bench.entry"):
        t0 = time.perf_counter()
        out = driver.entry(inp)
        t1 = time.perf_counter()
    with span("bench.readback"):
        result = driver.readback(out)
        t2 = time.perf_counter()
    return Record(t0, t1, t2), inp, out, result


class Window(typing.NamedTuple):
    records: list
    window_s: float
    failed: int


def window(driver, seconds: float, first: int = 0) -> Window:
    """Calls from ``first`` on, back to back, each started within
    ``seconds`` of the window's start; the window ends when the last
    result is on the host.  A call whose result is not finite counts as
    failed."""
    records, failed = [], 0
    i = first
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < seconds:
        rec, inp, out, result = one_call(driver, i)
        records.append(rec)
        failed += not all(math.isfinite(v) for v in result)
        driver.keep(i, inp, out)
        i += 1
    return Window(records, records[-1].done - t_start, failed)
