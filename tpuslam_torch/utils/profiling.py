"""Spans on the profiler's clock, timing on the card with CUDA events, and
a count of host synchronisations.

:func:`span` marks a part of the program's host path (names start
``tpuslam.``) as an event of the running ``torch.profiler`` session, on
the clock of its device events; with no profiler recording it costs one
flag check and records nothing.

:func:`timed` records an event pair on the device's current stream
around each call, so it measures the device's time from the first
enqueued operation to the last, including any gap the host leaves.
:func:`device_ms` queues many calls behind a sleep kernel, so it
measures a short kernel's device time without the host's launch gaps.
Both refuse to run without a CUDA device: a CPU time is not a device
time.

:func:`profile_window` reads one call through ``torch.profiler``: the
device's busy time against the host's wall time, the largest device-time
entries, the torch operations a step and the program's spans.

:func:`count_host_syncs` counts the operations inside a block that make
the host wait for the card (``.item()``, ``.tolist()``, a blocking copy
to or from the device), as torch's own sync debug mode reports them.
"""

from __future__ import annotations

import contextlib
import time
import warnings

import torch
import torch.autograd.profiler as _autograd_profiler

#: Every span's name starts with this.
SPAN_PREFIX = "tpuslam."

# The cheaper of torch's two recorders, where the installed torch has it;
# both put the span in the profiler's own trace.
_RECORD = getattr(torch._C._profiler, "_RecordFunctionFast",
                  torch.profiler.record_function)


# The span of a run with no profiler recording: one shared object that
# does nothing.
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that records ``name`` (``tpuslam.<layer>.<part>``) as a
    span of the running profiler, nested in the spans open around it; with
    no profiler recording, one shared object that records nothing."""
    if _autograd_profiler._is_profiler_enabled:
        return _RECORD(name)
    return _NO_SPAN


def span_totals(events) -> dict:
    """``{name: {"count", "total_ms", "self_ms"}}`` of the :func:`span`
    events among a profiler's ``events()``, largest total first.  A span's
    self time is its duration less that of the spans directly inside it.
    """
    host = sorted((e for e in events if e.name.startswith(SPAN_PREFIX)
                   and e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: (e.thread, e.time_range.start,
                                 -e.time_range.end))
    out, open_spans = {}, []
    for e in host:
        start, end = e.time_range.start, e.time_range.end
        while open_spans and (open_spans[-1][0] != e.thread
                              or open_spans[-1][1] <= start):
            open_spans.pop()
        row = out.setdefault(e.name, {"count": 0, "total_ms": 0.0,
                                      "self_ms": 0.0})
        row["count"] += 1
        row["total_ms"] += (end - start) / 1e3
        row["self_ms"] += (end - start) / 1e3
        if open_spans:
            out[open_spans[-1][2]]["self_ms"] -= (end - start) / 1e3
        open_spans.append((e.thread, end, e.name))
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["total_ms"]))


def timed(fn, *args, reps: int = 5, warmup: int = 1,
          device: torch.device | str = "cuda") -> float:
    """Median seconds of ``fn(*args)`` on ``device`` after ``warmup``
    untimed calls."""
    if not torch.cuda.is_available():
        raise RuntimeError("timed() needs a CUDA device")
    device = torch.device(device)
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize(device)
    stream = torch.cuda.current_stream(device)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        fn(*args)
        end.record(stream)
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return sorted(times)[len(times) // 2]


def device_ms(fn, reps: int) -> float:
    """Device milliseconds a call of ``fn``, from CUDA events around
    ``reps`` back-to-back calls.  A sleep kernel holds the card while
    the calls are queued, so host launch overhead does not show."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_ms() needs a CUDA device")
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


#: The runtime calls in which the host waits for the device: a copy to
#: the host (``.item()``, ``.tolist()``) and the stream synchronise
#: behind it.
_WAITS = ("cudaMemcpyAsync", "cudaStreamSynchronize")


def profile_window(call, steps: int | None = None) -> dict:
    """Where one call's time goes (``torch.profiler``, CPU and CUDA).

    Returns ``wall_ms`` (host clock around the call, synchronised),
    ``busy_ms`` (the device's own events: kernels and copies; a torch
    op's entry repeats the time of the kernels it launched, so ops are not
    summed), ``sync_ms`` (the host's time inside the runtime calls that
    wait for the device: :data:`_WAITS`, the closing synchronise left
    out), ``top`` (``(name, ms)`` of every entry with device time but
    the program's spans, largest first), ``launches`` (the host's kernel-launch calls,
    ``cudaLaunchKernel``, ``cuLaunchKernel`` and their variants) and,
    with ``steps``, ``ops_per_step``: the ``aten::`` events that no other
    ``aten::`` event encloses, over ``steps``; and ``spans``, the program's
    spans by name (:func:`span_totals`).
    """
    if not torch.cuda.is_available():
        raise RuntimeError("profile_window() needs a CUDA device")
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    busy_us = sync_us = 0.0
    for evt in prof.key_averages():
        if evt.key in _WAITS:
            sync_us += evt.cpu_time_total
        us = getattr(evt, "self_device_time_total", 0.0)
        if us > 0 and not evt.key.startswith(SPAN_PREFIX):
            by_name[evt.key] = by_name.get(evt.key, 0.0) + us
            if evt.device_type != torch.autograd.DeviceType.CPU:
                busy_us += us
    launches = sum(1 for evt in prof.events()
                   if evt.device_type == torch.autograd.DeviceType.CPU
                   and "LaunchKernel" in evt.name)
    out = {"wall_ms": wall_ms, "busy_ms": busy_us / 1e3,
           "sync_ms": sync_us / 1e3, "launches": launches,
           "top": [(k, v / 1e3) for k, v in
                   sorted(by_name.items(), key=lambda kv: -kv[1])],
           "spans": span_totals(prof.events())}
    if steps:
        n_ops = sum(1 for evt in prof.events()
                    if evt.name.startswith("aten::")
                    and (evt.cpu_parent is None
                         or not evt.cpu_parent.name.startswith("aten::")))
        out["ops_per_step"] = n_ops / steps
    return out


class HostSyncs:
    """The count :func:`count_host_syncs` fills in when its block ends."""

    count = 0


@contextlib.contextmanager
def count_host_syncs():
    """Count the synchronising CUDA operations made inside the block.

    Sets ``torch.cuda.set_sync_debug_mode("warn")`` for the block and
    counts the warnings torch raises for each synchronising operation.
    Without CUDA nothing synchronises and the count stays 0.

    Yields a :class:`HostSyncs` whose ``count`` is set when the block
    exits.
    """
    syncs = HostSyncs()
    if not torch.cuda.is_available():
        yield syncs
        return
    before = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield syncs
        finally:
            torch.cuda.set_sync_debug_mode(before)
    syncs.count = sum("synchroniz" in str(w.message) for w in seen)
