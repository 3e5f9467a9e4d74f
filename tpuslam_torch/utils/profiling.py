"""Timing on the card with CUDA events.

:func:`timed` records an event pair on the device's current stream
around each call, so it measures the device's time from the first
enqueued operation to the last, including any gap the host leaves.  It
refuses to run without a CUDA device: a CPU time is not a device time.
"""

from __future__ import annotations

import torch


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


def steps_per_second(fn, *args, work_items: int, reps: int = 5,
                     warmup: int = 1,
                     device: torch.device | str = "cuda") -> float:
    """``work_items`` over the median time of ``fn(*args)``."""
    return work_items / timed(fn, *args, reps=reps, warmup=warmup,
                              device=device)
