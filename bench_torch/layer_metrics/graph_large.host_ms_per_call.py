"""Host milliseconds a call inside ``graph_solve_banded`` outside its
blocking reads, the mean over the window's calls: the entry's time from
entering it to its return, less the time the program's
``slam/large.py::sync_wait_s`` counts in its host reads (the edge
grouping's and one a GN pass, where the host waits for the device).  What
is left is the host's own work: the launches of the grouping, the terms,
the factor and every GN pass.  The driver's ``counts()`` lists each call's
in the order they ran: the warm-up call first, then the window's (the
traced calls after them run under the profiler, which slows each launch,
and are left out).  None where the program has no such counter."""


def read(ctx):
    calls = ctx.counts.get("host_ms_calls")
    if not calls:
        return None
    window = calls[1:1 + len(ctx.records)]
    return sum(window) / len(window)
