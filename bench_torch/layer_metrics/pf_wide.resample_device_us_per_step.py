"""Device microseconds a step in the wide resample's kernels: K5a's
boundary pass and the segmented expand (or the segmented K3c and K3d
under ``pass2="compressed"``), from the traced segment's kernel events,
over its calls' steps."""

KERNELS = ("wide_boundary_kernel", "expand_seg_kernel", "compact_kernel",
           "compressed_window_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    times = ctx.trace.kernel_times(*KERNELS)
    if not times:
        return None
    return 1e6 * sum(times) / (ctx.trace.calls * ctx.traffic["steps"])
