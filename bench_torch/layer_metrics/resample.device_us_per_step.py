"""Device microseconds a step in the merge resample's kernels (K3a's
boundary pass, K3b's expand, and K3c/K3d where the compressed path runs),
from the traced segment's kernel events, over its calls' steps."""

KERNELS = ("boundary_kernel", "expand_range_kernel", "compact_kernel",
           "compressed_range_kernel")


def read(ctx):
    if ctx.trace is None:
        return None
    times = ctx.trace.kernel_times(*KERNELS)
    if not times:
        return None
    return 1e6 * sum(times) / (ctx.trace.calls * ctx.traffic["steps"])
