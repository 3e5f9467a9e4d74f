"""Host microseconds a step inside ``pf_fused_rollout`` (the single
filter's Python loop), from entering it to its return, before the
readback: all calls of the window over all their steps."""

from benchlib.readers import host_us_per_step as read  # noqa: F401
