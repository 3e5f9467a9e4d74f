"""Host microseconds a step inside ``pf_batch_wide_rollout`` (the wide
loop: the gate's torch ops and three launches a step), from entering it
to its return, before the readback: all calls of the window over all
their steps."""

from benchlib.readers import host_us_per_step as read  # noqa: F401
