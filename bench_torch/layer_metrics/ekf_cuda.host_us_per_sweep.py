"""Host microseconds a sweep inside ``ekf_fused_rollout``: from entering
it to its return, before the readback (checks, truth table, Philox round
keys and parameters, the launch), the mean over the window's calls."""

from benchlib.readers import host_us_per_call as read  # noqa: F401
