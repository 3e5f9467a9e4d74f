"""Utilities: the program's spans, timing and profiling on the card, host
synchronisations."""

from tpuslam_torch.utils.profiling import (HostSyncs, count_host_syncs,
                                           device_ms, profile_window, span,
                                           timed)

__all__ = ["HostSyncs", "count_host_syncs", "device_ms", "profile_window",
           "span", "timed"]
