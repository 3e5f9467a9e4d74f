"""Utilities: timing on the card."""

from tpuslam_torch.utils.profiling import steps_per_second, timed

__all__ = ["steps_per_second", "timed"]
