"""Filters x particles x steps of every rollout of the window, over the
window's seconds."""

from benchlib.readers import rate as read  # noqa: F401
