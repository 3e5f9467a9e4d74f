"""Rollouts x steps of every sweep of the window, over the window's
seconds."""

from benchlib.readers import rate as read  # noqa: F401
