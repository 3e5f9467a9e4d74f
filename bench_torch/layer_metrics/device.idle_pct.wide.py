"""The wide PF's device idle share: the part of the traced segment in
which no operation ran on the device (the wide loop's host path between
its launches, the inputs' draws, the readback), in percent."""

from benchlib.readers import idle_pct as read  # noqa: F401
