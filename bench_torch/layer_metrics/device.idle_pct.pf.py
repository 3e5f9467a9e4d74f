"""The batched PF's device idle share: the part of the traced segment in
which no operation ran on the device, in percent."""

from benchlib.readers import idle_pct as read  # noqa: F401
