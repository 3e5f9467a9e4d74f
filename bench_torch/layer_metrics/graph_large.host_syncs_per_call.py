"""Host reads of the device in the traced call's large solve: the
program's ``slam/large.py::sync_count`` (the edge grouping's and one a
GN pass), as the driver's ``counts()`` gives it; None where the program
has no such counter."""


def read(ctx):
    return ctx.counts.get("syncs")
