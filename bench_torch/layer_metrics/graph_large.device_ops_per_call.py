"""Device operations a call: those that start between the host entering
``graph_solve_banded`` and the result on the host, over the traced
segment's calls (the inputs' draws, done before the entry, are left
out)."""

from benchlib import calls


def read(ctx):
    if ctx.trace is None:
        return None
    wins = calls.windows(ctx.trace)
    if not wins:
        return None
    return sum(len(calls.ops_in(ctx.trace, w)) for w in wins) / len(wins)
