"""Device operations a step of the wide loop: those that start between the
host entering ``pf_batch_wide_rollout`` and the result on the host, over
the traced segment's calls and their steps (the inputs' draws, made
before the entry, are left out; the set-up's and the readback's few
count in)."""

from benchlib import calls


def read(ctx):
    if ctx.trace is None:
        return None
    wins = calls.windows(ctx.trace)
    if not wins:
        return None
    ops = sum(len(calls.ops_in(ctx.trace, w)) for w in wins)
    return ops / (len(wins) * ctx.traffic["steps"])
