"""K2B's share of its roofline: the least time the card could take for
one launch (``roofline/k2b.py``, against the H100's published peaks) over
the mean launch time in the traced segment, in percent."""


def read(ctx):
    return ctx.roofline_share("k2b")
