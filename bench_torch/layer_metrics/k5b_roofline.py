"""K5b's share of its roofline: the least time the card could take for
one launch (``roofline/k5b.py``, with the traced call's firing count,
against the H100's published peaks) over the mean launch time in the
traced segment, in percent."""


def read(ctx):
    return ctx.roofline_share("k5b")
