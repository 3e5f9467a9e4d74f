"""K1's share of its roofline in a sweep that asks for the NEES (its NEES
form, ``roofline/k1.py`` counting the NEES's operations), over the mean
launch time in the traced segment, in percent."""


def read(ctx):
    return ctx.roofline_share("k1")
