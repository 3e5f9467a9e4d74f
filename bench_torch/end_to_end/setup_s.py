"""Process start to the first timed call: imports, the CUDA context, the
kernel library's load (and its build in a fresh checkout), the truth
tables and the warm-up call at the cell's shape."""


def read(ctx):
    return ctx.setup_s
