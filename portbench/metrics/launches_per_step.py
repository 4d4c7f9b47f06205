"""Device operations launched a profiled train step (kernels, copies and
fills)."""
from portbench.harness import readers


def read(ctx):
    return readers.launches(ctx)
