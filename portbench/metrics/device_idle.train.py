"""The share of the profiled steps' window in which no device operation ran, %."""
from portbench.harness import readers


def read(ctx):
    return readers.device_idle(ctx)
