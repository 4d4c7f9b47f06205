"""The FWHT kernel's share of its HBM roofline over the profiled requests' K/V
payloads."""
from portbench.harness import readers


def read(ctx):
    return readers.fwht_roofline(ctx)
