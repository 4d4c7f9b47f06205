"""Device ms a step in models/moe.moe_block, forward, recompute and backward,
from its span."""
from portbench.harness import readers


def read(ctx):
    return readers.span_ms(ctx, "moe")
