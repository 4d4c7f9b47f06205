"""Device ms a step in train_step.accum_grads (the loss, forward and backward
with remat), from its span."""
from portbench.harness import readers


def read(ctx):
    return readers.span_ms(ctx, "fwd_bwd")
