"""Device ms a step in optim/adamw.apply_updates, from its span."""
from portbench.harness import readers


def read(ctx):
    return readers.span_ms(ctx, "adamw")
