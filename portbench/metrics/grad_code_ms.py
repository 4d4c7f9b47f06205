"""Device ms a step in the coded sync (train_step._draw and _code_grads), from
its span."""
from portbench.harness import readers


def read(ctx):
    return readers.span_ms(ctx, "grad_code")
