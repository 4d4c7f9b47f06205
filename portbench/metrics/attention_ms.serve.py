"""Device ms a request in the port's attention (models/layers.attention: dense
or tiled), from its span."""
from portbench.harness import readers


def read(ctx):
    return readers.span_ms(ctx, "attention")
