"""Device ms a request in the KV ship (serve_step.degrade_caches:
coding.encode, loss, decode), from its span."""
from portbench.harness import readers


def read(ctx):
    return readers.span_ms(ctx, "kv_ship")
