"""Model FLOPs of the window's train steps over its time, % of the card's bf16
peak (harness/cost.py)."""
from portbench.harness import readers


def read(ctx):
    return readers.mfu(ctx)
