"""The harness of the port's benchmark: what every cell shares.

``bench`` runs one cell once (``portbench/run.py``); ``spec`` finds a
cell's files by the names in ``BENCHMARK.json``; ``weights`` makes the
weights and inputs from the seed; ``spans`` times the port's layer calls
with CUDA events; ``profile`` reads a ``torch.profiler`` window; ``cost``
counts a model's FLOPs and a payload's bytes from shapes alone.
"""
