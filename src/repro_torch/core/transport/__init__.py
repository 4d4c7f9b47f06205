"""Transport engine and transport-to-ML coupling (port of
``repro/core/transport/``: the shared-fabric flat-ring engine, with its
rate-dependent core on the card)."""
