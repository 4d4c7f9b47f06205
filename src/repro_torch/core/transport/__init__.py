"""Transport engine and transport-to-ML coupling (port of
``repro/core/transport/``: the legacy-stream and shared-fabric engine
modes, flat and multi-pod, with the rate-dependent core on the card)."""
