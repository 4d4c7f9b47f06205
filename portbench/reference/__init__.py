"""The plain reference of the port's benchmark (float32 ``torch``; it
imports nothing of ``repro_torch``).  ``dense.py`` holds the shared
decoder, the coded wire and AdamW, ``moe.py`` the routed experts, and
``<arch>.py`` a configuration's leaf layout and feed-forward block."""
