"""Transport-to-ML coupling.  The transport engine arrives in a later slice."""
