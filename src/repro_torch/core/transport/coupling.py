"""Serve-path coupling (port of ``repro/core/transport/coupling.py``,
``kv_hole_masks`` only): delivered KV fractions -> per-request hole masks.

numpy, copied as it is, so the masks are bit-identical to the JAX
package's.  ``DropSchedule`` and ``schedule_from_engine`` arrive with the
transport engine's slice.
"""
from __future__ import annotations

import numpy as np

# seeded substream id of the KV hole masks (``repro/serve/traffic.py``)
STREAM_KV_HOLES = 162


def kv_hole_masks(kv_frac: np.ndarray, n_rot: int, seed: int = 0
                  ) -> np.ndarray:
    """Seeded per-request wire-row arrival masks for KV-cache shipping.

    Turns each request's delivered KV fraction into a ``(n_req, n_rot)``
    boolean mask over wire rows.  Row ``j`` arriving means coordinate
    ``j`` of every Hadamard rotation block survived the window
    (``core.coding``'s wire layout).

    Masks are Bernoulli(kv_frac) per row on the seeded
    ``STREAM_KV_HOLES`` substream.  Requests with ``kv_frac == 1`` get
    all-true masks (the draw is still consumed, keeping masks
    per-request reproducible regardless of which other requests were cut).
    """
    kv_frac = np.asarray(kv_frac, dtype=float)
    rng = np.random.default_rng([seed, STREAM_KV_HOLES])
    u = rng.random((kv_frac.size, n_rot))
    return u < kv_frac[:, None]
