"""Transport coupling (port of ``repro/core/transport/coupling.py``):
``kv_hole_masks`` (delivered KV fractions -> per-request hole masks),
``CollectiveMode`` (the switch the train step dispatches on) and
``MAX_DROP``.

numpy and the standard library, copied as they are, so the masks are
bit-identical to the JAX package's.  ``DropSchedule`` and
``schedule_from_engine`` arrive with the transport engine's slice.
"""
from __future__ import annotations

import enum

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


class CollectiveMode(enum.Enum):
    """Gradient-sync collective flavor for the train step.

    - ``EXACT``: lossless all-reduce (RoCE-like semantics, the baseline);
    - ``LOSSY``: best-effort without coding: a wire row that misses the
      receiver's bounded window is a hole in the raw gradient;
    - ``LOSSY_HADAMARD``: best-effort + randomized-Hadamard coding, the
      paper's recovery path, unbiased even through holes;
    - ``HIERARCHICAL``: exact intra-pod, coded lossy cross-pod (the port
      does not run this mode yet).
    """
    EXACT = "exact"
    LOSSY = "lossy"
    LOSSY_HADAMARD = "lossy_hadamard"
    HIERARCHICAL = "hierarchical"

    @classmethod
    def parse(cls, mode: "CollectiveMode | str") -> "CollectiveMode":
        if isinstance(mode, cls):
            return mode
        key = str(mode).lower().replace("+", "_").replace("-", "_")
        for m in cls:
            if m.value == key:
                return m
        raise ValueError(f"unknown collective mode {mode!r}; choose from "
                         f"{[m.value for m in cls]}")

    @property
    def lossy(self) -> bool:
        return self is not CollectiveMode.EXACT

    @property
    def coded(self) -> bool:
        return self in (CollectiveMode.LOSSY_HADAMARD,
                        CollectiveMode.HIERARCHICAL)

    @property
    def hierarchical(self) -> bool:
        return self is CollectiveMode.HIERARCHICAL


# The collectives emulate loss at wire-chunk granularity; a drop rate
# past ~0.5 means the window is mis-tuned, not a tail event, and the
# unbias factors blow up variance: clamp like the trainer's model does.
MAX_DROP = 0.5
