"""Bounded delivery windows (port of ``repro/core/timeout.py``).

Celeris replaces NIC-managed reliability with software step-level
timeouts.  Per collective group:

- after each step, measure (duration, received_fraction);
- if everything arrived, track the observed duration;
- if only partial data arrived, estimate the duration needed for full
  delivery (duration / received_fraction) and aim there;
- smooth with exponential averaging and clamp to a fixed range;
- nodes exchange local estimates and all adopt the **median** for the
  next round (straggler-robust cluster coordination).

The host controller (:class:`TimeoutController`, :func:`coordinate`)
and the whole-cluster array forms (:func:`update_array`,
:func:`adopt_scalar`) are numpy, copied as they are.  The JAX package's
in-graph forms ``init_jax``/``update_jax``/``coordinate_jax`` are
tensor functions here (:func:`init_tensor`, :func:`update_tensor`) and
a median over a process group (:func:`coordinate_group`).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass
class TimeoutConfig:
    alpha: float = 0.25          # EWMA smoothing factor
    margin: float = 1.10         # headroom over the estimated full-delivery time
    min_timeout: float = 1e-4    # clamp range (seconds)
    max_timeout: float = 10.0
    init_timeout: float = 0.05
    eps: float = 1e-3            # floor on received_fraction in the estimate


@dataclasses.dataclass
class TimeoutState:
    timeout: float
    smoothed_target: float

    @classmethod
    def init(cls, cfg: TimeoutConfig) -> "TimeoutState":
        return cls(timeout=cfg.init_timeout, smoothed_target=cfg.init_timeout)


def _target(duration: float, received_fraction: float, cfg: TimeoutConfig):
    """Estimated duration for full delivery of the next step."""
    frac = max(float(received_fraction), cfg.eps)
    if frac >= 1.0:
        return duration                      # everything arrived: track observed
    return duration / frac * cfg.margin      # extrapolate to full delivery


class TimeoutController:
    """Host-side adaptive timeout for one collective group."""

    def __init__(self, cfg: TimeoutConfig | None = None):
        self.cfg = cfg or TimeoutConfig()
        self.state = TimeoutState.init(self.cfg)

    @property
    def timeout(self) -> float:
        return self.state.timeout

    def update(self, duration: float, received_fraction: float) -> float:
        cfg = self.cfg
        tgt = _target(duration, received_fraction, cfg)
        sm = (1.0 - cfg.alpha) * self.state.smoothed_target + cfg.alpha * tgt
        to = float(np.clip(sm, cfg.min_timeout, cfg.max_timeout))
        self.state = TimeoutState(timeout=to, smoothed_target=sm)
        return to

    def adopt(self, cluster_timeout: float) -> float:
        """Adopt the cluster-coordinated (median) timeout for the next round."""
        to = float(np.clip(cluster_timeout, self.cfg.min_timeout, self.cfg.max_timeout))
        self.state = TimeoutState(timeout=to, smoothed_target=self.state.smoothed_target)
        return to


def coordinate(local_timeouts: Sequence[float]) -> float:
    """Cluster coordination: all nodes adopt the median of reported values."""
    return float(np.median(np.asarray(local_timeouts)))


# ----------------------------------------------------------------------
# Vectorized (whole-cluster) forms used by the batched transport engine:
# one (n_nodes,) array replaces n TimeoutController objects.  Semantics
# match the host controller per node exactly; the property test pins it.
# ----------------------------------------------------------------------

def update_array(smoothed: np.ndarray, duration: float,
                 received_fraction: np.ndarray, cfg: TimeoutConfig
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Per-node :meth:`TimeoutController.update` over an (n,) state array.

    Returns (local_timeouts, new_smoothed) — the local timeouts are what
    each node would report for coordination.
    """
    frac = np.maximum(received_fraction, cfg.eps)
    tgt = np.where(frac >= 1.0, duration, duration / frac * cfg.margin)
    sm = (1.0 - cfg.alpha) * smoothed + cfg.alpha * tgt
    return np.clip(sm, cfg.min_timeout, cfg.max_timeout), sm


def adopt_scalar(cluster_timeout: float, cfg: TimeoutConfig) -> float:
    """:meth:`TimeoutController.adopt` for the coordinated median."""
    return float(np.clip(cluster_timeout, cfg.min_timeout, cfg.max_timeout))


# ----------------------------------------------------------------------
# In-step (tensor) forms: the state is a (timeout, smoothed_target) pair
# of float32 scalars, as in the JAX package's in-graph forms.
# ----------------------------------------------------------------------

def init_tensor(cfg: TimeoutConfig, device=None) -> torch.Tensor:
    return torch.full((2,), cfg.init_timeout, dtype=torch.float32,
                      device=device)


def update_tensor(state: torch.Tensor, duration: torch.Tensor,
                  received_fraction: torch.Tensor, cfg: TimeoutConfig
                  ) -> torch.Tensor:
    frac = torch.clamp(received_fraction, min=cfg.eps)
    tgt = torch.where(frac >= 1.0, duration,
                      torch.div(duration, frac) * cfg.margin)
    sm = (1.0 - cfg.alpha) * state[1] + cfg.alpha * tgt
    to = torch.clamp(sm, cfg.min_timeout, cfg.max_timeout)
    return torch.stack([to, sm])


def coordinate_group(local_timeout: torch.Tensor, group=None
                     ) -> torch.Tensor:
    """Median of every rank's 0-dim estimate over ``group``: an
    all-gather and a sort, the per-step estimate exchange.

    ``jnp.median``'s: at an even count the two middle values' midpoint,
    ``(low + high) * 0.5`` (``torch.median`` would return the lower).
    """
    n = dist.get_world_size(group)
    out = [torch.empty_like(local_timeout) for _ in range(n)]
    dist.all_gather(out, local_timeout.contiguous(), group=group)
    s = torch.sort(torch.stack(out).reshape(-1)).values
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5
