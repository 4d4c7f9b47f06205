"""DCQCN congestion control on torch tensors (port of
``repro/core/transport/dcqcn.py``: the state, the update rule and the
calm-gap ramp).

All four simulated NIC designs keep DCQCN in hardware (paper Table I).
ECN-marked packets trigger CNPs; the sender cuts its rate
multiplicatively by alpha/2 and tracks a congestion estimate alpha;
absent CNPs the rate recovers via additive, then hyper, increase stages.

The recurrence is only data-dependent at steps where some flow receives
a CNP; between CNPs it is a deterministic ramp with a closed form
(:func:`calm_ramp`).  The whole-trace evaluation (``rate_trace`` in the
JAX package) is the DCQCN scan kernel here (``kernels/csrc/dcqcn.cu``)
and its plain version ``kernels.ref.dcqcn_scan``, which builds on the two
functions below.  Each function is one torch op per line, so a CUDA
kernel that does the same operations in the same order, without FMA
contraction, gets the same bits.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.transport.params import DcqcnParams


@dataclasses.dataclass
class DcqcnState:
    rate: torch.Tensor        # (..., n_flows) float64, fraction of line rate
    target: torch.Tensor      # float64
    alpha: torch.Tensor       # float64
    good_stages: torch.Tensor  # int32, consecutive no-CNP stages

    @classmethod
    def init(cls, shape, device="cpu") -> "DcqcnState":
        def ones():
            return torch.ones(shape, dtype=torch.float64, device=device)
        return cls(rate=ones(), target=ones(), alpha=ones(),
                   good_stages=torch.zeros(shape, dtype=torch.int32,
                                           device=device))


def step_math(r, t, a, g, cnp_received, p: DcqcnParams):
    """One control interval's update rule on float64 state tensors (``g``
    int32).  Returns ``(rate, target, alpha, good_stages)``."""
    # --- congestion: multiplicative decrease, alpha <- EWMA toward 1
    decayed = (1 - p.alpha_g) * a
    a_new = torch.where(cnp_received, decayed + p.alpha_g, decayed)
    t_new = torch.where(cnp_received, r, t)
    r_cut = torch.clamp(r * (1 - a_new / 2), min=p.rate_decrease_floor)

    # --- recovery: additive toward target, hyper after sustained calm
    g_new = torch.where(cnp_received, 0, g + 1)
    add = torch.minimum(t_new, r + p.additive_increase)
    hyper = torch.clamp(r + p.hyper_increase, max=1.0)
    r_up = torch.where(g_new > p.hyper_after, hyper, add)

    rate = torch.clamp(torch.where(cnp_received, r_cut, r_up),
                       p.min_rate, 1.0)
    return rate, torch.clamp(t_new, p.min_rate, 1.0), a_new, g_new


def calm_ramp(r, t, g, i, p: DcqcnParams):
    """Recovery-ramp rate after ``i`` consecutive no-CNP updates.

    ``r``/``t`` float32 or float64 (the result has their dtype), ``g``
    and ``i`` int32.  The first ``k = clip(hyper_after - g, 0, i)``
    updates are additive toward ``t``, the rest hyper toward 1.0; each
    is a saturating ramp, so a min gives the exact per-step value.  The
    engine evaluates it twice a step: in float32 for the emitted trace
    and in float64 to advance the state.
    """
    k = torch.minimum(torch.clamp(p.hyper_after - g, min=0), i)
    kf = k.to(r.dtype)
    # invariant: k > 0 implies r <= t (hyper is the only way past target,
    # and it requires good_stages > hyper_after, i.e. k == 0)
    r_add = torch.where(k > 0,
                        torch.minimum(t, r + p.additive_increase * kf), r)
    hyper = torch.clamp(r_add + p.hyper_increase * (i - k).to(r.dtype),
                        max=1.0)
    return torch.where(i > k, hyper, r_add)
