"""DCQCN congestion control on torch tensors (port of
``repro/core/transport/dcqcn.py``: the state, the update rule and the
calm-gap ramp).

All four simulated NIC designs keep DCQCN in hardware (paper Table I).
ECN-marked packets trigger CNPs; the sender cuts its rate
multiplicatively by alpha/2 and tracks a congestion estimate alpha;
absent CNPs the rate recovers via additive, then hyper, increase stages.

The recurrence is only data-dependent at steps where some flow receives
a CNP; between CNPs it is a deterministic ramp with a closed form
(:func:`calm_ramp`).  The whole-trace evaluation is the DCQCN scan kernel
(``kernels/csrc/dcqcn.cu``) and its plain version
``kernels.ref.dcqcn_scan``, which build on :func:`step_math` and
:func:`calm_ramp`; :func:`rate_trace` runs it over one CNP trace.  Each
torch function is one op per line, so a CUDA kernel that does the same
operations in the same order, without FMA contraction, gets the same
bits.  JAX's private ``_calm_rates`` and ``_advance_calm`` have no
functions of their own here: the ramp is :func:`calm_ramp`, and the scan
advances a calm gap itself.

The host form, :class:`HostDcqcnState` and :func:`step`, is the update
rule on numpy float64 state, one call a ring step: the sequential
reference loop (``reference.py``) runs it, where a torch op a step would
cost more than the update.
"""
from __future__ import annotations

import dataclasses

import numpy as np
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


@dataclasses.dataclass
class HostDcqcnState:
    """The state of :func:`step` on the host (JAX's ``DcqcnState``)."""
    rate: np.ndarray          # (..., n_flows) float64, fraction of line rate
    target: np.ndarray
    alpha: np.ndarray
    good_stages: np.ndarray   # int, consecutive no-CNP stages

    @classmethod
    def init(cls, shape) -> "HostDcqcnState":
        return cls(rate=np.ones(shape), target=np.ones(shape),
                   alpha=np.ones(shape), good_stages=np.zeros(shape, int))


def host_step_math(r, t, a, g, cnp_received, p: DcqcnParams):
    """:func:`step_math` on numpy arrays, in the same operations."""
    # --- congestion: multiplicative decrease, alpha <- EWMA toward 1
    a_new = np.where(cnp_received, (1 - p.alpha_g) * a + p.alpha_g,
                     (1 - p.alpha_g) * a)
    t_new = np.where(cnp_received, r, t)
    r_cut = np.maximum(r * (1 - a_new / 2), p.rate_decrease_floor)

    # --- recovery: additive toward target, hyper after sustained calm
    g_new = np.where(cnp_received, 0, g + 1)
    add = np.minimum(t_new, r + p.additive_increase)
    hyper = np.minimum(1.0, r + p.hyper_increase)
    r_up = np.where(g_new > p.hyper_after, hyper, add)

    rate = np.clip(np.where(cnp_received, r_cut, r_up), p.min_rate, 1.0)
    return rate, np.clip(t_new, p.min_rate, 1.0), a_new, g_new


def step(state: HostDcqcnState, cnp_received: np.ndarray,
         p: DcqcnParams) -> HostDcqcnState:
    """One control interval on the host: CNP cuts and increases per
    flow."""
    rate, target, alpha, good = host_step_math(
        state.rate, state.target, state.alpha, state.good_stages,
        cnp_received, p)
    return HostDcqcnState(rate=rate, target=target, alpha=alpha,
                          good_stages=good)


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


def rate_trace(cnp: torch.Tensor, p: DcqcnParams,
               state: DcqcnState | None = None
               ) -> tuple[torch.Tensor, DcqcnState]:
    """The sending rate used at each step of a whole CNP trace, through
    the DCQCN scan (``kernels.ops.dcqcn_scan``: the kernel on a CUDA
    tensor, its plain version on a CPU one), in one call.

    ``cnp``: (T, ..., n_flows) bool; ``state``: the state before step 0,
    shaped ``cnp.shape[1:]`` (the initial state when None).  Returns
    ``(rates, final_state)``: ``rates[t]`` float32 is the rate before
    step t's update, as the sequential loop uses it, and the final state
    is float64 with int32 ``good_stages``.  The trace is one seed of the
    scan, ``(1, T, prod(...))``; a step is active where any flow is
    marked.
    """
    from repro_torch.kernels import ops
    T, shape = cnp.shape[0], tuple(cnp.shape[1:])
    if state is None:
        state = DcqcnState.init(shape, cnp.device)
    flat = cnp.reshape(1, T, -1).contiguous()
    rates, (r, t, a, g) = ops.dcqcn_scan(
        flat, flat.any(dim=2), *(x.reshape(1, -1).contiguous() for x in (
            state.rate, state.target, state.alpha, state.good_stages)), p)
    return rates.reshape(cnp.shape), DcqcnState(
        rate=r.reshape(shape), target=t.reshape(shape),
        alpha=a.reshape(shape), good_stages=g.reshape(shape))
