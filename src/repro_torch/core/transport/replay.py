"""Bit-exact replay of the sequential simulator's per-design draw streams
(port of ``repro/core/transport/replay.py``, numpy, copied as it is: it
consumes random streams, and its draw order is the replay contract).

The pre-refactor sequential simulator consumed one ``default_rng(seed)``
stream per design run, interleaving every draw (loss binomials,
tail-loss uniforms, CNP uniforms) step by step.  For the designs whose
consumption pattern is deterministic given the fabric trace the engine
reproduces that stream exactly:

- numpy's ``Generator.binomial`` consumes exactly one uniform per
  element when ``0 < p`` and ``n > 0`` (inversion sampling holds
  whenever ``n*p <= 30``, always true for the paper's loss model),
  and **zero** uniforms when ``p == 0`` or ``n == 0``;
- ``random(n)`` consumes ``n`` uniforms;
- the drop probability is 0 exactly whenever path occupancy is below
  the loss knee, which is known from the (bit-exact) fabric trace.

So the whole stream is one flat uniform buffer indexed by closed-form
offsets: **celeris** (per step ``[binomial(m) | cnp n]``) is fully
static; **irn/srnic** (per step ``[binomial(m1) | tail n |
binomial(m2) | cnp n]``) needs one cheap sequential pass to resolve
``m2`` (the count of first-pass losses, a threshold test on the
already-positioned uniforms) before the batched gathers.  The binomials
are sampled with an exact vectorized replica of numpy's
``random_binomial_inversion`` arithmetic.

**RoCE cannot be replayed this way**: its retry loop calls
``integers``, whose masked-rejection sampling consumes a data-dependent
number of raw words.  The engine keeps engine-native draws for RoCE
transfers, beside the bit-exact fabric replay of
:func:`network.roce_fabric_trace`.  The adaptive window controller's
per-round ``normal`` draws are not replayed either, so replay covers
``adaptive=False`` Celeris, the paper's Fig.-2 configuration.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def binomial_inversion(U: np.ndarray, n, p: np.ndarray) -> np.ndarray:
    """Exact replica of numpy's ``random_binomial_inversion`` arithmetic.

    Valid for ``n * p <= 30`` (the caller's regime); the bound-restart
    branch (probability ~1e-11 per draw) is asserted absent — hitting it
    would mean numpy consumed an extra uniform and the replay must not
    silently desynchronize.
    """
    p = np.asarray(p, dtype=np.float64)
    U = np.array(U, dtype=np.float64)
    n = np.broadcast_to(np.asarray(n), p.shape).astype(np.int64)
    q = 1.0 - p
    qn = np.exp(n * np.log(q))
    np_ = n * p
    bound = np.minimum(n, (np_ + 10.0 * np.sqrt(np_ * q + 1))).astype(np.int64)
    X = np.zeros(p.shape, dtype=np.int64)
    px = qn.copy()
    act = U > px
    while act.any():
        X[act] += 1
        if (X[act] > bound[act]).any():
            raise RuntimeError("binomial inversion bound restart — "
                               "stream replay would desynchronize")
        U[act] -= px[act]
        Xa = X[act]
        px[act] = ((n[act] - Xa + 1) * p[act] * px[act]) / (Xa * q[act])
        act = U > px
    return X


@dataclasses.dataclass
class SelectiveRepeatDraws:
    """Replayed irn/srnic draws (identical streams in the seed impl)."""
    k: np.ndarray          # (T, n) first-pass losses
    tail_lost: np.ndarray  # (T, n) bool
    k2: np.ndarray         # (T, n) second-pass losses
    cnp: np.ndarray        # (T, n) bool


@dataclasses.dataclass
class CelerisDraws:
    k: np.ndarray          # (T, n) dropped packets
    cnp: np.ndarray        # (T, n) bool


def _uniform_buffer(seed: int, total: int) -> np.ndarray:
    """The run's sim stream: one fabric-seed ``integers`` word, then
    ``total`` uniforms."""
    gen = np.random.default_rng(seed)
    gen.integers(2**31)
    return gen.random(total)


def _flat_mask_positions(mask: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """Absolute buffer position of each True entry of ``mask`` (row-major
    — numpy's elementwise order), given each row's segment start."""
    rows, cols = np.nonzero(mask)
    rank = np.arange(rows.size) - np.repeat(
        np.concatenate([[0], np.cumsum(mask.sum(axis=1))[:-1]]), mask.sum(axis=1))
    return starts[rows] + rank


def replay_selective_repeat(seed: int, n_pkts: int, drop_p: np.ndarray,
                            ecn_prob: np.ndarray) -> SelectiveRepeatDraws:
    """Replay an irn/srnic run's stream: per step
    ``[binomial(m1) | tail n | binomial(count k>0) | cnp n]``."""
    T, n = drop_p.shape
    mask = drop_p > 0
    m1 = mask.sum(axis=1)
    total_m1 = int(m1.sum())
    U = _uniform_buffer(seed, T * 2 * n + 2 * total_m1)

    msteps = np.flatnonzero(m1 > 0)
    # qn per masked entry (row-major): k > 0  <=>  U > (1-p)^n_pkts
    p_flat = drop_p[mask]
    qn_flat = np.exp(n_pkts * np.log(1.0 - p_flat))
    m1s = m1[msteps]
    ends = np.cumsum(m1s)
    qn_start = np.concatenate([[0], ends[:-1]])

    # sequential offset walk: only m2 (count of first-pass losses) makes
    # the layout data-dependent, and it is a threshold test on uniforms
    # whose positions are already known at that point.
    starts = np.empty(msteps.size, dtype=np.int64)     # k-draw block start
    m2s = np.empty(msteps.size, dtype=np.int64)
    extra = 0
    for i in range(msteps.size):
        t = msteps[i]
        ofs = 2 * n * t + extra
        starts[i] = ofs
        mi = m1s[i]
        m2 = int((U[ofs: ofs + mi]
                  > qn_flat[qn_start[i]: qn_start[i] + mi]).sum())
        m2s[i] = m2
        extra += mi + m2

    # batched gathers + one inversion call per binomial family
    k = np.zeros((T, n), dtype=np.int16)
    abs_start = np.zeros(T, dtype=np.int64)
    abs_start[msteps] = starts
    k_pos = _flat_mask_positions(mask, abs_start)
    k[mask] = binomial_inversion(U[k_pos], n_pkts, p_flat)

    tail = np.zeros((T, n), dtype=bool)
    tail_starts = starts + m1s
    tail[msteps] = (U[tail_starts[:, None] + np.arange(n)]
                    < drop_p[msteps])

    mask2 = k > 0
    k2 = np.zeros((T, n), dtype=np.int16)
    if mask2.any():
        abs2 = np.zeros(T, dtype=np.int64)
        abs2[msteps] = tail_starts + n
        k2_pos = _flat_mask_positions(mask2, abs2)
        k2[mask2] = binomial_inversion(U[k2_pos], k[mask2], drop_p[mask2])

    # CNP block: calm steps advance uniformly (2n per step) — slice
    # contiguous runs; masked steps gathered individually.
    cnp = np.zeros((T, n), dtype=bool)
    cnp_start_m = tail_starts + n + m2s
    cnp[msteps] = (U[cnp_start_m[:, None] + np.arange(n)]
                   < ecn_prob[msteps])
    _calm_cnp_runs(U, ecn_prob, cnp, msteps, T, n, stride=2 * n,
                   extra_after=np.cumsum(m1s + m2s))
    return SelectiveRepeatDraws(k=k, tail_lost=tail, k2=k2, cnp=cnp)


def _calm_cnp_runs(U, ecn_prob, cnp, msteps, T, n, stride, extra_after):
    """Fill CNPs for the calm runs between masked steps.

    A calm step consumes ``stride`` uniforms ([tail n | cnp n] for
    irn/srnic, [cnp n] for celeris) with the CNP block last, so a run of
    L calm steps is one contiguous ``(L, stride)`` slice.
    """
    bounds = np.concatenate([[-1], msteps, [T]])
    cum_extra = np.concatenate([[0], extra_after])
    for i in range(bounds.size - 1):
        a, b = int(bounds[i]) + 1, int(bounds[i + 1])
        if a >= b:
            continue
        ofs = stride * a + int(cum_extra[i])
        u = U[ofs: ofs + (b - a) * stride].reshape(b - a, stride)
        cnp[a:b] = u[:, stride - n:] < ecn_prob[a:b]


def replay_celeris(seed: int, n_pkts: int, drop_p: np.ndarray,
                   ecn_prob: np.ndarray) -> CelerisDraws:
    """Replay a celeris (adaptive=False) run: per step
    ``[binomial(m1) | cnp n]`` — the layout is fully static."""
    T, n = drop_p.shape
    mask = drop_p > 0
    m1 = mask.sum(axis=1)
    total_m1 = int(m1.sum())
    U = _uniform_buffer(seed, T * n + total_m1)

    cum_before = np.concatenate([[0], np.cumsum(m1)[:-1]])
    abs_start = n * np.arange(T) + cum_before       # k block start per step
    k = np.zeros((T, n), dtype=np.int16)
    if total_m1:
        k_pos = _flat_mask_positions(mask, abs_start)
        k[mask] = binomial_inversion(U[k_pos], n_pkts, drop_p[mask])

    cnp = np.zeros((T, n), dtype=bool)
    msteps = np.flatnonzero(m1 > 0)
    cnp_start_m = abs_start[msteps] + m1[msteps]
    if msteps.size:
        cnp[msteps] = (U[cnp_start_m[:, None] + np.arange(n)]
                       < ecn_prob[msteps])
    _calm_cnp_runs(U, ecn_prob, cnp, msteps, T, n, stride=n,
                   extra_after=np.cumsum(m1[msteps]))
    return CelerisDraws(k=k, cnp=cnp)
