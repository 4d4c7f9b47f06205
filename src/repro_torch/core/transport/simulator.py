"""Cluster-scale collective simulator (port of
``repro/core/transport/simulator.py``: paper §IV setup, a 128-node Clos,
25 MB AllReduce rounds, randomized bursty background contention).

Ring AllReduce = 2(N-1) synchronized steps; each step, node i sends one
chunk (M/N bytes) to its ring successor.  The *step* completes when the
slowest transfer completes (global synchronization, the tail-at-scale
amplifier), so

    round_time = sum_s  max_i  t[s, i]        (reliable designs)
    round_time = sum_s  min(max_i t[s, i], step_timeout)   (Celeris)

A thin facade over :class:`~repro_torch.core.transport.engine.
BatchedEngine` on ``device``, in its default legacy-stream mode: the
sequential simulator's seeded streams replayed, the mode of the
committed Fig.-2 numbers.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.core.transport.engine import BatchedEngine, RoundStats
from repro_torch.core.transport.params import SimParams

__all__ = ["CollectiveSimulator", "RoundStats"]


class CollectiveSimulator:
    def __init__(self, params: SimParams | None = None, *,
                 device: str = "cuda"):
        self.p = params or SimParams()
        self._engine = BatchedEngine(self.p, device=device)

    def run(self, design: str, n_rounds: int = 400, *,
            celeris_timeout_us: float | None = None,
            adaptive: bool = True, window: str = "round",
            seed: int | None = None) -> RoundStats:
        """Simulate ``n_rounds`` AllReduce rounds for one NIC design.

        ``celeris_timeout_us``: initial round timeout (the paper's Fig.-2
        protocol fixes it to median + 1 sigma of the baseline with
        ``adaptive=False``); when ``adaptive`` the timeout controller
        refines it per round from (duration, received fraction) with
        cluster-median coordination.  ``window``: ``"round"`` bounds the
        whole collective (paper semantics); ``"step"`` bounds each ring
        step (beyond-paper; adaptive Celeris runs in the shared-fabric
        mode, as ``BatchedEngine.run`` decides).
        """
        return self._engine.run(design, n_rounds,
                                celeris_timeout_us=celeris_timeout_us,
                                adaptive=adaptive, window=window, seed=seed)

    def paper_protocol(self, n_rounds: int = 400, seed: int = 0
                       ) -> Dict[str, RoundStats]:
        """The paper's Fig.-2 protocol: run the RoCE baseline, set the
        Celeris window to baseline median + 1 sigma, run everything."""
        return self._engine.paper_protocol(n_rounds, seed)
