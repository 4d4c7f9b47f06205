"""Host training loop with the Celeris timeout coupling (port of
``repro/train/trainer.py``, without checkpoints).

- **straggler mitigation** is the paper's mechanism: each step's
  collective is bounded by the timeout controller; the realized
  received fraction feeds back into the controller (EWMA + cluster
  median), and late data is dropped and recovered by the Hadamard
  pipeline.  A ``straggler_model`` maps the current timeout to a drop
  probability via the transport latency distribution.
- **data restart safety**: batches are pure functions of (seed, step,
  shard).

The host draws (straggler bursts, emulated latencies, coordination
noise) come from the same numpy generator as in JAX, in the same order.
The step's JAX key becomes a generator seeded from (seed, step).
``checkpoint.py`` is not ported yet, so a ``ckpt_dir`` raises.
"""
from __future__ import annotations

import dataclasses
import time
from math import erf
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import generator, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core import timeout as timeout_mod
from repro_torch.data import pipeline as data_pipe
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts


@dataclasses.dataclass
class StragglerModel:
    """Maps the controller's current timeout to a per-step drop rate.

    The per-chunk latency is modeled lognormal(mu, sigma) (matching the
    transport simulator's contention tails); drop = P(latency > T).
    """
    median_latency: float = 1.0       # in units of clean step time
    sigma: float = 0.6
    burst_prob: float = 0.08          # step hit by a burst
    burst_scale: float = 3.0

    def drop_rate(self, timeout: float, rng: np.random.Generator) -> float:
        med = self.median_latency
        if rng.random() < self.burst_prob:
            med *= self.burst_scale
        # P(lognormal(ln med, sigma) > timeout)
        z = (np.log(max(timeout, 1e-9)) - np.log(med)) / self.sigma
        p_late = 0.5 * (1 - erf(z / np.sqrt(2)))
        return float(np.clip(p_late, 0.0, 0.5))


class Trainer:
    def __init__(self, cfg: ModelConfig, *,
                 data_cfg: data_pipe.DataConfig,
                 opt_cfg: Optional[adamw.OptConfig] = None,
                 celeris: Optional[ts.CelerisConfig] = None,
                 mesh=None,
                 ckpt_dir: Optional[str] = None,
                 seed: int = 0,
                 straggler: Optional[StragglerModel] = None,
                 device: str = "cuda"):
        if ckpt_dir is not None:
            raise NotImplementedError("checkpoints are not ported yet")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.opt_cfg = opt_cfg or adamw.OptConfig()
        self.celeris = celeris or ts.CelerisConfig()
        self.source = data_pipe.make_source(data_cfg)
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.straggler = straggler or StragglerModel()
        self.controller = timeout_mod.TimeoutController(
            timeout_mod.TimeoutConfig(init_timeout=2.0, min_timeout=0.5,
                                      max_timeout=8.0))
        self.step_fn = ts.make_train_step(cfg, mesh, self.opt_cfg,
                                          self.celeris)
        self.state = ts.init_state(generator(self.device, seed), cfg)
        self.start_step = 0

    def put_batch(self, step: int) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, dtype=torch.long, device=self.device)
                for k, v in self.source.global_batch(step).items()}

    def step_generator(self, step: int) -> torch.Generator:
        return generator(self.device, self.seed, step)

    def run(self, n_steps: int,
            on_metrics: Optional[Callable[[int, Dict], None]] = None
            ) -> Dict[str, list]:
        """Train ``n_steps`` from the current position."""
        history: Dict[str, Any] = {"loss": [], "nll": [], "recv_frac": [],
                                   "drop_rate": [], "timeout": []}
        for step in range(self.start_step, self.start_step + n_steps):
            batch = self.put_batch(step)
            if self.celeris.collective_mode().lossy:
                drop = self.straggler.drop_rate(self.controller.timeout,
                                                self.rng)
            else:
                drop = 0.0
            t0 = time.perf_counter()
            self.state, metrics = self.step_fn(
                self.state, batch, self.step_generator(step), drop)
            metrics = {k: float(v) for k, v in metrics.items()}
            wall = time.perf_counter() - t0

            # bounded-window adaptation: the emulated step latency, with
            # dropped stragglers no longer extending it
            emu = min(self.straggler.median_latency
                      * (1 + self.rng.lognormal(0, 0.2)),
                      self.controller.timeout)
            local = self.controller.update(emu, metrics["recv_frac"])
            # cluster coordination (median of emulated node estimates)
            agreed = timeout_mod.coordinate(
                [local * (1 + self.rng.normal(0, 0.01)) for _ in range(8)])
            self.controller.adopt(agreed)

            history["loss"].append(metrics["loss"])
            history["nll"].append(metrics["nll"])
            history["recv_frac"].append(metrics["recv_frac"])
            history["drop_rate"].append(drop)
            history["timeout"].append(self.controller.timeout)
            if on_metrics:
                on_metrics(step, {**metrics, "wall_s": wall,
                                  "drop_rate": drop})
        self.start_step += n_steps
        return history
