"""Host training loop: data, Celeris timeout coupling, checkpoint/restart
(port of ``repro/train/trainer.py``).

- **checkpoint/restart**: atomic checkpoints every ``ckpt_every`` steps
  (async: the leaves are copied to the host, then written on a
  background thread, overlapped with the next steps); on start the
  trainer resumes from ``LATEST`` automatically, adopting the saved
  timeout.  Checkpoints hold the whole leaves in JAX's format, so a job
  restarts elastically on another mesh (``Trainer(..., mesh=new_mesh)``)
  and either package restores the other's.  The numpy ``rng`` is not
  saved, in either package: a resumed lossy run draws its drop rates
  from the seed again.
- **straggler mitigation** is the paper's mechanism: each step's
  collective is bounded by the timeout controller; the realized
  received fraction feeds back into the controller (EWMA + cluster
  median), and late data is dropped and recovered by the Hadamard
  pipeline.  A ``straggler_model`` maps the current timeout to a drop
  probability via the transport latency distribution.
- **data restart safety**: batches are pure functions of (seed, step,
  shard).  A batch holds the pipeline's tokens and labels alone, so a
  modality stub trains on text, as under the JAX trainer.

The host draws (straggler bursts, emulated latencies, coordination
noise) come from the same numpy generator as in JAX, in the same order.
The step's JAX key becomes a generator seeded from (seed, step).

With a ``mesh`` (a DeviceMesh) the trainer runs one rank: every rank
builds it together, initializes the same weights from the same seed and
keeps its shards of them on a ``model`` axis (checked once against the
first dp rank's, bit for bit) and its ZeRO-1 slices of the optimizer
state on a ``data`` axis, draws the same drop rates and step
generators, and feeds the step its own rows of the batch, those the JAX
package's dp-sharded ``device_put`` gives its shard, the same on every
model rank.  The timeout coordination stays the JAX trainer's emulated
8-node host median, so the numbers stay the JAX package's.  A checkpoint
is gathered by every rank together (``convert.gather_state``) and
written by global rank 0 alone; then the ranks meet at a barrier, so no
rank reads ``LATEST`` before it exists.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import time
from math import erf
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import generator, resolve_device
from repro_torch import sharding as shd
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.base import ModelConfig
from repro_torch.core import timeout as timeout_mod
from repro_torch.data import pipeline as data_pipe
from repro_torch.models import convert
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
                 ckpt_every: int = 50,
                 seed: int = 0,
                 straggler: Optional[StragglerModel] = None,
                 device: str = "cuda"):
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
        self.mesh = mesh
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        # the trainer owns its state: each step updates the optimizer
        # state in place (donated, as the JAX trainer's step is)
        self.step_fn = ts.make_train_step(cfg, mesh, self.opt_cfg,
                                          self.celeris, donate=True)
        self.names = convert.leaf_names(cfg)
        self.state = ts.init_state(generator(self.device, seed), cfg, mesh)
        dp = shd.dp_axes(mesh)
        if dp:
            self.shard = (shd.peer_index(mesh, dp), shd.axis_size(mesh, dp))
            ts.check_replicated(self.state["params"], self.step_fn.dp_group)
        else:
            self.shard = None
        self.start_step = 0
        self._pending_ckpt = None
        if ckpt_dir is not None and ckpt.latest_step(ckpt_dir) is not None:
            self.restore()

    def _specs(self):
        """Each state leaf's partition spec on this trainer's mesh, in
        ``ts.state_leaves`` order (None without a mesh)."""
        if self.mesh is None:
            return None
        specs = ts.state_specs(convert.leaf_shapes(self.cfg), self.mesh,
                               self.names)
        return [s for _, s in ts.state_leaves(specs, self.names)]

    def restore(self):
        """Load ``LATEST`` from ``ckpt_dir``, this rank's blocks of it on a
        mesh, and adopt its timeout."""
        leaves, step, extra = ckpt.restore(
            self.ckpt_dir, ts.state_leaves(self.state, self.names),
            shardings=self._specs(), mesh=self.mesh)
        self.state = ts.state_from_leaves(leaves)
        self.start_step = int(step)
        if "timeout" in (extra or {}):
            self.controller.adopt(extra["timeout"])

    def _save(self, step: int):
        """Checkpoint the state as of ``step`` (after the previous save
        is durable): every rank gathers the whole leaves together, global
        rank 0 copies them to the host and writes them in the
        background."""
        self._wait_ckpt()
        named = ts.state_leaves(self.state, self.names)
        extra = {"timeout": self.controller.timeout, "arch": self.cfg.name}
        if self.mesh is None:
            self._pending_ckpt = ckpt.save_async(self.ckpt_dir, step, named,
                                                 extra)
            return
        writer = dist.get_rank() == 0
        host = []
        wholes = convert.gather_state([x for _, x in named], self._specs(),
                                      self.mesh)
        for (path, _), full in zip(named, wholes):
            if writer:
                host.append((path, full.cpu()))
        done = cf.Future()
        done.set_result(None)
        self._pending_ckpt = (ckpt.save_async(self.ckpt_dir, step, host,
                                              extra) if writer else done)

    def _wait_ckpt(self):
        """Wait until the pending checkpoint is written; on a mesh every
        rank then meets at a barrier."""
        if self._pending_ckpt is None:
            return
        self._pending_ckpt.result()
        self._pending_ckpt = None
        if self.mesh is not None:
            dist.barrier()

    def put_batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The step's batch, or on a mesh this rank's rows of it:
        ``shard_batch(step, peer, n_shards)`` with ``peer`` the rank's
        row-major index over the dp axes, the same on every model rank
        (so the world's rows together are ``global_batch(step,
        n_shards)``, not ``global_batch(step)``)."""
        host = (self.source.global_batch(step) if self.shard is None
                else self.source.shard_batch(step, *self.shard))
        return {k: torch.as_tensor(v, dtype=torch.long, device=self.device)
                for k, v in host.items()}

    def step_generator(self, step: int) -> torch.Generator:
        return generator(self.device, self.seed, step)

    def run(self, n_steps: int,
            on_metrics: Optional[Callable[[int, Dict], None]] = None,
            simulate_fault_at: Optional[int] = None) -> Dict[str, list]:
        """Train ``n_steps`` from the current position.

        ``simulate_fault_at``: raise after that step (once its checkpoint,
        if any, is written) to exercise checkpoint/restart.
        """
        history: Dict[str, Any] = {"loss": [], "nll": [], "recv_frac": [],
                                   "drop_rate": [], "timeout": []}
        for step in range(self.start_step, self.start_step + n_steps):
            batch = self.put_batch(step)
            if self.celeris.collective_mode().lossy or self.celeris.lossy_moe:
                # a float for the flat modes; the axis vector of a
                # HierStragglerModel in hierarchical mode
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

            if self.ckpt_dir and (step + 1) % self.ckpt_every == 0:
                self._save(step + 1)

            if simulate_fault_at is not None and step == simulate_fault_at:
                self._wait_ckpt()
                raise RuntimeError(f"simulated node failure at step {step}")

        self._wait_ckpt()
        self.start_step += n_steps
        return history
