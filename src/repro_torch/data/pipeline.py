"""Deterministic synthetic data pipeline (shardable, restart-safe).

Port of ``repro/data/pipeline.py``: numpy, copied as it is, so the
batches are bit-identical to the JAX package's.

Two sources:

- :class:`MarkovLM` — a fixed random bigram/trigram process with
  Zipf-distributed marginals.  It has real learnable structure (a model
  that learns the transition table drops loss well below the unigram
  entropy), which is what the Fig.-1 loss-tolerance benchmark needs.
- :class:`UniformTokens` — i.i.d. tokens for shape/throughput tests.

Determinism/sharding contract: batch ``step`` on shard ``(i of n)`` is a
pure function of (seed, step, i, n) — any node can regenerate any shard
after a restart (no data-state checkpointing needed), and the global
batch is identical regardless of topology (elastic re-sharding safe).
Batches are laid out host-side as numpy; the trainer copies them to
the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "markov"     # "markov" | "uniform"
    branching: int = 16      # candidate successors per token (markov)


class MarkovLM:
    """Fixed sparse bigram process with Zipfian stationary bias."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v, b = cfg.vocab_size, cfg.branching
        # successors per token + their (unnormalized Zipf) weights
        self.succ = rng.integers(0, v, size=(v, b))
        w = 1.0 / np.arange(1, b + 1) ** 1.2
        self.probs = (w / w.sum()).astype(np.float64)

    def bigram_entropy(self) -> float:
        return float(-(self.probs * np.log(self.probs)).sum())

    def _gen(self, rng: np.random.Generator, batch: int) -> np.ndarray:
        v, s = self.cfg.vocab_size, self.cfg.seq_len
        out = np.empty((batch, s), dtype=np.int32)
        out[:, 0] = rng.integers(0, v, size=batch)
        for t in range(1, s):
            pick = rng.choice(self.cfg.branching, size=batch, p=self.probs)
            out[:, t] = self.succ[out[:, t - 1], pick]
        return out

    def shard_batch(self, step: int, shard: int, n_shards: int) -> dict:
        assert self.cfg.global_batch % n_shards == 0
        rng = np.random.default_rng(
            (self.cfg.seed, step, shard, n_shards))
        toks = self._gen(rng, self.cfg.global_batch // n_shards)
        return {"tokens": toks, "labels": toks}

    def global_batch(self, step: int, n_shards: int = 1) -> dict:
        shards = [self.shard_batch(step, i, n_shards) for i in range(n_shards)]
        return {k: np.concatenate([s[k] for s in shards])
                for k in shards[0]}


class UniformTokens:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def shard_batch(self, step: int, shard: int, n_shards: int) -> dict:
        rng = np.random.default_rng((self.cfg.seed, step, shard, n_shards))
        toks = rng.integers(0, self.cfg.vocab_size,
                            size=(self.cfg.global_batch // n_shards,
                                  self.cfg.seq_len), dtype=np.int32)
        return {"tokens": toks, "labels": toks}

    def global_batch(self, step: int, n_shards: int = 1) -> dict:
        shards = [self.shard_batch(step, i, n_shards) for i in range(n_shards)]
        return {k: np.concatenate([s[k] for s in shards])
                for k in shards[0]}


def make_source(cfg: DataConfig):
    return MarkovLM(cfg) if cfg.kind == "markov" else UniformTokens(cfg)
