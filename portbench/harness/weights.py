"""Weights and inputs made from ``--seed``, on the device.

The same seed gives the same bits: every draw comes from a
``torch.Generator`` on the device seeded from (seed, stream, ...)
through numpy's ``SeedSequence``, so a ``--seed`` of any size maps to a
64-bit generator seed.  Weights are
drawn in a few large calls (chunks of ``CHUNK`` standard normals), not
leaf by leaf, then scaled and rounded into each leaf's dtype.  The
program and the reference each call :func:`make`, and get the same
tensors.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

# streams of draws, each its own generator
WEIGHTS, DATA, SYNC, LENGTHS, SAMPLE, KV = 1, 2, 3, 4, 5, 6
CHUNK = 1 << 28


def seed_of(seed: int, *tags: int) -> int:
    state = np.random.SeedSequence([int(seed), *map(int, tags)])
    return int(state.generate_state(1, np.uint64)[0])


def generator(device, seed: int, *tags: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_of(seed, *tags))


def rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng(seed_of(seed, *tags))


def make(specs: Sequence[Dict], seed: int, device) -> List[torch.Tensor]:
    """One tensor per leaf spec (``name``, ``shape``, ``dtype``, ``std``,
    optionally ``zero``: (dim, start), the slice from ``start`` along
    ``dim`` set to 0, as padded heads are).  ``std`` 0 gives zeros."""
    g = generator(device, seed, WEIGHTS)
    out, buf, pos = [], None, 0
    for s in specs:
        t = torch.zeros(tuple(s["shape"]), dtype=getattr(torch, s["dtype"]),
                        device=device)
        out.append(t)
        if not s["std"]:
            continue
        flat, n, done = t.view(-1), t.numel(), 0
        while done < n:
            if buf is None or pos == buf.numel():
                buf = torch.randn(CHUNK, generator=g, device=device)
                pos = 0
            take = min(n - done, buf.numel() - pos)
            flat[done:done + take] = buf[pos:pos + take] * s["std"]
            done, pos = done + take, pos + take
        if "zero" in s:
            dim, start = s["zero"]
            t.narrow(dim, start, t.shape[dim] - start).zero_()
    return out


def tokens(seed: int, index: int, rows: int, cols: int, vocab: int,
           device) -> torch.Tensor:
    """(rows, cols) token ids uniform over the vocabulary, int64: the
    ``index``-th draw of the data stream."""
    g = generator(device, seed, DATA, index)
    return torch.randint(0, vocab, (rows, cols), generator=g, device=device)
