"""PyTorch/CUDA port of the ``repro`` package.

Mirrors ``src/repro/`` module for module; each ported file names its
JAX counterpart.  Imports ``torch``, numpy and the standard library
only.  Entry points run on ``cuda`` unless the caller asks for the CPU.
"""
import numpy as np
import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """The device an entry point runs on.

    ``"cpu"`` is taken as asked.  Anything else needs CUDA: without it
    this raises instead of carrying on quietly on the CPU.
    """
    dev = torch.device(name)
    if dev.type != "cpu" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but CUDA is not available; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    return dev


def generator(device, *seeds: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from a tuple of ints
    (numpy's ``SeedSequence`` mixes them): the port's ``fold_in``.  Where
    the JAX package derives a key per (seed, rank) or (seed, step), the
    port seeds a generator from the same tuple."""
    seed = np.random.SeedSequence(list(seeds)).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(seed[0]))
