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


class MetaGenerator:
    """The generator of the meta device, which has no ``torch.Generator``:
    a draw from it (:func:`rand`, :func:`randn`, :func:`randint`) is an
    empty meta tensor of the draw's shape and dtype.  Only a dry run
    (``launch/dryrun.py``), which traces a step on meta tensors, holds
    one."""
    device = torch.device("meta")


def generator(device, *seeds: int):
    """A ``torch.Generator`` on ``device`` seeded from a tuple of ints
    (numpy's ``SeedSequence`` mixes them): the port's ``fold_in``.  Where
    the JAX package derives a key per (seed, rank) or (seed, step), the
    port seeds a generator from the same tuple.  On ``meta``: a
    :class:`MetaGenerator`."""
    if torch.device(device).type == "meta":
        return MetaGenerator()
    seed = np.random.SeedSequence(list(seeds)).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(seed[0]))


def rand(shape, generator) -> torch.Tensor:
    """``torch.rand`` of ``shape`` from ``generator``, on its device."""
    if isinstance(generator, MetaGenerator):
        return torch.empty(shape, device="meta")
    return torch.rand(shape, generator=generator, device=generator.device)


def randn(shape, generator) -> torch.Tensor:
    """``torch.randn`` of ``shape`` from ``generator``, on its device."""
    if isinstance(generator, MetaGenerator):
        return torch.empty(shape, device="meta")
    return torch.randn(shape, generator=generator, device=generator.device)


def randint(high: int, shape, generator) -> torch.Tensor:
    """``torch.randint(0, high)`` of ``shape`` from ``generator``, on its
    device."""
    if isinstance(generator, MetaGenerator):
        return torch.empty(shape, dtype=torch.int64, device="meta")
    return torch.randint(0, high, shape, generator=generator,
                         device=generator.device)


def uniform(shape, low: float, high: float, generator) -> torch.Tensor:
    """Float32 uniform [low, high) of ``shape`` from ``generator``, on
    its device (``Tensor.uniform_``)."""
    if isinstance(generator, MetaGenerator):
        return torch.empty(shape, device="meta")
    return torch.empty(shape, device=generator.device).uniform_(
        low, high, generator=generator)
