"""Architecture registry.  Holds the families ported so far: qwen2-0.5b."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

ARCHS = ("qwen2_0_5b",)


def canonical(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def _module(name: str):
    if canonical(name) not in ARCHS:
        raise ValueError(f"{name!r} is not ported yet (ported: {ARCHS})")
    return importlib.import_module(f"repro_torch.configs.{canonical(name)}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return _module(name).SMOKE


__all__ = ["ModelConfig", "ARCHS", "get", "get_smoke", "canonical"]
