"""Architecture registry: every architecture of the JAX package, the
dense ones (qwen2-0.5b, gemma2-9b, chatglm3-6b, nemotron-4-15b), the MoE
ones (qwen2-moe-a2.7b, granite-moe-3b-a800m), the recurrent ones
(recurrentgemma-9b, xlstm-350m) and the modality stubs
(phi-3-vision-4.2b, seamless-m4t-medium)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (
    ModelConfig, MoEConfig, ShapeConfig, SHAPES, runnable_shapes)

ARCHS = ("qwen2_0_5b", "gemma2_9b", "chatglm3_6b", "nemotron_4_15b",
         "qwen2_moe_a2_7b", "granite_moe_3b_a800m", "recurrentgemma_9b",
         "xlstm_350m", "phi_3_vision_4_2b", "seamless_m4t_medium")


def canonical(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def _module(name: str):
    if canonical(name) not in ARCHS:
        raise ValueError(f"{name!r} is not an architecture ({ARCHS})")
    return importlib.import_module(f"repro_torch.configs.{canonical(name)}")


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return _module(name).SMOKE


__all__ = ["ModelConfig", "MoEConfig", "ShapeConfig", "SHAPES", "ARCHS",
           "runnable_shapes", "get", "get_smoke", "canonical"]
