"""Architecture registry: one module per assigned architecture, in the
reference's order."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (INPUT_SHAPES, ArchConfig, AttnSpec,
                                      BlockSpec, InputShape, MLASpec,
                                      StageSpec)

_ARCH_MODULES = {
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "llama-3.2-vision-11b": "repro_torch.configs.llama32_vision_11b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "whisper-base": "repro_torch.configs.whisper_base",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "grok-1-314b": "repro_torch.configs.grok_1_314b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
}

ARCH_NAMES = tuple(_ARCH_MODULES)


def get_config(name: str) -> ArchConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[name]).CONFIG


def all_configs() -> dict:
    return {n: get_config(n) for n in ARCH_NAMES}


__all__ = ["ArchConfig", "AttnSpec", "BlockSpec", "StageSpec", "MLASpec",
           "InputShape", "INPUT_SHAPES", "ARCH_NAMES", "get_config",
           "all_configs"]
