"""Architecture registry.  The port carries the llama-family configs, dense
and MoE; the reference's other architectures raise ``NotImplementedError``
naming the ROADMAP item that ports them."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (ArchConfig, AttnSpec, BlockSpec,
                                      StageSpec)

_ARCH_MODULES = {
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "qwen2-7b": "repro_torch.configs.qwen2_7b",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "grok-1-314b": "repro_torch.configs.grok_1_314b",
}

# the reference's other configs, and the ROADMAP item that ports each
_NOT_PORTED = {
    "xlstm-125m": "Queue A, item 10 (models/recurrent.py)",
    "recurrentgemma-2b": "Queue A, item 10 (models/recurrent.py)",
    "minicpm3-4b": "Queue A, item 10 (MLA attention)",
    "llama-3.2-vision-11b": "Queue A, item 10 (cross attention)",
    "whisper-base": "Queue A, item 10 (encoder models)",
}


def get_config(name: str) -> ArchConfig:
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"config {name!r} is not ported yet: ROADMAP.md "
            f"{_NOT_PORTED[name]}")
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[name]).CONFIG


__all__ = ["ArchConfig", "AttnSpec", "BlockSpec", "StageSpec", "get_config"]
