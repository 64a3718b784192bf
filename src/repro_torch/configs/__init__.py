"""Architecture registry of the port: the zoo's ten architectures, each
citing its source (the PyTorch port of ``repro.configs``).

``get_config(arch_id)`` returns the full production config;
``get_smoke_config(arch_id)`` the reduced same-family variant used by the
CPU tests.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

# canonical id -> module name, in the reference's order
_ARCHS = {
    "granite-34b": "granite_34b",
    "whisper-medium": "whisper_medium",
    "granite-20b": "granite_20b",
    "chameleon-34b": "chameleon_34b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "nemotron-4-340b": "nemotron_4_340b",
    "mixtral-8x22b": "mixtral_8x22b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "mamba2-780m": "mamba2_780m",
    "zamba2-2.7b": "zamba2_2_7b",
}


def list_archs() -> List[str]:
    return list(_ARCHS)


def _module(arch_id: str):
    if arch_id not in _ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list_archs()}")
    return importlib.import_module(f"repro_torch.configs.{_ARCHS[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE
