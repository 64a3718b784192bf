"""Architecture registry of the port: the architectures ported so far, each
citing its source (the PyTorch port of ``repro.configs``).

``get_config(arch_id)`` returns the full production config;
``get_smoke_config(arch_id)`` the reduced same-family variant used by the
CPU tests.  An architecture of the zoo whose family is not ported yet raises
``KeyError`` naming it as such.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

# canonical id -> module name (the dense decoder, SSM and hybrid families)
_ARCHS = {
    "granite-34b": "granite_34b",
    "granite-20b": "granite_20b",
    "nemotron-4-340b": "nemotron_4_340b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "mamba2-780m": "mamba2_780m",
    "zamba2-2.7b": "zamba2_2_7b",
}

# The rest of the reference's zoo, whose families come with later slices.
_NOT_YET_PORTED = (
    "whisper-medium", "chameleon-34b", "qwen2-moe-a2.7b", "mixtral-8x22b",
)


def list_archs() -> List[str]:
    return list(_ARCHS)


def _module(arch_id: str):
    if arch_id in _NOT_YET_PORTED:
        raise KeyError(
            f"arch {arch_id!r} is not yet ported to repro_torch; ported: {list_archs()}"
        )
    if arch_id not in _ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list_archs()}")
    return importlib.import_module(f"repro_torch.configs.{_ARCHS[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE
