"""Architecture registry.

Counterpart of ``repro/configs/__init__.py``: ``get_config(arch_id)`` (the
published full-size config), ``get_reduced(arch_id)`` (a 1-2 super-block,
narrow variant of the same family for CPU tests) and ``list_archs()``. The
port carries the whole pool: qwen3-moe-235b-a22b, granite-34b,
codeqwen1.5-7b, musicgen-large, qwen3-14b, gemma2-2b, internvl2-1b,
mamba2-1.3b, deepseek-v3-671b and zamba2-7b, and the paper's CNN
(``celeba-cnn``, whose ``CONFIG`` and ``REDUCED`` are None, as in the
reference).
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

# the reference's ids in its order
_MODULES = {
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b",
    "granite-34b": "repro_torch.configs.granite_34b",
    "codeqwen1.5-7b": "repro_torch.configs.codeqwen15_7b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "internvl2-1b": "repro_torch.configs.internvl2_1b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_13",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "celeba-cnn": "repro_torch.configs.celeba_cnn",
}


def list_archs(include_cnn: bool = False) -> List[str]:
    """Every architecture id of the pool (the reference's list);
    ``include_cnn`` adds the paper's CNN."""
    return [a for a in _MODULES if include_cnn or a != "celeba-cnn"]


def _module(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id])


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_reduced(arch_id: str) -> ModelConfig:
    return _module(arch_id).REDUCED
