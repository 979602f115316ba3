"""Architecture registry.

Counterpart of ``repro/configs/__init__.py``: ``get_config(arch_id)`` (the
published full-size config), ``get_reduced(arch_id)`` (a 1-2 super-block,
narrow variant of the same family for CPU tests) and ``list_archs()``. The
port carries gemma2-2b (``configs.gemma2_2b``); every other architecture
of the reference's pool is ROADMAP queue A item 14c and raises
``NotImplementedError`` saying so, never a silent substitute.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

# the reference's ids in its order; only gemma2-2b is ported
_ARCHS = ("qwen3-moe-235b-a22b", "granite-34b", "codeqwen1.5-7b",
          "musicgen-large", "qwen3-14b", "gemma2-2b", "internvl2-1b",
          "mamba2-1.3b", "deepseek-v3-671b", "zamba2-7b", "celeba-cnn")
_MODULES = {"gemma2-2b": "repro_torch.configs.gemma2_2b"}


def list_archs(include_cnn: bool = False) -> List[str]:
    """Every architecture id of the pool (the reference's list), ported or
    not; ``include_cnn`` adds the paper's CNN."""
    return [a for a in _ARCHS if include_cnn or a != "celeba-cnn"]


def _module(arch_id: str):
    if arch_id not in _ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCHS)}")
    if arch_id not in _MODULES:
        raise NotImplementedError(
            f"{arch_id!r} is not ported yet (ROADMAP queue A item 14c); the "
            f"port has {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id])


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_reduced(arch_id: str) -> ModelConfig:
    return _module(arch_id).REDUCED
