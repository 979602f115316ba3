"""Architecture registry.

Counterpart of ``repro/configs/__init__.py``: ``get_config(arch_id)`` (the
published full-size config), ``get_reduced(arch_id)`` (a 1-2 super-block,
narrow variant of the same family for CPU tests) and ``list_archs()``. The
port carries the pool without MoE and MLA: gemma2-2b, codeqwen1.5-7b,
qwen3-14b, granite-34b, internvl2-1b, musicgen-large, mamba2-1.3b and
zamba2-7b, and the paper's CNN (``celeba-cnn``, whose ``CONFIG`` and
``REDUCED`` are None, as in the reference). MoE and MLA (ROADMAP queue A
item 14c.4) raise ``NotImplementedError`` naming their item, never a
silent substitute.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

# the reference's ids in its order
_ARCHS = ("qwen3-moe-235b-a22b", "granite-34b", "codeqwen1.5-7b",
          "musicgen-large", "qwen3-14b", "gemma2-2b", "internvl2-1b",
          "mamba2-1.3b", "deepseek-v3-671b", "zamba2-7b", "celeba-cnn")
_MODULES = {
    "granite-34b": "repro_torch.configs.granite_34b",
    "codeqwen1.5-7b": "repro_torch.configs.codeqwen15_7b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "internvl2-1b": "repro_torch.configs.internvl2_1b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_13",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
    "celeba-cnn": "repro_torch.configs.celeba_cnn",
}
# the ROADMAP queue A item that ports each of the others
_UNPORTED = {"qwen3-moe-235b-a22b": "14c.4", "deepseek-v3-671b": "14c.4"}


def list_archs(include_cnn: bool = False) -> List[str]:
    """Every architecture id of the pool (the reference's list), ported or
    not; ``include_cnn`` adds the paper's CNN."""
    return [a for a in _ARCHS if include_cnn or a != "celeba-cnn"]


def _module(arch_id: str):
    if arch_id not in _ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCHS)}")
    if arch_id not in _MODULES:
        raise NotImplementedError(
            f"{arch_id!r} is not ported yet (ROADMAP queue A item "
            f"{_UNPORTED[arch_id]}); the port has {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[arch_id])


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_reduced(arch_id: str) -> ModelConfig:
    return _module(arch_id).REDUCED
