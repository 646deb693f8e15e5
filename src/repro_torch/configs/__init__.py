"""Architecture registry: ``--arch <id>`` resolves here (the port's copy of
``repro.configs``'s registry)."""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

# arch id -> module path (ids are the reference's exact spellings)
_ARCH_MODULES: Dict[str, str] = {
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    "phi3-medium-14b": "repro_torch.configs.phi3_medium_14b",
    "smollm-135m": "repro_torch.configs.smollm_135m",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "mamba2-2.7b": "repro_torch.configs.mamba2_2p7b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "jamba-1.5-large-398b": "repro_torch.configs.jamba_1p5_large_398b",
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
    "whisper-base": "repro_torch.configs.whisper_base",
}

ARCH_IDS: Tuple[str, ...] = tuple(_ARCH_MODULES)


def get_config(arch_id: str, reduced: bool = False) -> ModelConfig:
    if arch_id not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(_ARCH_MODULES[arch_id])
    return mod.REDUCED if reduced else mod.CONFIG


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "ARCH_IDS", "get_config"]
