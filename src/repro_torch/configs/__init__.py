"""Architecture registry of the port: `--arch <id>` resolves here.

Every architecture of the JAX package is listed, in its order: the dense
LMs, with global ("A") and sliding-window ("L") layers, whisper (the
enc-dec family, `models.encdec`), mamba2 (SSD layers, "S"),
recurrentgemma (RG-LRU layers, "R", with local attention), llava (a dense
LM behind the vision projector) and the MoE LMs.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.shapes import SHAPES, get_shape

_ARCHS = {
    "qwen3-8b": "qwen3_8b",
    "gemma3-12b": "gemma3_12b",
    "phi3-medium-14b": "phi3_medium_14b",
    "qwen3-0.6b": "qwen3_0_6b",
    "whisper-small": "whisper_small",
    "mamba2-2.7b": "mamba2_2_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "arctic-480b": "arctic_480b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
}

ARCH_NAMES = tuple(_ARCHS)


def get_config(name: str) -> ModelConfig:
    try:
        mod = _ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; "
                       f"available: {sorted(_ARCHS)}") from None
    return importlib.import_module(f"repro_torch.configs.{mod}").CONFIG


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "get_config", "get_shape", "ARCH_NAMES"]
