"""Architecture registry of the port: `--arch <id>` resolves here.

Only the architectures the port can serve are listed: the dense LMs, with
global ("A") and sliding-window ("L") layers, the MoE LMs, mamba2 (SSD
layers, "S") and recurrentgemma (RG-LRU layers, "R", with local attention).
The JAX package's other configs join as their model families are ported.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_ARCHS = {
    "qwen3-8b": "qwen3_8b",
    "gemma3-12b": "gemma3_12b",
    "phi3-medium-14b": "phi3_medium_14b",
    "qwen3-0.6b": "qwen3_0_6b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "arctic-480b": "arctic_480b",
    "mamba2-2.7b": "mamba2_2_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
}

ARCH_NAMES = tuple(_ARCHS)


def get_config(name: str) -> ModelConfig:
    try:
        mod = _ARCHS[name]
    except KeyError:
        raise KeyError(f"unknown or not yet ported arch {name!r}; "
                       f"available: {sorted(_ARCHS)}") from None
    return importlib.import_module(f"repro_torch.configs.{mod}").CONFIG


__all__ = ["ModelConfig", "get_config", "ARCH_NAMES"]
