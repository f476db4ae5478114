"""Architecture registry of the port: `--arch <id>` resolves here.

Only the architectures the port can serve are listed; the JAX package's
other configs join as their model families are ported.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig

_ARCHS = ("qwen3-0.6b",)

ARCH_NAMES = _ARCHS


def get_config(name: str) -> ModelConfig:
    if name == "qwen3-0.6b":
        from repro_torch.configs.qwen3_0_6b import CONFIG
        return CONFIG
    raise KeyError(f"unknown or not yet ported arch {name!r}; available: {list(_ARCHS)}")


__all__ = ["ModelConfig", "get_config", "ARCH_NAMES"]
