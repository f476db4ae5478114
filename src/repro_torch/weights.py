"""Model parameters of the port: conversion from the reference's parameter
tree, and random initialisation at full width.

The port's tree for the dense LM::

    {"embed": {"tok": (V_pad, D)}, "ln_f": {"scale": (D,)},
     "layers": [{"ln1": {"scale"}, "attn": {"wq": (D, H, HD), "wk": (D, KV, HD),
                 "wv": (D, KV, HD), "wo": (H·HD, D), "q_norm"?, "k_norm"?},
                 "ln2": {"scale"}, "ffn": {"glu": {"w_gate": (D, F),
                 "w_up": (D, F), "w_down": (F, D)}}}, ...]}

Layouts are the reference's; its stacked ``periods`` leaves (leading layer
axis) become one dict per layer.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models.common import cdtype
from repro_torch.models.registry import unsupported_reason


def _check(cfg: ModelConfig) -> None:
    reason = unsupported_reason(cfg)
    if reason is not None:
        raise NotImplementedError(f"{cfg.name}: {reason}")


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """The reference's LM parameter tree with numpy leaves (e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``) → the port's tree on
    ``device``, in the config's dtype."""
    _check(cfg)
    dev = resolve_device(device)
    dt = cdtype(cfg)

    def conv(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32).copy()).to(dev, dt)

    def layer(node, i):
        if isinstance(node, dict):
            return {k: layer(v, i) for k, v in node.items()}
        return conv(np.asarray(node)[i])

    stacked = tree["periods"][0]
    n = np.asarray(stacked["ln1"]["scale"]).shape[0]
    if n != cfg.num_layers or tree["tail"]:
        raise ValueError(f"parameter tree has {n} stacked layers (+{len(tree['tail'])} "
                         f"tail); config expects {cfg.num_layers}")
    return {"embed": {k: conv(v) for k, v in tree["embed"].items()},
            "ln_f": {"scale": conv(tree["ln_f"]["scale"])},
            "layers": [layer(stacked, i) for i in range(n)]}


def init_lm_params(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random weights for ``cfg`` at full width, drawn from ``generator``
    (on ``device`` for speed): normals clipped to ±2σ with σ = 1/sqrt(fan_in),
    embedding N(0, 0.02), norm scales 1."""
    _check(cfg)
    dev = resolve_device(device)
    dt = cdtype(cfg)
    d, h, kv, hd, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.resolved_head_dim, cfg.d_ff)

    def randn(shape):
        x = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32)
        return x.to(dev)

    def dense(shape, fan_in):
        return (randn(shape).clamp_(-2.0, 2.0) * fan_in ** -0.5).to(dt)

    def ones(n):
        return {"scale": torch.ones(n, dtype=dt, device=dev)}

    layers = []
    for _ in range(cfg.num_layers):
        attn = {"wq": dense((d, h, hd), d), "wk": dense((d, kv, hd), d),
                "wv": dense((d, kv, hd), d), "wo": dense((h * hd, d), h * hd)}
        if cfg.qk_norm:
            attn["q_norm"], attn["k_norm"] = ones(hd), ones(hd)
        layers.append({"ln1": ones(d), "attn": attn, "ln2": ones(d),
                       "ffn": {"glu": {"w_gate": dense((d, f), d), "w_up": dense((d, f), d),
                                       "w_down": dense((f, d), f)}}})
    embed = {"tok": (randn((cfg.padded_vocab, d)) * 0.02).to(dt)}
    if not cfg.tie_embeddings:
        embed["head"] = dense((d, cfg.padded_vocab), d)
    return {"embed": embed, "ln_f": ones(d), "layers": layers}
