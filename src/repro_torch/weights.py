"""Model parameters of the port: conversion from the reference's parameter
tree, and random initialisation at full width.

The port's tree for the dense LM::

    {"embed": {"tok": (V_pad, D)}, "ln_f": {"scale": (D,)},
     "layers": [{"ln1": {"scale"}, "attn": {"wq": (D, H, HD), "wk": (D, KV, HD),
                 "wv": (D, KV, HD), "wo": (H·HD, D), "q_norm"?, "k_norm"?},
                 "ln2": {"scale"}, "ffn": {"glu": {"w_gate": (D, F),
                 "w_up": (D, F), "w_down": (F, D)}}}, ...]}

and for an MoE LM each layer's ``ffn`` is ``{"moe": {"router": (D, E_pad)
f32, "w_gate": (E_pad, D, F_e), "w_up": (E_pad, D, F_e), "w_down": (E_pad,
F_e, D)}}``, plus ``"dense"`` (a GLU as above) with ``dense_residual``.
An "S" layer is ``{"ln1", "ssd": {"w_x": (D, DI), "w_B": (D, DS), "w_C":
(D, DS), "w_dt": (D, NH), "w_out": (DI, D), "conv_w": (W, DI + 2·DS),
"A_log": (NH,) f32, "D": (NH,) f32, "dt_bias": (NH,) f32, "norm":
{"scale": (DI,)}, "z_gate": (D, DI)}}`` and an "R" layer ``{"ln1",
"rglru": {"w_x": (D, RW), "w_gate_out": (D, RW), "w_out": (RW, D),
"conv_w": (W, RW), "w_r": (RW, RW) f32, "w_i": (RW, RW) f32, "lam": (RW,)
f32}, "ln2", "ffn"}``.

With the vision frontend (llava) the tree also holds ``"projector": (F,
D)``, which maps the stub's patch embeddings into the LM stream. The
enc-dec family (whisper) has a tree of its own (`models.encdec`):
``"embed"``, ``"enc"`` (one dict per encoder layer: ``ln1``, ``attn``,
``ln2``, ``glu``), ``"ln_enc"``, ``"dec"`` (one dict per decoder layer:
``ln1``, ``self_attn``, ``ln_x``, ``cross_attn``, ``ln2``, ``glu``) and
``"ln_f"``; the reference stacks each of ``enc`` and ``dec`` over its
layers, the port unstacks them.

Layouts are the reference's. The reference stacks one tree per position of
the layer pattern over the pattern's periods (``periods[i]``: leaves with a
leading period axis) and keeps the layers past the last whole period in
``tail``; the port keeps one dict per layer, layer l = ``periods[l % P][l //
P]`` for P = len(pattern), then the tail in order. Global ("A") and
sliding-window ("L") layers have the same parameters.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models.common import cdtype
from repro_torch.models.registry import unsupported_reason


# kept in float32 in any model dtype, as in the reference
F32_LEAVES = ("calib_salience", "router", "A_log", "D", "dt_bias", "w_r", "w_i", "lam")


def _check(cfg: ModelConfig) -> None:
    reason = unsupported_reason(cfg)
    if reason is not None:
        raise NotImplementedError(f"{cfg.name}: {reason}")


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """The reference's LM parameter tree with numpy leaves (e.g.
    ``jax.tree_util.tree_map(np.asarray, params)``) → the port's tree on
    ``device``, in the config's dtype. The leaves of `F32_LEAVES` stay
    float32, as in the reference: a layer's ``calib_salience``
    (`models.transformer.lm_calibrate_static_heavy`), whose top-r in the
    model's dtype could pick another heavy set at a near-tie; an MoE
    layer's ``router``, whose logits the reference computes in float32; the
    SSD's ``A_log``, ``D`` and ``dt_bias`` and the RG-LRU's ``w_r``, ``w_i``
    and ``lam``, whose recurrences run in float32."""
    _check(cfg)
    dev = resolve_device(device)
    dt = cdtype(cfg)

    def conv(a, to=dt):
        return torch.from_numpy(np.asarray(a, dtype=np.float32).copy()).to(dev, to)

    def pick(a, i):
        return np.asarray(a) if i is None else np.asarray(a)[i]

    def layer(node, i):
        """One layer's dict: entry ``i`` of a stacked period, or a tail
        layer as it stands (``i`` None)."""
        if isinstance(node, dict):
            return {k: (conv(pick(v, i), torch.float32) if k in F32_LEAVES
                        else layer(v, i)) for k, v in node.items()}
        return conv(pick(node, i))

    if cfg.encdec:
        def stack(name, n):
            got = np.asarray(tree[name]["ln1"]["scale"]).shape[0]
            if got != n:
                raise ValueError(f"parameter tree has {got} {name} layers; config expects {n}")
            return [layer(tree[name], i) for i in range(n)]
        return {"embed": {k: conv(v) for k, v in tree["embed"].items()},
                "enc": stack("enc", cfg.encoder_layers),
                "ln_enc": {"scale": conv(tree["ln_enc"]["scale"])},
                "dec": stack("dec", cfg.num_layers),
                "ln_f": {"scale": conv(tree["ln_f"]["scale"])}}

    # layer l of the reference's tree: periods[l % P][l // P], then the tail
    periods, tail = tree["periods"], tree["tail"]
    n_periods = np.asarray(periods[0]["ln1"]["scale"]).shape[0] if periods else 0
    n = n_periods * len(periods) + len(tail)
    if n != cfg.num_layers or (periods and len(periods) != len(cfg.layer_pattern)):
        raise ValueError(f"parameter tree has {n_periods} periods of {len(periods)} layers "
                         f"(+{len(tail)} tail); config expects {cfg.num_layers} layers of "
                         f"pattern {cfg.layer_pattern!r}")
    layers = [layer(periods[i % len(periods)], i // len(periods))
              for i in range(n_periods * len(periods))]
    layers += [layer(node, None) for node in tail]
    out = {"embed": {k: conv(v) for k, v in tree["embed"].items()},
           "ln_f": {"scale": conv(tree["ln_f"]["scale"])},
           "layers": layers}
    if "projector" in tree:
        out["projector"] = conv(tree["projector"])
    return out


def init_lm_params(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random weights for ``cfg`` at full width, drawn from ``generator``
    (on ``device`` for speed): normals clipped to ±2σ with σ = 1/sqrt(fan_in),
    embedding N(0, 0.02), norm scales 1; an MoE router in float32, the
    experts' products at fan-in D (gate, up) and F_e (down). The recurrent
    blocks take the reference's fan-ins and deterministic leaves: the
    SSD's ``A_log = log(linspace(1, 16, NH))``, ``D`` ones, ``dt_bias``
    zeros, the RG-LRU's ``lam = log(linspace(9, 999, RW))`` and ``w_r``,
    ``w_i`` in float32, each ``conv_w`` N(0, 0.1²). The vision frontend's
    ``projector`` (F, D) takes fan-in F; an enc-dec config gets the
    enc-dec tree (module docstring), its attention and GLU leaves drawn as
    the LM's. On the ``meta`` device (``generator`` unused) it returns the
    tree's shapes and dtypes and holds no data: the counterpart of
    ``jax.eval_shape(api.init, key)``."""
    _check(cfg)
    dev = resolve_device(device)
    dt = cdtype(cfg)
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim

    def randn(shape):
        if dev.type == "meta":
            return torch.empty(shape, dtype=torch.float32, device=dev)
        x = torch.randn(shape, generator=generator, device=generator.device,
                        dtype=torch.float32)
        return x.to(dev)

    def dense(shape, fan_in, to=dt):
        return (randn(shape).clamp_(-2.0, 2.0) * fan_in ** -0.5).to(to)

    def glu(f):
        return {"w_gate": dense((d, f), d), "w_up": dense((d, f), d),
                "w_down": dense((f, d), f)}

    def ffn():
        if not cfg.moe:
            return {"glu": glu(cfg.d_ff)}
        e, fe = cfg.padded_experts, cfg.moe_d_ff
        out = {"moe": {"router": dense((d, e), d, torch.float32),
                       "w_gate": dense((e, d, fe), d), "w_up": dense((e, d, fe), d),
                       "w_down": dense((e, fe, d), fe)}}
        if cfg.dense_residual:
            out["dense"] = glu(cfg.d_ff)
        return out

    def ones(n):
        return {"scale": torch.ones(n, dtype=dt, device=dev)}

    def f32(x):
        return x.to(device=dev, dtype=torch.float32)

    def ssd():
        di = cfg.ssm_expand * d
        nh, ds = di // cfg.ssm_head_dim, cfg.ssm_state
        return {"w_x": dense((d, di), d), "w_B": dense((d, ds), d), "w_C": dense((d, ds), d),
                "w_dt": dense((d, nh), d), "w_out": dense((di, d), di),
                "conv_w": (randn((cfg.conv_width, di + 2 * ds)) * 0.1).to(dt),
                "A_log": f32(torch.log(torch.linspace(1.0, 16.0, nh))),
                "D": f32(torch.ones(nh)), "dt_bias": f32(torch.zeros(nh)),
                "norm": ones(di), "z_gate": dense((d, di), d)}

    def rglru():
        w = cfg.rnn_width or d
        return {"w_x": dense((d, w), d), "w_gate_out": dense((d, w), d),
                "w_out": dense((w, d), w),
                "conv_w": (randn((cfg.conv_width, w)) * 0.1).to(dt),
                "w_r": dense((w, w), w, torch.float32), "w_i": dense((w, w), w, torch.float32),
                "lam": f32(torch.log(torch.linspace(9.0, 999.0, w)))}

    def attn():
        out = {"wq": dense((d, h, hd), d), "wk": dense((d, kv, hd), d),
               "wv": dense((d, kv, hd), d), "wo": dense((h * hd, d), h * hd)}
        if cfg.qk_norm:
            out["q_norm"], out["k_norm"] = ones(hd), ones(hd)
        return out

    def embed():
        out = {"tok": (randn((cfg.padded_vocab, d)) * 0.02).to(dt)}
        if not cfg.tie_embeddings:
            out["head"] = dense((d, cfg.padded_vocab), d)
        return out

    if cfg.encdec:
        enc = [{"ln1": ones(d), "attn": attn(), "ln2": ones(d), "glu": glu(cfg.d_ff)}
               for _ in range(cfg.encoder_layers)]
        dec = [{"ln1": ones(d), "self_attn": attn(), "ln_x": ones(d), "cross_attn": attn(),
                "ln2": ones(d), "glu": glu(cfg.d_ff)} for _ in range(cfg.num_layers)]
        return {"embed": embed(), "enc": enc, "ln_enc": ones(d), "dec": dec, "ln_f": ones(d)}
    layers = []
    for kind in cfg.block_kinds():
        if kind == "S":
            layers.append({"ln1": ones(d), "ssd": ssd()})
            continue
        if kind == "R":
            layers.append({"ln1": ones(d), "rglru": rglru(), "ln2": ones(d), "ffn": ffn()})
            continue
        layers.append({"ln1": ones(d), "attn": attn(), "ln2": ones(d), "ffn": ffn()})
    out = {"embed": embed(), "ln_f": ones(d), "layers": layers}
    if cfg.frontend == "vision":
        out["projector"] = dense((cfg.frontend_dim, d), cfg.frontend_dim)
    return out
