"""The model axis's layers (tensor, sequence and context parallelism, the
vocab-parallel embedding, head and loss) on 2 and 4 spawned gloo ranks
(`tests/_torch_dist_worker.py train_tp`: a (1, 2) and a (1, 4) ("data",
"model") mesh, each in its own world), against the same layer on one
device (the port's, which tests/test_torch_train.py holds to the JAX
package).

Each rank runs the layer on its blocks of the whole weights (the
reference's `param_specs`) and its rows of the input (the sequence split
over "model" where the axis divides it, `sequence_split`); the output rows
are gathered, a block's gradient gathered and a leaf that the spec
replicates over "model" summed over the model group (`tp_layers`). Cases:

* ``vocab_*``: the embedding, ``ln_f``, the sequence gather, the head and
  the cross-entropy (`lm_loss` with no layers) with a padded vocab (500 →
  512: the last rank's block holds the 12 padded slots) and labels on every
  rank's block; tied (qwen3-0.6b), untied (qwen3-8b), and llava's projector
  with 40 image rows that straddle the first shard at M = 2;
* ``glu``: the GLU, d_ff split over "model";
* ``attn_tp``: qwen3's attention (4 H / 2 KV: KV split at M = 2, replicated
  at M = 4, where each rank takes its query heads' KV head), and gemma3's
  under a window of 24 (q/k norms on local heads);
* ``attn_cp``: phi3's attention (cp: each rank its rows at their offset
  over the gathered keys), causal and under a window of 24;
* ``ssd``: mamba2's "S" block (`blocks.block_train`: ln1 + the SSD, 16
  heads split over "model", B / C / dt replicated and cut to the rank's
  heads, the gated norm's sum of squares over the model group);
  ``ssd_heads_whole``: an SSD whose d_inner (45) and 5 heads neither axis
  divides (the spec leaves them whole: every rank runs the whole mixer);
* ``rglru``: recurrentgemma's "R" block (ln1 + the RG-LRU, its 128
  channels over "model", the gate matrices' partials reduce-scattered,
  then ln2 + the GLU); ``rglru_width_whole``: an RG-LRU width of 125
  (whole on every rank);
* ``*_whole``: T 63, which neither axis divides: the sequence stays whole
  on every rank (the reference's ``fit_spec``), the row-parallel sums
  become all-reduces. A replicated activation's gradient is held as each
  model rank's part of it (`distributed.sharding`), so each rank seeds the
  backward with 1/M of the output's cotangent.

Values, gradients and input gradients within `LAYER_RTOL` of each tensor's
largest magnitude: f32 sums over d_ff, heads, vocab columns or ranks in
another order (measured within 1e-6).

Run alone: ~12 s on this container's CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_bridge import spawn_ranks
from _torch_dist_worker import _nest
from repro_torch.configs import get_config
from repro_torch.models import transformer
from repro_torch.models.attention import attention_train
from repro_torch.models.blocks import block_train
from repro_torch.models.common import parallel_glu
from repro_torch.weights import init_lm_params

LAYER_RTOL = 1e-5
B, T, VOCAB, PATCHES = 2, 64, 500, 40
# an SSD whose d_inner (45) and heads (5) neither axis divides: the spec
# leaves its channels whole and every rank runs the whole mixer
SSD_ODD = dict(d_model=45, ssm_expand=1, ssm_head_dim=9)


def _cfg(arch, **over):
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32", **over)


def _cases():
    """(name → the layer case the worker runs), the same at every M."""
    g = torch.Generator().manual_seed(7)
    rng = np.random.default_rng(7)
    out = {}

    def rand_scales(tree):
        return {k: (1 + 0.1 * torch.randn(v.shape, generator=g) if k.endswith("scale") else v)
                for k, v in tree.items()}

    for name, arch, over, n_img in (("vocab_tied", "qwen3-0.6b", {}, 0),
                                    ("vocab_untied", "qwen3-8b", {}, 0),
                                    ("vocab_vision", "llava-next-mistral-7b", {}, PATCHES)):
        for t in (T, T - 1):
            cfg = _cfg(arch, vocab_size=VOCAB, **over)
            w = init_lm_params(cfg, g, "cpu")
            params = {f"embed/{k}": v for k, v in w["embed"].items()}
            params["ln_f/scale"] = 1 + 0.1 * torch.randn(cfg.d_model, generator=g)
            case = dict(kind="vocab", arch=arch, over=dict(vocab_size=VOCAB), batch=B, t=t,
                        params=params)
            t_text = t - n_img
            case["tokens"] = torch.from_numpy(rng.integers(0, VOCAB, (B, t_text)))
            case["labels"] = torch.from_numpy(rng.integers(0, VOCAB, (B, t_text)))
            if n_img:
                params["projector"] = w["projector"]
                case["patches"] = torch.randn((B, n_img, cfg.frontend_dim), generator=g)
            out[name if t == T else f"{name}_whole"] = case
    layers = {
        "glu": ("qwen3-0.6b", {}, "glu", {}),
        "attn_tp": ("qwen3-0.6b", {}, "attn", {}),
        "attn_tp_window": ("gemma3-12b", {}, "attn", dict(window=24)),
        "attn_cp": ("phi3-medium-14b", {}, "attn", {}),
        "attn_cp_window": ("phi3-medium-14b", {}, "attn", dict(window=24)),
        "ssd": ("mamba2-2.7b", {}, "block", dict(block="S")),
        "ssd_heads_whole": ("mamba2-2.7b", SSD_ODD, "block", dict(block="S")),
        "rglru": ("recurrentgemma-2b", {}, "block", dict(block="R")),
        "rglru_width_whole": ("recurrentgemma-2b", dict(rnn_width=125), "block",
                              dict(block="R")),
    }
    for name, (arch, over, kind, extra) in layers.items():
        for t in (T, T - 1):
            if t != T and name not in ("glu", "attn_tp", "attn_cp", "ssd", "rglru"):
                continue
            cfg = _cfg(arch, **over)
            layer = init_lm_params(cfg, g, "cpu")["layers"][0]
            sub, prefix = {"glu": (layer.get("ffn", {}).get("glu"), "layers/0/ffn/glu"),
                           "attn": (layer.get("attn"), "layers/0/attn"),
                           "block": (layer, "layers/0")}[kind]
            params = {}
            for k, v in sub.items():
                if isinstance(v, dict):
                    for kk, vv in rand_scales(v).items():
                        if isinstance(vv, dict):
                            for k3, v3 in rand_scales(vv).items():
                                params[f"{prefix}/{k}/{kk}/{k3}"] = v3
                        else:
                            params[f"{prefix}/{k}/{kk}"] = vv
                else:
                    params[f"{prefix}/{k}"] = v
            x = torch.randn((B, t, cfg.d_model), generator=g)
            cot = torch.randn((B, t, cfg.d_model), generator=g)
            out[name if t == T else f"{name}_whole"] = dict(
                kind=kind, arch=arch, over=over, batch=B, t=t, params=params, prefix=prefix, x=x,
                cot=cot, **extra)
    return out


def _one_device(case):
    """(output, {path: gradient}, input gradient) of the layer on one device."""
    cfg = _cfg(case["arch"], **case["over"])
    params = {p: t.clone().requires_grad_() for p, t in case["params"].items()}
    if case["kind"] == "vocab":
        tree = {"embed": {p.split("/")[1]: t for p, t in params.items() if p.startswith("embed/")},
                "ln_f": {"scale": params["ln_f/scale"]}, "layers": []}
        if "projector" in params:
            tree["projector"] = params["projector"]
        y = transformer.lm_loss(tree, cfg, case["tokens"], case["labels"],
                                patches=case.get("patches"))
        grads = torch.autograd.grad(y, list(params.values()))
        return y.detach(), dict(zip(params, grads)), None
    x = case["x"].clone().requires_grad_()
    p = _nest(params, case["prefix"])
    if case["kind"] == "block":
        y = block_train(p, x, cfg, case["block"])[0]
    else:
        y = (parallel_glu(p, x, cfg, False) if case["kind"] == "glu"
             else attention_train(p, x, cfg, window=case.get("window", 0)))
    grads = torch.autograd.grad((y * case["cot"]).sum(), list(params.values()) + [x])
    return y.detach(), dict(zip(params, grads[:-1])), grads[-1]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    cases = _cases()
    out = {"cases": cases}
    for m in (2, 4):
        d = tmp_path_factory.mktemp(f"tp_layers{m}")
        out[m] = spawn_ranks("train_tp", {"meshes": [(1, m)], "layers": {(1, m): cases}}, m, d)
    return out


def _close(got, want, what):
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=LAYER_RTOL * max(scale, 1e-6), err_msg=what)


CASES = ["vocab_tied", "vocab_untied", "vocab_vision", "glu", "attn_tp", "attn_tp_window",
         "attn_cp", "attn_cp_window", "vocab_tied_whole", "vocab_untied_whole",
         "vocab_vision_whole", "glu_whole", "attn_tp_whole", "attn_cp_whole",
         "ssd", "ssd_whole", "ssd_heads_whole", "rglru", "rglru_whole", "rglru_width_whole"]


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("name", CASES)
def test_layer_matches_one_device(worlds, m, name):
    case = worlds["cases"][name]
    y, grads, dx = _one_device(case)
    ranks = [r[((1, m), "layers")][name] for r in worlds[m]]
    assert all(r["split"] == (case["t"] == T) for r in ranks), name
    for rank, r in enumerate(ranks):
        _close(r["y"], y, f"{name} M={m} rank {rank}: output")
        for path, g in grads.items():
            _close(r["grads"][path], g, f"{name} M={m} rank {rank}: d {path}")
        if dx is not None:
            _close(r["dx"], dx, f"{name} M={m} rank {rank}: dx")
    if case["kind"] == "vocab":          # the loss: the same bits on every model rank
        assert all(torch.equal(r["y"], ranks[0]["y"]) for r in ranks)


def test_cases_cover_padding_and_replicated_kv():
    """The vocab cases hold padded slots on the last rank's block and labels
    on every rank's block; qwen3's KV heads split at M = 2 and not at 4."""
    cfg = _cfg("qwen3-0.6b", vocab_size=VOCAB)
    assert cfg.padded_vocab == 512 and cfg.num_kv_heads == 2 and cfg.num_heads == 4
    labels = _cases()["vocab_tied"]["labels"]
    for m in (2, 4):
        block = cfg.padded_vocab // m
        assert set((labels // block).unique().tolist()) == set(range(m))
        assert cfg.vocab_size > (m - 1) * block    # the last block holds real and padded slots
