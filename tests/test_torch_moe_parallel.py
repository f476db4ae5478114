"""The MoE layers over the model axis (`models.moe`: ``ep``, experts over
"model", and expert-TP, their d_ff over it) on 2 and 4 spawned gloo ranks
(`tests/_torch_dist_worker.py train_tp`: a (1, 2) and a (1, 4) ("data",
"model") mesh, each in its own world), against the same layer on one
device (the port's, which tests/test_torch_moe.py and
tests/test_torch_train.py hold to the JAX package).

Each rank runs `blocks.ffn_apply` (the MoE branch, and arctic's dense
residual GLU) on its blocks of the whole weights (the reference's
`param_specs` under ``moe_strategy``) and its rows of the input (the
sequence split over "model" where the axis divides it), and seeds the
backward with its part of the output's cotangent plus ``AUX_W`` times the
load-balancing loss (as the step's loss holds it on every rank). Cases,
granite-moe-3b-a800m.reduced() (8 experts, top 2) unless named:

* ``ep``: each rank routes its sequence shard, its positions offset by the
  lower ranks' counts, the pairs exchanged to their experts' ranks and back;
* ``tp``: expert-TP, the tokens gathered and routed whole on every rank;
* ``*_whole``: T 63, which neither axis divides: every rank routes the
  whole sequence (``ep``: it fills its own experts' slots);
* ``e6``: 6 experts, which M = 4 does not divide (`fit_spec` leaves them
  whole on every rank: nothing is exchanged); at M = 2 they split;
* ``phantom``: 7 experts padded to 8 (the router masks the eighth);
* ``drops``: a capacity factor of 0.25 (capacity 8 of ~16 pairs an expert
  and row): most pairs drop, the higher ranks' shards most of all;
* ``arctic`` / ``arctic_tp``: arctic-480b.reduced(), its dense residual GLU
  with d_ff split over "model" (`parallel_glu`);
* ``ep_onehot`` / ``tp_onehot``: ``PERF.moe_gather_dispatch`` off, the
  one-hot dispatch and combine on the mesh, against the one-device one-hot
  form.

Every rank's ``topi``, ``pos`` and ``keep`` equal the unsharded routing's
(its rows, or all of them where it routes the whole sequence) exactly;
the output, every leaf's gradient and the input's within `LAYER_RTOL` of
each tensor's largest magnitude (f32 sums in another order: the expert
products over E/M experts or d_ff/M columns, the partial sums over ranks);
the load-balancing loss within `AUX_RTOL` of the one-device loss (its
sums over ranks in another order), the same bits on every rank.

Run alone: ~10 s on this container's CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_bridge import spawn_ranks
from _torch_dist_worker import _nest
from repro_torch.configs import get_config
from repro_torch.flags import PERF, perf_flags
from repro_torch.models.blocks import ffn_apply
from repro_torch.models.moe import capacity, route
from repro_torch.weights import init_lm_params

LAYER_RTOL = 1e-5
AUX_RTOL = 1e-6
AUX_W = 1.0          # the loss's weight on the layer's aux: its gradient as large as the output's
B, T = 2, 64
GRANITE, ARCTIC = "granite-moe-3b-a800m", "arctic-480b"
CASES = {
    "ep": (GRANITE, {}, T),
    "ep_whole": (GRANITE, {}, T - 1),
    "tp": (GRANITE, dict(moe_strategy="tp"), T),
    "tp_whole": (GRANITE, dict(moe_strategy="tp"), T - 1),
    "e6": (GRANITE, dict(num_experts=6, expert_pad_to=6), T),
    "phantom": (GRANITE, dict(num_experts=7, expert_pad_to=8), T),
    "drops": (GRANITE, dict(capacity_factor=0.25), T),
    "arctic": (ARCTIC, {}, T),
    "arctic_tp": (ARCTIC, dict(moe_strategy="tp"), T),
    "ep_onehot": (GRANITE, {}, T),
    "tp_onehot": (GRANITE, dict(moe_strategy="tp"), T),
}
# ``moe_gather_dispatch`` off: the one-hot einsums on the mesh, as on one device
FLAGS = {"ep_onehot": dict(moe_gather_dispatch=False),
         "tp_onehot": dict(moe_gather_dispatch=False)}
PREFIX = "layers/0/ffn"


def _cfg(arch, **over):
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32", **over)


def _cases():
    g = torch.Generator().manual_seed(35)
    out = {}
    for name, (arch, over, t) in CASES.items():
        cfg = _cfg(arch, **over)
        ffn = init_lm_params(cfg, g, "cpu")["layers"][0]["ffn"]
        params = {f"{PREFIX}/{k}/{kk}": vv for k, v in ffn.items() for kk, vv in v.items()}
        # a router that routes unevenly (random init is near uniform): queues
        # fill at different speeds and the drops differ between experts
        params[f"{PREFIX}/moe/router"] = params[f"{PREFIX}/moe/router"] * 8
        out[name] = dict(kind="ffn", arch=arch, over=over, batch=B, t=t, params=params,
                         prefix=PREFIX, x=torch.randn((B, t, cfg.d_model), generator=g),
                         cot=torch.randn((B, t, cfg.d_model), generator=g), aux_w=AUX_W,
                         flags=FLAGS.get(name, {}))
    return out


def _one_device(case):
    """(output, aux, {path: gradient}, input gradient, the unsharded
    routing's (topi, pos, keep))."""
    cfg = _cfg(case["arch"], **case["over"])
    params = {p: t.clone().requires_grad_() for p, t in case["params"].items()}
    x = case["x"].clone().requires_grad_()
    p = _nest(params, PREFIX)
    with perf_flags(**case["flags"]):
        y, aux = ffn_apply(p, x, cfg)
        seed = (y * case["cot"]).sum() + case["aux_w"] * aux
        grads = torch.autograd.grad(seed, list(params.values()) + [x])
    r = route(p["moe"]["router"], x, cfg, capacity(case["t"], cfg, PERF.moe_flat_dispatch))
    return (y.detach(), aux.detach(), dict(zip(params, grads[:-1])), grads[-1],
            {"topi": r.topi, "pos": r.pos, "keep": r.keep})


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    cases = _cases()
    out = {"cases": cases, "one": {name: _one_device(c) for name, c in cases.items()}}
    for m in (2, 4):
        d = tmp_path_factory.mktemp(f"moe_layers{m}")
        out[m] = spawn_ranks("train_tp", {"meshes": [(1, m)], "layers": {(1, m): cases}}, m, d)
    return out


def _ranks(worlds, m, name):
    return [r[((1, m), "layers")][name] for r in worlds[m]]


def _close(got, want, what):
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=LAYER_RTOL * max(scale, 1e-6), err_msg=what)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_moe_layer_matches_one_device(worlds, m, name):
    y, aux, grads, dx, routing = worlds["one"][name]
    ranks = _ranks(worlds, m, name)
    t = worlds["cases"][name]["t"]
    assert all(r["split"] == (t % m == 0) for r in ranks), name
    for rank, r in enumerate(ranks):
        what = f"{name} M={m} rank {rank}"
        # the mesh takes the dispatch that the flag names
        assert r["dispatch"] == ["onehot" if name in FLAGS else "gather"], what
        rows = r["routing"]["topi"].shape[1]
        lo = rank * rows if rows < t else 0          # a sequence shard, or all of it
        for f, want in routing.items():
            assert torch.equal(r["routing"][f], want[:, lo:lo + rows]), f"{what}: {f}"
        _close(r["y"], y, f"{what}: output")
        np.testing.assert_allclose(float(r["aux"]), float(aux), rtol=AUX_RTOL, atol=0,
                                   err_msg=f"{what}: aux")
        assert torch.equal(r["aux"], ranks[0]["aux"]), what    # the same bits everywhere
        for path, g in grads.items():
            _close(r["grads"][path], g, f"{what}: d {path}")
        _close(r["dx"], dx, f"{what}: dx")


def test_cases_cover_their_layouts(worlds):
    """``ep`` routes shards at M = 2 and 4 and ``e6`` at M = 4 too (its
    experts whole); ``tp`` and the ``*_whole`` cases route whole; the
    ``drops`` case drops most pairs, the last rank's shard more than the
    first's, and at M = 4 the last rank keeps no pair of some row."""
    for m in (2, 4):
        for name, shard in (("ep", True), ("e6", True), ("tp", False), ("ep_whole", False),
                            ("tp_whole", False)):
            rows = _ranks(worlds, m, name)[0]["routing"]["topi"].shape[1]
            assert (rows < worlds["cases"][name]["t"]) == shard, (name, m)
    keep = worlds["one"]["drops"][4]["keep"]
    assert float(keep.float().mean()) < 0.6
    last = [r["routing"]["keep"] for r in _ranks(worlds, 4, "drops")]
    assert float(last[-1].float().mean()) < float(last[0].float().mean())
    assert bool((~last[-1].any(-1)).any()), "a token of the last shard with every pair dropped"
