"""The MoE family's sharded train step (`runtime.steps.ShardedTrainStep`) on
data × model meshes, on 2 and 4 spawned gloo ranks
(`tests/_torch_dist_worker.py train_tp`: a world of 2 with the (2, 1) and
(1, 2) meshes, a world of 4 with the (4, 1), (1, 4) and (2, 2) meshes,
built in one order on every rank), against the port's one-device step on
the global batch (which tests/test_torch_train.py holds to the JAX
package's gradients) and, for `REF_CASES`, against the reference's jitted
`make_train_step` on the same mesh of forced host devices
(`tests/_torch_tp_reference.py`, a subprocess started first).

* granite-moe-3b-a800m.reduced() (8 experts, top 2, cp attention) under
  ``ep`` on (2, 1), (4, 1), (1, 2), (1, 4) and (2, 2) (experts over
  "model", MoE over more than one data rank), and under expert-TP
  (``moe_strategy="tp"``) on (1, 2); arctic-480b.reduced() (its dense
  residual GLU beside the MoE) on (1, 2); f32, 3 steps of a global batch
  of 4 × 64 tokens from the same whole weights (granite: the reference's
  ``init(PRNGKey(0))``; arctic: the port's `init_lm_params`, seed 0). The
  tolerances are tests/test_torch_tp_train.py's:
  - every leaf's step-0 gradient (reduced, gathered whole) within
    `GRAD_RTOL` of the leaf's largest magnitude (a load-balancing gradient
    summed M or n times, or missed, moves the router's by O(1) of it);
  - losses and gradient norms within `STEP0_RTOL` at step 0 and
    `METRIC_RTOL` after, the same bits on every rank; parameters within
    `PARAM_ATOL`;
  - each layer's load-balancing loss at step 0 (the reference's product of
    two means over the global batch) within `AUX_RTOL` of the one-device
    step's, the same bits on every rank;
  - every local block has the shape `param_specs` gives and is that block
    of the whole;
* for `REF_CASES`, losses and norms within `METRIC_RTOL` and parameters
  within `REF_PARAM_ATOL` of the reference's jitted step on the same mesh.

Run alone: ~25 s on this container's CPU (the reference's subprocess runs
beside the one-device steps and the spawned worlds).
"""

import dataclasses
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_bridge import spawn_ranks
from repro.configs import get_config as jget_config
from repro.models import get_model as jget_model
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import DecodeCtx, Mesh, local_block
from repro_torch.models import get_model, moe
from repro_torch.runtime import AdamWConfig
from repro_torch.runtime.data import make_batch, to_device
from repro_torch.runtime.optimizer import init_opt_state
from repro_torch.runtime.steps import _loss_and_grads, make_train_step
from repro_torch.runtime.tree import leaves
from repro_torch.weights import init_lm_params, params_from_numpy

OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)
SHAPE = dict(name="t", seq_len=64, global_batch=4, kind="train")
STEPS = 3
GRAD_RTOL = 2e-5
STEP0_RTOL = 1e-6
METRIC_RTOL = 5e-5
PARAM_ATOL = 3e-4
REF_PARAM_ATOL = 3e-4
# the load-balancing loss: f32 sums over the ranks' tokens in another order
AUX_RTOL = 1e-6
GRANITE, ARCTIC = "granite-moe-3b-a800m", "arctic-480b"
MODELS = {"granite": (GRANITE, {}), "granite_tp": (GRANITE, dict(moe_strategy="tp")),
          "arctic": (ARCTIC, {})}
CASES = [("granite", (2, 1)), ("granite", (4, 1)), ("granite", (1, 2)), ("granite", (1, 4)),
         ("granite", (2, 2)), ("granite_tp", (1, 2)), ("arctic", (1, 2))]
REF_CASES = [("granite", (1, 4)), ("granite", (2, 2))]
REFERENCE = pathlib.Path(__file__).resolve().parent / "_torch_tp_reference.py"


def _cfg(name):
    arch, over = MODELS[name]
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32", **over)


def _one_device(name):
    """Whole weights, the global batches, the one-device step's step-0
    gradients and layers' load-balancing losses, its metrics and final
    parameters (and for granite the reference's init tree)."""
    cfg = _cfg(name)
    tree = None
    if cfg.name == GRANITE:
        jcfg = dataclasses.replace(jget_config(GRANITE).reduced(), dtype="float32")
        tree = jax.tree_util.tree_map(np.asarray,
                                      jax.jit(jget_model(jcfg).init)(jax.random.PRNGKey(0)))
    weights = (params_from_numpy(tree, cfg, "cpu") if tree is not None
               else init_lm_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    batches = [make_batch(cfg, ShapeConfig(**SHAPE), 1, s) for s in range(STEPS)]
    seen, real = [], moe.aux_loss
    moe.aux_loss = lambda r: seen.append(real(r)) or seen[-1]
    try:
        grads, _ = _loss_and_grads(get_model(cfg), weights, to_device(batches[0], "cpu"))
    finally:
        moe.aux_loss = real
    step = make_train_step(cfg, None, AdamWConfig(**OPT), "cpu")
    p, o, metrics = weights, init_opt_state(weights, AdamWConfig(**OPT)), []
    for b in batches:
        p, o, m = step(p, o, to_device(b, "cpu"))
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(weights=weights, batches=batches, grads=dict(leaves(grads)), metrics=metrics,
                aux=[float(a.detach()) for a in seen[:cfg.num_layers]], params=dict(leaves(p)),
                tree=tree)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_reference") / "ref.npz"
    proc = subprocess.Popen([sys.executable, str(REFERENCE), str(out),
                             *(f"{MODELS[n][0]}:{m[0]}x{m[1]}" for n, m in REF_CASES)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


@pytest.fixture(scope="module")
def one(reference):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {name: _one_device(name) for name in ("granite", "arctic")}
    finally:
        torch.set_num_threads(threads)
    out["granite_tp"] = out["granite"]       # one device: the strategy changes nothing
    return out


@pytest.fixture(scope="module")
def worlds(reference, one, tmp_path_factory):
    base = tmp_path_factory.mktemp("moe_train")

    def steps(mesh):
        return {name: dict(arch=MODELS[name][0], over=MODELS[name][1], opt=OPT,
                           weights=one[name]["weights"], batches=one[name]["batches"],
                           record_aux=True)
                for name, shape in CASES if shape == mesh}
    out = {}
    for world, meshes in ((2, [(2, 1), (1, 2)]), (4, [(4, 1), (1, 4), (2, 2)])):
        (base / f"w{world}").mkdir()
        out[world] = spawn_ranks("train_tp", {"meshes": meshes,
                                              "steps": {m: steps(m) for m in meshes}},
                                 world, base / f"w{world}")
    ref, ref_out = reference
    log = ref.communicate(timeout=300)[0]
    assert ref.returncode == 0, log
    with np.load(ref_out) as z:
        out["ref"] = {k: z[k] for k in z.files}
    return out


def _ranks(worlds, name, mesh):
    return [r[(mesh, name)] for r in worlds[mesh[0] * mesh[1]]]


@pytest.mark.parametrize("name,mesh", CASES)
def test_moe_step_matches_one_device(one, worlds, name, mesh):
    ranks, want = _ranks(worlds, name, mesh), one[name]
    assert all("raised" not in r for r in ranks), ranks[0].get("raised")
    for rank, r in enumerate(ranks):
        assert r["metrics"] == ranks[0]["metrics"], rank     # the same bits everywhere
        for path, g in want["grads"].items():
            scale = float(g.abs().max())
            np.testing.assert_allclose(r["grads"][path].numpy(), g.numpy(), rtol=0,
                                       atol=GRAD_RTOL * max(scale, 1e-6),
                                       err_msg=f"rank {rank}: step-0 gradient of {path}")
        for path, p in want["params"].items():
            np.testing.assert_allclose(r["whole"][path].numpy(), p.numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=f"rank {rank}: {path}")
    for s in range(STEPS):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(ranks[0]["metrics"][s][k], want["metrics"][s][k],
                                       rtol=STEP0_RTOL if s == 0 else METRIC_RTOL,
                                       err_msg=f"step {s} {k}")


@pytest.mark.parametrize("name,mesh", CASES)
def test_moe_aux_is_the_global_batchs(one, worlds, name, mesh):
    """Each layer's load-balancing loss at step 0, as the forward formed it
    on every rank, against the one-device loss on the global batch."""
    ranks, layers = _ranks(worlds, name, mesh), _cfg(name).num_layers
    for rank, r in enumerate(ranks):
        got = [float(a) for a in r["aux"][:layers]]
        np.testing.assert_allclose(got, one[name]["aux"], rtol=AUX_RTOL, atol=0,
                                   err_msg=f"rank {rank}")
        assert got == [float(a) for a in ranks[0]["aux"][:layers]], rank


@pytest.mark.parametrize("name,mesh", CASES)
def test_moe_blocks_follow_param_specs(worlds, name, mesh):
    """Every rank holds its block of each leaf; the experts split over
    "model" under ``ep`` (their d_ff under expert-TP) and over the data axes
    by d_model."""
    ranks = _ranks(worlds, name, mesh)
    axis = {"ep": 0, "tp": 2}[_cfg(name).moe_strategy]
    for rank, r in enumerate(ranks):
        mine = Mesh({"data": mesh[0], "model": mesh[1]}, DecodeCtx(None, rank, len(ranks), "gloo"))
        for path, t in r["local"].items():
            spec, whole = r["specs"][path], r["whole"][path]
            assert tuple(t.shape) == r["want_shapes"][path], (rank, path)
            assert torch.equal(t, whole[local_block(mine, spec, whole.shape)]), (rank, path)
    specs = ranks[0]["specs"]
    w_gate = specs["layers/0/ffn/moe/w_gate"]
    assert w_gate[axis] == "model" and w_gate[1] == "data", w_gate
    assert "model" not in specs["layers/0/ffn/moe/router"]


@pytest.mark.parametrize("name,mesh", REF_CASES)
def test_moe_step_matches_reference_on_the_same_mesh(one, worlds, name, mesh):
    """The reference's jitted step under GSPMD on forced host devices."""
    case = f"{MODELS[name][0]}:{mesh[0]}x{mesh[1]}"
    ref = worlds["ref"]
    r = _ranks(worlds, name, mesh)[0]
    for s in range(STEPS):
        for i, k in enumerate(("loss", "grad_norm")):
            np.testing.assert_allclose(r["metrics"][s][k], ref[f"{case}/metrics"][s][i],
                                       rtol=METRIC_RTOL, err_msg=f"step {s} {k}")
    from repro.distributed.sharding import path_of
    flat, treedef = jax.tree_util.tree_flatten_with_path(one[name]["tree"])
    tree = jax.tree_util.tree_unflatten(
        treedef, [ref[f"{case}/params/{path_of(kp)}"] for kp, _ in flat])
    for path, p in leaves(params_from_numpy(tree, _cfg(name), "cpu")):
        np.testing.assert_allclose(r["whole"][path].numpy(), p.numpy(), rtol=0,
                                   atol=REF_PARAM_ATOL, err_msg=path)
