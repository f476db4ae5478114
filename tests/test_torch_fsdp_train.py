"""Port parity, the sharded train step (`runtime.steps.ShardedTrainStep`:
FSDP over the data axis) and the sharded `Trainer`'s checkpoints, on 2 and 4
spawned gloo ranks (`tests/_torch_dist_worker.py train_fsdp`, one world of
each size), against the port's one-device step and the reference's jitted
`make_train_step` on its one-device local mesh.

* qwen3-0.6b.reduced() at f32, 3 steps of a global batch of 4 × 64 tokens,
  on 2 and 4 ranks; mamba2-2.7b.reduced() on 2 ranks. Losses and gradient
  norms within `METRIC_RTOL` of both; parameters within `PARAM_ATOL` of the
  one-device step's and `REF_PARAM_ATOL` of the reference's.
* Every rank's blocks have the shapes `param_specs` gives; the replicated
  leaves carry the same bits on every rank; the collectives per step are
  one all-gather and one reduce-scatter per sharded leaf and one all-reduce
  per replicated leaf, plus the loss's and the norm's.
* granite-moe-3b-a800m.reduced() on 2 ranks (which raised until the MoE
  load-balancing loss was taken over the global batch): losses and
  gradient norms within `METRIC_RTOL`, and parameters within `PARAM_ATOL`,
  of the one-device step's on the global batch.
* Checkpoints: a 4-rank `Trainer(plan=...)` resumed from its own checkpoint
  continues bit for bit with the uninterrupted run; its step-6 checkpoint
  restored on 2 ranks gives each rank exactly its block of the stored
  arrays, and training continues from it (losses within `METRIC_RTOL` of
  the one-device trainer's).

Run alone: ~30 s on this container's CPU.
"""

import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch

from _torch_bridge import start_ranks
from repro.configs import get_config as jget_config
from repro.configs.base import ShapeConfig as JShape
from repro.launch.mesh import make_local_mesh
from repro.models import get_model as jget_model
from repro.runtime import AdamWConfig as JAdamWConfig
from repro.runtime import MeshPlan as JPlan
from repro.runtime import init_opt_state as jinit_opt_state
from repro.runtime import make_batch as jmake_batch
from repro.runtime import make_train_step as jmake_train_step
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import DecodeCtx, Mesh, local_block, local_shape
from repro_torch.runtime import AdamWConfig, Trainer, TrainerConfig
from repro_torch.runtime.data import make_batch, to_device
from repro_torch.runtime.optimizer import init_opt_state
from repro_torch.runtime.steps import make_train_step
from repro_torch.runtime.tree import leaves
from repro_torch.weights import init_lm_params, params_from_numpy

OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)
SHAPE = dict(name="t", seq_len=64, global_batch=4, kind="train")
STEPS = 3
# f32 sums in another order (the mean of the ranks' per-row means; the
# reduce-scatter's and the norm's sums over ranks): measured within 3e-7
METRIC_RTOL = 1e-6
# three AdamW steps at lr 3e-3: Adam's normalised update turns a rounding of
# a near-zero gradient element into a move of up to lr; measured ≤ 6.7e-6
PARAM_ATOL = 2e-5
# the same against the reference, whose one-device step the port's own
# one-device step already parts from by up to 3e-5 (XLA's fusions)
REF_PARAM_ATOL = 1e-4


def _cfgs(arch):
    return tuple(dataclasses.replace(get(arch).reduced(), dtype="float32")
                 for get in (jget_config, tget_config))


def _inputs(arch):
    """Weights from the reference's init and the global batches."""
    jcfg, tcfg = _cfgs(arch)
    jp = jax.jit(jget_model(jcfg).init)(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    batches = [jmake_batch(jcfg, JShape(**SHAPE), seed=1, step=s) for s in range(STEPS)]
    return dict(weights=params_from_numpy(tree, tcfg, "cpu"), batches=batches, jp=jp)


def _case(arch, inp):
    """The port's one-device step's and the reference's jitted step's
    metrics and final parameters from ``inp``."""
    jcfg, tcfg = _cfgs(arch)
    batches = inp["batches"]
    step = make_train_step(tcfg, None, AdamWConfig(**OPT), "cpu")
    p = inp["weights"]
    o, one = init_opt_state(p, AdamWConfig(**OPT)), []
    for b in batches:
        p, o, m = step(p, o, to_device(b, "cpu"))
        one.append({k: float(v) for k, v in m.items()})
    _, jitted, _, _ = jmake_train_step(jcfg, JPlan.for_mesh(make_local_mesh()),
                                       JAdamWConfig(**OPT))
    f = jitted(batches[0])
    rp, ro, ref = inp["jp"], jinit_opt_state(inp["jp"], JAdamWConfig(**OPT)), []
    for b in batches:
        rp, ro, m = f(rp, ro, b)
        ref.append({k: float(v) for k, v in m.items()})
    ref_p = params_from_numpy(jax.tree_util.tree_map(np.asarray, rp), tcfg, "cpu")
    return dict(weights=inp["weights"], batches=batches, one=one, one_params=dict(leaves(p)),
                ref=ref, ref_params=dict(leaves(ref_p)))


def _one_device_case(arch):
    """Weights from the port's init (seed 0), the global batches, and the
    port's one-device step's metrics and final parameters."""
    _, tcfg = _cfgs(arch)
    weights = init_lm_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    batches = [make_batch(tcfg, ShapeConfig(**SHAPE), 1, s) for s in range(STEPS)]
    step = make_train_step(tcfg, None, AdamWConfig(**OPT), "cpu")
    p, o, one = weights, init_opt_state(weights, AdamWConfig(**OPT)), []
    for b in batches:
        p, o, m = step(p, o, to_device(b, "cpu"))
        one.append({k: float(v) for k, v in m.items()})
    return dict(weights=weights, batches=batches, one=one, one_params=dict(leaves(p)))


def _steps_input(inputs, archs):
    return {a: dict(arch=a, opt=OPT, weights=inputs[a]["weights"], batches=inputs[a]["batches"])
            for a in archs}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The 4-rank world (qwen3's steps; trainer runs A: 4 steps with a
    checkpoint every 2, B: a fresh trainer on A's directory to step 6, C:
    6 steps uninterrupted), then the 2-rank world (qwen3's, mamba2's and
    granite's steps; R: a trainer on a copy of C's directory to step 8);
    the one-device and reference steps run here while the ranks do (qwen3's
    beside the 4 ranks, mamba2's beside the 2; granite's one-device steps
    come first, its weights being the 2 ranks' input)."""
    base = tmp_path_factory.mktemp("fsdp")
    inputs = {arch: _inputs(arch) for arch in ("qwen3-0.6b", "mamba2-2.7b")}
    qwen = inputs["qwen3-0.6b"]
    trainer = dict(arch="qwen3-0.6b", opt=OPT, shape=SHAPE, weights=qwen["weights"])
    runs4 = [dict(steps=4, ckpt_every=2, dir=str(base / "a")),
             dict(steps=6, ckpt_every=2, dir=str(base / "a")),
             dict(steps=6, ckpt_every=2, dir=str(base / "c"))]
    (base / "w4").mkdir()
    join4 = start_ranks("train_fsdp", {"steps": _steps_input(inputs, ["qwen3-0.6b"]),
                                       "trainers": {"q": dict(trainer, runs=runs4)}},
                        4, base / "w4")
    cases = {"qwen3-0.6b": _case("qwen3-0.6b", qwen)}
    w4 = join4()
    shutil.copytree(base / "c", base / "r")
    inputs["granite-moe-3b-a800m"] = _one_device_case("granite-moe-3b-a800m")
    steps2 = _steps_input(inputs, ["qwen3-0.6b", "mamba2-2.7b", "granite-moe-3b-a800m"])
    (base / "w2").mkdir()
    join2 = start_ranks("train_fsdp", {"steps": steps2, "trainers": {"q": dict(
        trainer, runs=[dict(steps=8, ckpt_every=2, dir=str(base / "r"),
                            probe_restore=True)])}}, 2, base / "w2")
    cases["mamba2-2.7b"] = _case("mamba2-2.7b", inputs["mamba2-2.7b"])
    cases["granite-moe-3b-a800m"] = inputs["granite-moe-3b-a800m"]
    return {4: w4, 2: join2(), "dirs": base, "cases": cases}


@pytest.fixture(scope="module")
def cases(worlds):
    return worlds["cases"]


def _check_steps(res, case):
    for s in range(STEPS):
        for k in ("loss", "grad_norm"):
            for want in (case["one"][s][k], case["ref"][s][k]):
                np.testing.assert_allclose(res["metrics"][s][k], want, rtol=METRIC_RTOL,
                                           err_msg=f"step {s} {k}")
    for path, whole in res["whole"].items():
        np.testing.assert_allclose(whole.numpy(), case["one_params"][path].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=path)
        np.testing.assert_allclose(whole.numpy(), case["ref_params"][path].numpy(), rtol=0,
                                   atol=REF_PARAM_ATOL, err_msg=path)


@pytest.mark.parametrize("world", [2, 4])
def test_fsdp_qwen3_matches_one_device_and_reference(cases, worlds, world):
    ranks = [r["train_fsdp"] if "train_fsdp" in r else r for r in worlds[world]]
    res = [r["qwen3-0.6b"] for r in ranks]
    _check_steps(res[0], cases["qwen3-0.6b"])
    for r in res[1:]:          # the loss is the ranks' mean: the same bits everywhere
        assert r["metrics"] == res[0]["metrics"]
        for path, t in r["whole"].items():
            assert torch.equal(t, res[0]["whole"][path]), path


@pytest.mark.parametrize("world", [2, 4])
def test_fsdp_blocks_follow_param_specs(worlds, world):
    res = [r["qwen3-0.6b"] for r in worlds[world]]
    n_sharded = 0
    for rank, r in enumerate(res):
        mesh = Mesh({"data": world, "model": 1}, DecodeCtx(None, rank, world, "gloo"))
        for path, t in r["local"].items():
            spec, whole = r["specs"][path], r["whole"][path]
            assert tuple(t.shape) == local_shape(mesh, spec, whole.shape), path
            assert torch.equal(t, whole[local_block(mesh, spec, whole.shape)]), path
            if "data" not in spec:
                assert torch.equal(t, res[0]["local"][path]), path   # replicated: same bits
            elif rank == 0:
                n_sharded += 1
                assert t.numel() * world == whole.numel(), path
    assert n_sharded > 0
    # per step: a gather and a reduce-scatter a sharded leaf, an all-reduce a
    # replicated leaf, the loss and the norm's sums of squares
    n = len(res[0]["local"])
    assert res[0]["collectives"] == {"all_gather": n_sharded, "reduce_scatter": n_sharded,
                                     "all_reduce": n - n_sharded + 2}


def test_fsdp_mamba2_two_ranks(cases, worlds):
    _check_steps(worlds[2][0]["mamba2-2.7b"], cases["mamba2-2.7b"])
    assert worlds[2][0]["mamba2-2.7b"]["metrics"] == worlds[2][1]["mamba2-2.7b"]["metrics"]


def test_fsdp_moe_over_two_ranks_raises(cases, worlds):
    """MoE over two data ranks, which raised until its load-balancing loss
    was taken over the global batch, trains: the same metrics on both
    ranks, within `METRIC_RTOL` of the one-device step's, its parameters
    within `PARAM_ATOL`."""
    case, res = cases["granite-moe-3b-a800m"], [r["granite-moe-3b-a800m"] for r in worlds[2]]
    assert "raised" not in res[0], res[0].get("raised")
    assert res[0]["metrics"] == res[1]["metrics"]
    for s in range(STEPS):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(res[0]["metrics"][s][k], case["one"][s][k],
                                       rtol=METRIC_RTOL, err_msg=f"step {s} {k}")
    for path, whole in res[0]["whole"].items():
        np.testing.assert_allclose(whole.numpy(), case["one_params"][path].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=path)


def test_fsdp_trainer_resumes_bitwise_on_four_ranks(worlds):
    for r in worlds[4]:
        a, b, c = r["q"]
        assert a["final_step"] == 4 and b["final_step"] == 6 and c["final_step"] == 6
        assert b["steps"] == [4, 5]
        assert b["losses"] == c["losses"][4:] and b["grad_norms"] == c["grad_norms"][4:]
        assert a["losses"] == c["losses"][:4]
        assert r["q"] == worlds[4][0]["q"]          # every rank agrees


def test_fsdp_four_rank_checkpoint_restores_onto_two(cases, worlds, tmp_path):
    with np.load(worlds["dirs"] / "c" / "step_6" / "arrays.npz") as z:
        stored = {k: z[k] for k in z.files}
    for rank, r in enumerate(worlds[2]):
        run = r["q"][0]
        mesh = Mesh({"data": 2, "model": 1}, DecodeCtx(None, rank, 2, "gloo"))
        assert run["restored"] is not None
        for path, t in run["restored"].items():
            arr = stored[f"params/{path}"]
            want = arr[local_block(mesh, run["specs"][path], arr.shape)]
            assert np.array_equal(t.numpy(), want), (rank, path)
        assert run["steps"] == [6, 7] and run["final_step"] == 8
    # training continues: steps 6-7 on 2 ranks against 8 one-device steps
    _, tcfg = _cfgs("qwen3-0.6b")
    weights = cases["qwen3-0.6b"]["weights"]
    one = Trainer(tcfg, ShapeConfig(**SHAPE), None,
                  TrainerConfig(num_steps=8, ckpt_every=100, ckpt_dir=str(tmp_path),
                                log_every=100),
                  AdamWConfig(**OPT), device="cpu", init_params=lambda: weights).train()
    np.testing.assert_allclose(worlds[2][0]["q"][0]["losses"], one["losses"][6:],
                               rtol=METRIC_RTOL)
    np.testing.assert_allclose(worlds[4][0]["q"][2]["losses"], one["losses"][:6],
                               rtol=METRIC_RTOL)
