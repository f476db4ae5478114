"""Port parity, the training half of `distributed/sharding.py`, `MeshPlan`,
`batch_specs` and the sharded train step at one rank, against the JAX
package on the CPU.

* `param_specs` entry for entry with the reference's for every name in
  `ARCH_NAMES`, on meshes (16, 16), (2, 16, 16), (8, 1) and (1, 8), in train
  mode (``tp`` and ``cp`` strategies, ``ep`` and ``tp`` MoE strategies) and
  decode mode; the reference's shapes from ``jax.eval_shape`` handed to the
  port as a ``{path: shape}`` mapping (no full-width tree is built).
* Each reduced config's port tree (one dict per layer, from the meta
  device) against the reference's stacked tree: the same leaves, each
  shape the reference's without its stacked dim, each spec the reference's
  without its leading None.
* `fit_spec` on the reference's `test_fit_spec_drops_nondivisible` cases;
  `MeshPlan.decode_axes` and `batch_specs` against the reference's.
* Placement: `Mesh` coordinates in jax's row-major device order,
  `local_block` / `shard` / `gather` at one rank; the ``constrain*`` hints.
* The model axis: the dense and MoE families build their steps on it (the
  MoE experts or their d_ff over "model"), MoE builds over two data ranks,
  and the SSD family refuses it, naming its ROADMAP item.
* The sharded step and `Trainer(plan=...)` on a (1, 1) mesh over the
  in-process gloo world of one: losses, gradient norms and parameters bit
  for bit with the one-device step and trainer, and a checkpoint restored
  through `restore(shardings=)` bit for bit (the CPU rehearsal of chip_smoke
  run (am)).

Run alone: ~15 s on this container's CPU.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from _torch_bridge import f32_configs
from repro.configs import ARCH_NAMES
from repro.configs import get_config as jget_config
from repro.configs.base import ShapeConfig as JShape
from repro.distributed.sharding import ShardingCtx as JCtx
from repro.distributed.sharding import fit_spec as jfit_spec
from repro.distributed.sharding import param_specs as jparam_specs
from repro.distributed.sharding import path_of as jpath_of
from repro.models import get_model as jget_model
from repro.runtime.data import make_batch as jmake_batch
from repro.runtime.steps import MeshPlan as JPlan
from repro.runtime.steps import batch_specs as jbatch_specs
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import (
    DecodeCtx, Mesh, NamedSharding, P, ShardingCtx, activation_sharding, constrain,
    constrain_qkv, constrain_residual, fit_spec, gather, local_block, param_specs, shard)
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.runtime import AdamWConfig, CheckpointManager, Trainer, TrainerConfig
from repro_torch.runtime.data import to_device
from repro_torch.runtime.optimizer import init_opt_state
from repro_torch.runtime.steps import MeshPlan, batch_specs, make_train_step
from repro_torch.runtime.tree import leaves
from repro_torch.weights import init_lm_params, params_from_numpy


class FakeMesh:
    """The reference tests' mesh stand-in: prescribed axis sizes."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "8x1": {"data": 8, "model": 1}, "1x8": {"data": 1, "model": 8}}
# (mode, strategy, moe_strategy)
CTXS = [("train", "tp", "ep"), ("train", "cp", "ep"), ("train", "tp", "tp"),
        ("train", "cp", "tp"), ("decode", "tp", "ep"), ("decode", "cp", "ep")]


@functools.lru_cache(maxsize=None)
def _jshapes(arch: str, reduced: bool = False) -> dict:
    """The reference's {path: shape} from `jax.eval_shape` of its init."""
    cfg = jget_config(arch)
    if reduced:
        cfg = cfg.reduced()
    tree = jax.eval_shape(jget_model(cfg).init, jax.random.PRNGKey(0))
    return {jpath_of(kp): tuple(leaf.shape)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ctxs(shape, mode, strategy, moe_strategy):
    dp = tuple(a for a in shape if a != "model")
    kw = dict(dp=dp, strategy=strategy, moe_strategy=moe_strategy, mode=mode)
    if mode == "decode":
        kw.update(fsdp_axes=(), wide2d=dp)
    return JCtx(mesh=FakeMesh(shape), **kw), ShardingCtx(mesh=FakeMesh(shape), **kw)


def _jspecs(jctx, shapes: dict) -> dict:
    # one level of keys, each a whole "/"-joined path, which the rules match
    tree = {p: jax.ShapeDtypeStruct(s, np.float32) for p, s in shapes.items()}
    return {p: tuple(sp) for p, sp in jparam_specs(jctx, tree).items()}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_match_reference(arch):
    shapes = _jshapes(arch)
    for mesh_name, mesh in MESHES.items():
        for mode, strategy, moe in CTXS:
            jctx, tctx = _ctxs(mesh, mode, strategy, moe)
            want = _jspecs(jctx, shapes)
            got = param_specs(tctx, shapes)
            assert list(got) == list(want)
            for path in want:
                assert isinstance(got[path], P)
                assert got[path] == want[path], (mesh_name, mode, strategy, moe, path,
                                                 got[path], want[path])


def _port_paths(cfg, jshapes: dict) -> dict:
    """The reference's stacked leaves as the port's per-layer paths →
    (port shape, reference path, stacked?)."""
    pattern = len(cfg.layer_pattern)
    n_periods = next((s[0] for p, s in jshapes.items() if p.startswith("periods/")), 0)
    out = {}
    for path, shape in jshapes.items():
        parts = path.split("/")
        if parts[0] == "periods":
            for j in range(shape[0]):
                out["/".join(["layers", str(j * pattern + int(parts[1]))] + parts[2:])] = (
                    shape[1:], path, True)
        elif parts[0] == "tail":
            out["/".join(["layers", str(n_periods * pattern + int(parts[1]))] + parts[2:])] = (
                shape, path, False)
        elif parts[0] in ("enc", "dec") and cfg.encdec:
            for j in range(shape[0]):
                out["/".join([parts[0], str(j)] + parts[1:])] = (shape[1:], path, True)
        else:
            out[path] = (shape, path, False)
    return out


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_reduced_port_tree_and_specs_match_reference(arch):
    jshapes = _jshapes(arch, reduced=True)
    cfg = tget_config(arch).reduced()
    tree = init_lm_params(cfg, None, "meta")
    port = {p: tuple(t.shape) for p, t in leaves(tree)}
    mapped = _port_paths(cfg, jshapes)
    assert set(port) == set(mapped)
    for path, (shape, _, _) in mapped.items():
        assert port[path] == shape, path
    for mesh in (MESHES["8x1"], MESHES["16x16"], {"data": 2, "model": 1}):
        jctx, tctx = _ctxs(mesh, "train", cfg.attn_strategy, cfg.moe_strategy)
        want = _jspecs(jctx, jshapes)
        got = dict(zip((p for p, _ in leaves(tree)), _spec_leaves(param_specs(tctx, tree))))
        for path, (_, jpath, stacked) in mapped.items():
            ref = want[jpath]
            if stacked:
                assert ref[0] is None, (jpath, ref)
                ref = ref[1:]
            assert got[path] == ref, (mesh, path, got[path], ref)


def _spec_leaves(specs):
    if isinstance(specs, P):
        yield specs
    elif isinstance(specs, dict):
        for v in specs.values():
            yield from _spec_leaves(v)
    else:
        for v in specs:
            yield from _spec_leaves(v)


def test_fit_spec_drops_nondivisible():
    """The reference's `test_fit_spec_drops_nondivisible`, on the port."""
    mesh = FakeMesh(MESHES["16x16"])
    cases = [((None, "model", None), (4096, 8, 128)), ((None, "model", None), (4096, 32, 128)),
             ((("data", "model"),), (512,)), ((("data", "model"),), (100,)),
             ((("data",), ()), (32, 4)), (("data",), (32, 4, 2))]
    for spec, shape in cases:
        assert fit_spec(mesh, P(*spec), shape) == tuple(jfit_spec(mesh, JP(*spec), shape))
    assert fit_spec(mesh, P(None, "model", None), (4096, 8, 128)) == (None, None, None)
    assert fit_spec(mesh, P(("data", "model"),), (100,)) == (None,)
    assert fit_spec(mesh, P(("data",), ()), (32, 4)) == ("data", None)


@pytest.mark.parametrize("mesh_name", ["16x16", "2x16x16", "8x1", "1x8"])
def test_plan_decode_axes_and_batch_specs_match_reference(mesh_name):
    mesh = FakeMesh(MESHES[mesh_name])
    dp = tuple(a for a in mesh.axis_names if a != "model")
    plan, jplan = MeshPlan(mesh=mesh, dp=dp), JPlan(mesh=mesh, dp=dp)
    assert MeshPlan.for_mesh(mesh).dp == JPlan.for_mesh(mesh).dp == dp
    for b in (1, 2, 3, 8, 16, 32, 128, 256):
        assert plan.decode_axes(b) == jplan.decode_axes(b), b
        assert plan.decode_seq_axes(b) == jplan.decode_seq_axes(b)
    for arch in ("qwen3-0.6b", "whisper-small", "llava-next-mistral-7b"):
        for b in (4, 6, 32):
            batch = jmake_batch(jget_config(arch).reduced(), JShape("t", 64, b, "train"), 0, 0)
            want = {k: tuple(v) for k, v in jbatch_specs(mesh, batch, dp).items()}
            assert batch_specs(mesh, batch, dp) == want, (arch, b)


def test_mesh_coords_blocks_and_constrain():
    """Ranks fill a mesh in row-major order (jax's device order); a rank's
    block of a dim split over two axes is at the flattened index; the
    hints return their inputs where no data moves: the residual's layout
    kept, and a sequence that is already whole (a model axis above 1 moves
    data over its group: tests/test_torch_tp_layers.py)."""
    mesh = Mesh({"pod": 2, "data": 2, "model": 1}, DecodeCtx(None, 3, 4, "gloo"))
    assert mesh.coords == {"pod": 1, "data": 1, "model": 0}
    assert mesh.coords_of(2) == {"pod": 1, "data": 0, "model": 0}
    assert local_block(mesh, P(("pod", "data"), None), (8, 3)) == (slice(6, 8), slice(0, 3))
    assert local_block(mesh, P(None, "data"), (3, 8)) == (slice(0, 3), slice(4, 8))
    with pytest.raises(ValueError, match="split evenly"):
        local_block(mesh, P("data"), (3,))
    with pytest.raises(ValueError, match="needs 4 ranks"):
        Mesh({"data": 4}, DecodeCtx(None, 0, 2, "gloo"))
    x = torch.arange(24.0).reshape(8, 3)
    assert torch.equal(shard(x, P(("pod", "data"), None), mesh), x[6:8])
    ctx = ShardingCtx(mesh=FakeMesh({"data": 2, "model": 1}), dp=("data",))
    h = torch.zeros(3, 5, 4)
    assert constrain(h, "dp", None) is h                 # no ambient context
    with activation_sharding(ctx, local_batch=3):
        assert constrain_residual(h) is h
        q = torch.zeros(3, 5, 2, 4)
        assert all(a is q for a in constrain_qkv(q, q, q))
        with pytest.raises(ValueError, match="holds 2 rows"):
            with activation_sharding(ctx, local_batch=2):
                constrain_residual(h)
    tp = ShardingCtx(mesh=FakeMesh({"data": 1, "model": 2}), dp=("data",))
    with activation_sharding(tp):
        assert constrain_residual(h, split=True) is h
        assert constrain(h, "dp", None, None) is h


def test_train_step_refuses_model_axis_and_moe_over_data():
    """The dense and MoE families take a model axis (heads, d_ff and vocab
    split over it; the experts under ``ep``, their d_ff under expert-TP)
    and MoE takes more than one data rank, both of which it refused until
    its layouts were ported; so do the SSD (its heads over "model") and the
    RG-LRU (its channels), and the enc-dec family still refuses a model
    axis, naming the ROADMAP item that carries it."""
    _, tcfg = f32_configs()
    tp = MeshPlan.for_mesh(Mesh({"data": 1, "model": 2}, DecodeCtx(None, 0, 2, "gloo")))
    step = make_train_step(tcfg, tp, device="cpu")
    assert step.model_dim["layers/0/attn/wq"] == 1 and step.model_dim["embed/tok"] == 0
    moe = dataclasses.replace(tget_config("granite-moe-3b-a800m").reduced(), dtype="float32")
    step = make_train_step(moe, tp, device="cpu")
    assert step.model_dim["layers/0/ffn/moe/w_gate"] == 0
    assert step.model_dim["layers/0/ffn/moe/router"] is None
    step = make_train_step(dataclasses.replace(moe, moe_strategy="tp"), tp, device="cpu")
    assert step.model_dim["layers/0/ffn/moe/w_gate"] == 2
    assert step.model_dim["layers/0/ffn/moe/w_down"] == 1
    dp2 = MeshPlan.for_mesh(Mesh({"data": 2, "model": 1}, DecodeCtx(None, 1, 2, "gloo")))
    step = make_train_step(moe, dp2, device="cpu")
    assert step.layout["layers/0/ffn/moe/w_gate"][2] == 1       # d_model over the data axis
    ssd = dataclasses.replace(tget_config("mamba2-2.7b").reduced(), dtype="float32")
    step = make_train_step(ssd, tp, device="cpu")
    assert step.model_dim["layers/0/ssd/w_x"] == 1 and step.model_dim["layers/0/ssd/w_B"] is None
    with pytest.raises(NotImplementedError, match="the SSD layers hold whole heads"):
        make_train_step(dataclasses.replace(ssd, ssm_head_dim=256), tp, device="cpu")  # 1 head
    rg = dataclasses.replace(tget_config("recurrentgemma-2b").reduced(), dtype="float32")
    step = make_train_step(rg, tp, device="cpu")
    assert step.model_dim["layers/0/rglru/w_r"] == 0 and step.model_dim["layers/0/rglru/lam"] == 0
    encdec = dataclasses.replace(tget_config("whisper-small").reduced(), dtype="float32")
    with pytest.raises(NotImplementedError, match="ROADMAP A item 1's next slice: "):
        make_train_step(encdec, tp, device="cpu")


# --------------------------------------------------------------------------
# one rank: the sharded step and trainer against the one-device ones
# --------------------------------------------------------------------------

OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)
SHAPE = dict(name="t", seq_len=64, global_batch=2, kind="train")


@pytest.fixture(scope="module")
def one_rank():
    """qwen3-0.6b.reduced() at f32 from the reference's init, and a plan on
    a (1, 1) mesh over the in-process gloo world of one."""
    jcfg, tcfg = f32_configs()
    tree = jax.tree_util.tree_map(np.asarray,
                                  jax.jit(jget_model(jcfg).init)(jax.random.PRNGKey(0)))
    plan = MeshPlan.for_mesh(make_data_mesh("cpu"))
    assert plan.mesh.shape == {"data": 1, "model": 1}
    return tcfg, (lambda: params_from_numpy(tree, tcfg, "cpu")), plan


def test_sharded_step_at_one_rank_bitwise_with_one_device(one_rank):
    from repro_torch.distributed.sharding import COLLECTIVES
    tcfg, init, plan = one_rank
    opt_cfg = AdamWConfig(**OPT)
    one, sharded = make_train_step(tcfg, None, opt_cfg, "cpu"), \
        make_train_step(tcfg, plan, opt_cfg, "cpu")
    p1 = init()
    o1 = init_opt_state(p1, opt_cfg)
    p2 = sharded.shard(init())
    o2 = init_opt_state(p2, opt_cfg)
    COLLECTIVES.clear()
    for s in range(3):
        batch = jmake_batch(jget_config("qwen3-0.6b").reduced(), JShape(**SHAPE), 0, s)
        p1, o1, m1 = one(p1, o1, to_device(batch, "cpu"))
        p2, o2, m2 = sharded(p2, o2, to_device(sharded.local_batch(batch), "cpu"))
        for k in ("loss", "grad_norm", "lr"):
            assert float(m1[k]) == float(m2[k]), (s, k)
    for (name, a), (_, b) in zip(leaves((p1, o1)), leaves((p2, o2))):
        assert torch.equal(a, b), name
    # each collective over the one rank: a gather and a reduce-scatter per
    # sharded leaf, an all-reduce per replicated leaf, the loss, the norm
    n_sharded = sum(d is not None for _, _, d in sharded.layout.values())
    assert COLLECTIVES["all_gather"] == COLLECTIVES["reduce_scatter"] == 3 * n_sharded
    assert COLLECTIVES["all_reduce"] == 3 * (len(sharded.layout) - n_sharded + 2)


def test_sharded_trainer_at_one_rank_and_restore(one_rank, tmp_path):
    tcfg, init, plan = one_rank

    def trainer(p, d, steps):
        return Trainer(tcfg, ShapeConfig(**SHAPE), p,
                       TrainerConfig(num_steps=steps, ckpt_every=2, ckpt_dir=str(tmp_path / d),
                                     keep_n=3, log_every=100),
                       AdamWConfig(**OPT), device="cpu", init_params=init)
    one, tr = trainer(None, "one", 4), trainer(plan, "sharded", 4)
    out1, out2 = one.train(), tr.train()
    assert out1["losses"] == out2["losses"] and out2["final_step"] == 4
    assert [m["grad_norm"] for m in one.metrics] == [m["grad_norm"] for m in tr.metrics]
    # the sharded checkpoint is the whole tree; restored through its shardings
    shard_tree = tr._shardings()
    assert isinstance(shard_tree["params"]["embed"]["tok"], NamedSharding)
    params, opt = tr.init_state()
    step, restored = CheckpointManager(str(tmp_path / "sharded")).restore(
        {"params": params, "opt": opt}, shardings=shard_tree)
    _, want = CheckpointManager(str(tmp_path / "one")).restore({"params": params, "opt": opt})
    assert step == 4
    for (name, a), (_, b) in zip(leaves(restored), leaves(want)):
        assert torch.equal(a, b), name
    # the blocks gathered back at one rank are the blocks themselves
    tok = restored["params"]["embed"]["tok"]
    assert gather(tok, P(None, "model"), plan.mesh) is tok
