"""The sharded train step (`runtime.steps.ShardedTrainStep`) on data × model
meshes, and the `Trainer`'s checkpoints across them, on 2 and 4 spawned
gloo ranks (`tests/_torch_dist_worker.py train_tp`: a world of 2 with the
(1, 2) mesh, a world of 4 with the (1, 4) and (2, 2) meshes, built in one
order on every rank), against the port's one-device step, which
tests/test_torch_train_loop.py and tests/test_torch_fsdp_train.py hold to
the JAX package, and, where it compiles on forced host devices, against
the reference's jitted step on the same mesh (`tests/_torch_tp_reference.py`,
a subprocess with 4 host devices: `REF_CASES`).

* qwen3-0.6b.reduced() on (1, 2), (1, 4) and (2, 2); phi3-medium-14b (cp)
  on (1, 2) and (2, 2); gemma3-12b (its window cut to 24 so that it binds at
  T 64) and llava-next-mistral-7b (8 image rows) on (1, 2); f32, 3 steps of
  a global batch of 4 × 64 tokens from the same whole weights (for
  `REF_CASES` the reference's ``init(PRNGKey(0))`` through
  `params_from_numpy`, else the port's `init_lm_params` from seed 0):
  - every leaf's step-0 gradient (reduced, gathered whole) within
    `GRAD_RTOL` of that leaf's largest magnitude: a missed or doubled sum
    over "model" moves a leaf by O(1) of it;
  - losses and gradient norms within `STEP0_RTOL` at step 0 and
    `METRIC_RTOL` after, parameters within
    `PARAM_ATOL`, the metrics the same bits on every rank;
  - every local block has the shape that `param_specs` gives and is that
    block of the whole; a leaf replicated over an axis carries the same
    bits on every rank of that axis;
  - the collectives of a step equal `expected_collectives`;
  - for `REF_CASES` (qwen3-0.6b on (1, 4), its KV replicated, phi3 on
    (1, 2), cp, and mamba2 and recurrentgemma on (1, 4)), losses and norms
    within `METRIC_RTOL` and parameters within `REF_PARAM_ATOL` of the
    reference's jitted step on the same mesh.
* mamba2-2.7b (SSD) and recurrentgemma-2b (RG-LRU, cut to one "RRL"
  period) on (1, 2), (1, 4) and (2, 2) as the dense cases, and on (1, 4)
  against the reference (`REF_CASES`).
* whisper-small (reduced) on (1, 2) raises and names `MODEL_AXIS_ITEM`
  (ROADMAP A item 1's next slice); granite-moe-3b-a800m, mamba2-2.7b and
  recurrentgemma-2b, which raised there too until their layouts were
  ported, train on (1, 2) within the tolerances below of the one-device
  step (tests/test_torch_moe_train.py holds the MoE family on every mesh).
* Checkpoints: a (1, 4) `Trainer` resumed from its own checkpoint
  continues bit for bit with the uninterrupted run; a (1, 4) run's step-6
  checkpoint restored onto (2, 2) gives each rank exactly its block of the
  stored arrays, and training continues from it (steps 6-7 within
  `METRIC_RTOL` of the (1, 4) run's).

Run alone: ~45 s on this container's CPU (the reference's two subprocesses
run beside the one-device steps and the spawned worlds).
"""

import dataclasses
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_bridge import spawn_ranks, start_ranks
from repro.configs import get_config as jget_config
from repro.models import get_model as jget_model
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.sharding import MODEL_AXIS_ITEM, DecodeCtx, Mesh, local_block
from repro_torch.models import get_model
from repro_torch.runtime import AdamWConfig
from repro_torch.runtime.data import make_batch, to_device
from repro_torch.runtime.optimizer import init_opt_state
from repro_torch.runtime.steps import _loss_and_grads, make_train_step
from repro_torch.runtime.tree import leaves
from repro_torch.weights import init_lm_params, params_from_numpy

OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)
SHAPE = dict(name="t", seq_len=64, global_batch=4, kind="train")
STEPS = 3
# f32 sums over d_ff, heads, vocab columns and ranks in another order
# (measured ≤ 3e-6 of a leaf's largest magnitude)
GRAD_RTOL = 2e-5
# step 0's loss and gradient norm: f32 sums in another order (measured ≤ 1e-7)
STEP0_RTOL = 1e-6
# steps 1-2 are taken at parameters that AdamW already moved apart (below):
# measured ≤ 1.3e-5 (gemma3's 12 layers), ≤ 2.6e-6 on the 2-layer configs
METRIC_RTOL = 5e-5
# three AdamW steps at lr 3e-3: Adam's normalised update turns a rounding of
# a near-zero gradient element into a move of up to lr; measured ≤ 7.7e-5
PARAM_ATOL = 3e-4
# the same against the reference, whose one-device step the port's own
# one-device step already parts from (XLA's fusions; PR 33 read ≤ 3e-5)
REF_PARAM_ATOL = 3e-4
# recurrentgemma cut to one "RRL" period
OVER = {"gemma3-12b": dict(local_window=24), "recurrentgemma-2b": dict(num_layers=3)}
SSD, RGLRU = "mamba2-2.7b", "recurrentgemma-2b"
CASES = [("qwen3-0.6b", (1, 2)), ("qwen3-0.6b", (1, 4)), ("qwen3-0.6b", (2, 2)),
         ("phi3-medium-14b", (1, 2)), ("phi3-medium-14b", (2, 2)), ("gemma3-12b", (1, 2)),
         ("llava-next-mistral-7b", (1, 2)), (SSD, (1, 2)), (SSD, (1, 4)), (SSD, (2, 2)),
         (RGLRU, (1, 2)), (RGLRU, (1, 4)), (RGLRU, (2, 2))]
REFUSED = ["whisper-small"]
MOE = "granite-moe-3b-a800m"
# the families that refused the model axis until their layouts were ported
PORTED = [MOE, SSD, RGLRU]
REF_CASES = [("qwen3-0.6b", (1, 4)), ("phi3-medium-14b", (1, 2)), (SSD, (1, 4)), (RGLRU, (1, 4))]
REFERENCE = pathlib.Path(__file__).resolve().parent / "_torch_tp_reference.py"


def _cfg(arch, get=get_config):
    return dataclasses.replace(get(arch).reduced(), dtype="float32", **OVER.get(arch, {}))


def _reference_tree(arch):
    """The reference's ``init(PRNGKey(0))`` as numpy, and its treedef."""
    tree = jax.jit(jget_model(_cfg(arch, jget_config)).init)(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(arch):
    """Whole weights and the global batches (for `REF_CASES` the
    reference's init tree too)."""
    cfg = _cfg(arch)
    tree = _reference_tree(arch) if arch in {a for a, _ in REF_CASES} else None
    weights = (params_from_numpy(tree, cfg, "cpu") if tree is not None
               else init_lm_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    batches = [make_batch(cfg, ShapeConfig(**SHAPE), 1, s) for s in range(STEPS)]
    return dict(weights=weights, batches=batches, tree=tree)


def _one_device(arch, inp):
    """The one-device step's step-0 gradients, metrics and final parameters."""
    cfg = _cfg(arch)
    weights, batches = inp["weights"], inp["batches"]
    grads, _ = _loss_and_grads(get_model(cfg), weights, to_device(batches[0], "cpu"))
    step = make_train_step(cfg, None, AdamWConfig(**OPT), "cpu")
    p, o, metrics = weights, init_opt_state(weights, AdamWConfig(**OPT)), []
    for b in batches:
        p, o, m = step(p, o, to_device(b, "cpu"))
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(inp, grads=dict(leaves(grads)), metrics=metrics, params=dict(leaves(p)))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's steps, started first: two subprocesses (the dense
    cases, the recurrent ones) run beside the one-device steps and the
    spawned worlds."""
    base = tmp_path_factory.mktemp("tp_reference")
    recurrent = (SSD, RGLRU)
    out = []
    for i, part in enumerate(([c for c in REF_CASES if c[0] not in recurrent],
                              [c for c in REF_CASES if c[0] in recurrent])):
        path = base / f"ref{i}.npz"
        out.append((subprocess.Popen([sys.executable, str(REFERENCE), str(path),
                                      *(f"{a}:{m[0]}x{m[1]}" for a, m in part)],
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True), path))
    return out


@pytest.fixture(scope="module")
def worlds(reference, tmp_path_factory):
    """The 2-rank world, with the one-device steps run here meanwhile (one
    thread: the reference's subprocess and the ranks share the CPU), then
    the 4-rank world."""
    base = tmp_path_factory.mktemp("tp_train")
    inputs = {arch: _inputs(arch) for arch in sorted({a for a, _ in CASES} | {MOE})}

    def steps(mesh):
        return {arch: dict(arch=arch, over=OVER.get(arch, {}), opt=OPT,
                           weights=inputs[arch]["weights"], batches=inputs[arch]["batches"])
                for arch, shape in CASES if shape == mesh}
    w2 = steps((1, 2))
    for arch in REFUSED:
        w2[arch] = dict(arch=arch, opt=OPT, weights=None, batches=[])
    w2[MOE] = dict(arch=MOE, opt=OPT, weights=inputs[MOE]["weights"],
                   batches=inputs[MOE]["batches"])
    trainer = dict(arch="qwen3-0.6b", opt=OPT, shape=SHAPE,
                   weights=inputs["qwen3-0.6b"]["weights"])
    runs14 = [dict(steps=4, ckpt_every=2, dir=str(base / "a")),
              dict(steps=8, ckpt_every=2, dir=str(base / "a")),
              dict(steps=6, ckpt_every=2, dir=str(base / "c"))]
    # the (2, 2) trainer resumes from the (1, 4) run C's directory (C runs first)
    runs22 = [dict(steps=8, ckpt_every=2, dir=str(base / "c"), probe_restore=True)]
    (base / "w2").mkdir()
    (base / "w4").mkdir()
    join2 = start_ranks("train_tp", {"meshes": [(1, 2)], "steps": {(1, 2): w2}}, 2,
                        base / "w2")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {"one": {arch: _one_device(arch, inp) for arch, inp in inputs.items()}}
    finally:
        torch.set_num_threads(threads)
    out[2] = join2()
    inp4 = {"meshes": [(1, 4), (2, 2)], "steps": {(1, 4): steps((1, 4)), (2, 2): steps((2, 2))},
            "trainers": {(1, 4): {"q": dict(trainer, runs=runs14)},
                         (2, 2): {"q": dict(trainer, runs=runs22)}}}
    out[4] = spawn_ranks("train_tp", inp4, 4, base / "w4")
    out["ref"] = {}
    for ref, ref_out in reference:
        log = ref.communicate(timeout=300)[0]
        assert ref.returncode == 0, log
        with np.load(ref_out) as z:
            out["ref"].update({k: z[k] for k in z.files})
    out["dirs"] = base
    return out


@pytest.fixture(scope="module")
def one(worlds):
    return worlds["one"]


def _ranks(worlds, arch, mesh):
    return [r[(mesh, arch)] for r in worlds[mesh[0] * mesh[1]]]


@pytest.mark.parametrize("arch,mesh", CASES)
def test_step_matches_one_device(one, worlds, arch, mesh):
    ranks, want = _ranks(worlds, arch, mesh), one[arch]
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


@pytest.mark.parametrize("arch,mesh", CASES)
def test_blocks_follow_param_specs(worlds, arch, mesh):
    ranks = _ranks(worlds, arch, mesh)
    layout = Mesh({"data": mesh[0], "model": mesh[1]}, DecodeCtx(None, 0, len(ranks), "gloo"))
    split_over = {"data": 0, "model": 0}
    for rank, r in enumerate(ranks):
        coords = layout.coords_of(rank)
        mine = Mesh(layout.shape, DecodeCtx(None, rank, len(ranks), "gloo"))
        for path, t in r["local"].items():
            spec, whole = r["specs"][path], r["whole"][path]
            assert tuple(t.shape) == r["want_shapes"][path], (rank, path)
            assert torch.equal(t, whole[local_block(mine, spec, whole.shape)]), (rank, path)
            for axis in ("data", "model"):
                if axis in spec and layout.shape[axis] > 1:
                    split_over[axis] += rank == 0
                elif coords[axis] > 0:          # replicated over the axis: its bits
                    twin = layout.rank_of({**coords, axis: 0})
                    assert torch.equal(t, ranks[twin]["local"][path]), (rank, path, axis)
    if mesh[1] > 1:
        assert split_over["model"] > 0
    if mesh[0] > 1:
        assert split_over["data"] > 0


def expected_collectives(r, cfg, mesh) -> dict:
    """A step's collectives on a mesh whose model axis M > 1 divides T:
    over the data group one all-gather and one reduce-scatter per leaf split
    over the data axes and one all-reduce per leaf replicated over them, plus
    the loss's; over the model group one all-reduce per leaf replicated over
    "model" and the cross-entropy's three (max, sum, gold); over the whole
    world one for the norm's sums of squares. In the layers: the embedding's
    reduce-scatter and the head's gather, each with its backward's
    conjugate; per layer, once forward, again in the checkpointed
    recomputation (which stops after the layer's last saved activation, the
    w_down or w_out product, so the layer's closing reduce-scatter is not
    repeated) and once as the backward's conjugates (an all-gather's a
    reduce-scatter, a reduce-scatter's an all-gather, an all-reduce's an
    all-reduce):
    * a tp attention layer: two gathers (attention, GLU) and two
      reduce-scatters; a cp one: one gather of K and V, the GLU's gather and
      its reduce-scatter;
    * an "S" layer: the sequence's gather, the gated norm's sum of squares
      (an all-reduce) and the output's reduce-scatter;
    * an "R" layer: the sequence's gather, the two gates' reduce-scatters,
      the output's reduce-scatter, then the GLU's gather and reduce-scatter."""
    n = len(r["specs"])
    d = sum("data" in sp for sp in r["specs"].values())
    rm = sum("model" not in sp for sp in r["specs"].values())
    attn = (6, 5, 0) if cfg.attn_strategy == "tp" else (5, 3, 0)
    per_kind = {"A": attn, "L": attn, "S": (3, 2, 3), "R": (8, 9, 0)}
    gather, scatter, reduce = (sum(per_kind[k][i] for k in cfg.block_kinds()) for i in range(3))
    return {"all_gather": d + 2 + gather, "reduce_scatter": d + 2 + scatter,
            "all_reduce": (n - d) + 1 + rm + 3 + 1 + reduce}


@pytest.mark.parametrize("arch,mesh", CASES)
def test_collectives_per_step(worlds, arch, mesh):
    r = _ranks(worlds, arch, mesh)[0]
    assert r["collectives"] == expected_collectives(r, _cfg(arch), mesh)
    # each recorded in analysis.collectives.TRACE at its bytes, but those over
    # a group of one rank (the data group of a (1, M) mesh: its leaves' gathers
    # and reduce-scatters, the replicated leaves' and the loss's all-reduces)
    n, d = len(r["specs"]), sum("data" in sp for sp in r["specs"].values())
    one_rank = n + d + 1 if mesh[0] == 1 else 0
    assert sum(s["count"] for s in r["trace"].values()) == \
        STEPS * (sum(r["collectives"].values()) - one_rank)
    assert all(s["wire_bytes"] > 0 for s in r["trace"].values())


@pytest.mark.parametrize("arch", PORTED + REFUSED)
def test_other_families_refuse_the_model_axis(one, worlds, arch):
    """The enc-dec family raises on (1, 2), naming `MODEL_AXIS_ITEM`; the
    MoE, SSD and RG-LRU families train there: the same metrics on both
    ranks, within `STEP0_RTOL` at step 0 and `METRIC_RTOL` after of the
    one-device step's."""
    ranks = [r[((1, 2), arch)] for r in worlds[2]]
    if arch in REFUSED:
        for r in ranks:
            assert MODEL_AXIS_ITEM in r["raised"], arch
        return
    assert "raised" not in ranks[0], ranks[0].get("raised")
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    for s in range(STEPS):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(ranks[0]["metrics"][s][k], one[arch]["metrics"][s][k],
                                       rtol=STEP0_RTOL if s == 0 else METRIC_RTOL,
                                       err_msg=f"step {s} {k}")


def test_trainer_resumes_bitwise_on_1x4(worlds):
    for r in worlds[4]:
        a, b, c = r[((1, 4), "q")]
        assert a["final_step"] == 4 and b["final_step"] == 8 and c["final_step"] == 6
        assert b["steps"] == [4, 5, 6, 7]
        assert b["losses"][:2] == c["losses"][4:] and b["grad_norms"][:2] == c["grad_norms"][4:]
        assert a["losses"] == c["losses"][:4]
        assert r[((1, 4), "q")] == worlds[4][0][((1, 4), "q")]      # every rank agrees


def test_1x4_checkpoint_restores_onto_2x2(worlds):
    with np.load(worlds["dirs"] / "c" / "step_6" / "arrays.npz") as z:
        stored = {k: z[k] for k in z.files}
    for rank, r in enumerate(worlds[4]):
        run = r[((2, 2), "q")][0]
        mesh = Mesh({"data": 2, "model": 2}, DecodeCtx(None, rank, 4, "gloo"))
        assert run["restored"] is not None
        for path, t in run["restored"].items():
            arr = stored[f"params/{path}"]
            want = arr[local_block(mesh, run["specs"][path], arr.shape)]
            assert np.array_equal(t.numpy(), want), (rank, path)
        assert run["steps"] == [6, 7] and run["final_step"] == 8
    # training continues: steps 6-7 on (2, 2) against the (1, 4) run's
    np.testing.assert_allclose(worlds[4][0][((2, 2), "q")][0]["losses"],
                               worlds[4][0][((1, 4), "q")][1]["losses"][2:], rtol=METRIC_RTOL)


@pytest.mark.parametrize("arch,mesh", REF_CASES)
def test_step_matches_reference_on_the_same_mesh(one, worlds, arch, mesh):
    """The reference's jitted step under GSPMD on forced host devices."""
    case = f"{arch}:{mesh[0]}x{mesh[1]}"
    ref = worlds["ref"]
    r = _ranks(worlds, arch, mesh)[0]
    want = ref[f"{case}/metrics"]
    for s in range(STEPS):
        for i, k in enumerate(("loss", "grad_norm")):
            np.testing.assert_allclose(r["metrics"][s][k], want[s][i], rtol=METRIC_RTOL,
                                       err_msg=f"step {s} {k}")
    flat, treedef = jax.tree_util.tree_flatten_with_path(one[arch]["tree"])
    from repro.distributed.sharding import path_of
    tree = jax.tree_util.tree_unflatten(
        treedef, [ref[f"{case}/params/{path_of(kp)}"] for kp, _ in flat])
    final = dict(leaves(params_from_numpy(tree, _cfg(arch), "cpu")))
    for path, p in final.items():
        np.testing.assert_allclose(r["whole"][path].numpy(), p.numpy(), rtol=0,
                                   atol=REF_PARAM_ATOL, err_msg=path)
