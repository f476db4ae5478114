"""Port parity, the training loop against the JAX package on the CPU.

* (c) `adamw_update`: three steps on a mixed f32/bf16 tree against the
  reference's (parameters, moments and master within `OPT_TOL`, bf16
  parameters equal or one bf16 step apart), `lr_schedule` at warmup,
  mid-decay and the end, and the reference's two optimizer tests
  (`tests/test_runtime.py`) mirrored.
* (d) `make_batch` bit for bit with the reference's for the dense, enc-dec
  and vision families; `PrefetchIterator` yields the steps in order from
  ``start_step``, on the device asked for.
* (e) `CheckpointManager`: round trip with keep-N and bf16 (mirroring the
  reference's test), no ``.tmp`` directory left, an async save then
  ``wait``, a stray ``.tmp_step_*`` directory ignored by `latest_step`.
* (f) `Trainer` on qwen3-0.6b.reduced() at f32 (T 64, batch 2, 8 steps):
  its losses against the JAX `Trainer`'s on the same initial parameters and
  data stream (within `TRAIN_LOSS_TOL`); auto-resume to ``final_step``
  with the uninterrupted run's losses bit for bit; an injected non-finite
  loss recovers from the last checkpoint with one recovery and the same
  later losses; SIGTERM stops the loop and saves.
* (g) `launch/train.py`'s ``main()`` with ``--local --device cpu``.
* (b), the recurrent families: mamba2-2.7b and recurrentgemma-2b — the
  loss and every gradient leaf against ``jax.value_and_grad`` of the
  reference's loss (`_torch_bridge.check_loss_and_gradients`; the other
  five families are in tests/test_torch_train.py, which splits the time).

Run alone: ~40 s on this container's CPU.
"""

import dataclasses
import json
import os
import signal
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import check_loss_and_gradients
from repro.configs import get_config as jget_config
from repro.configs.base import ShapeConfig as JShape
from repro.launch.mesh import make_local_mesh
from repro.models import get_model as jget_model
from repro.runtime import AdamWConfig as JAdamWConfig
from repro.runtime import MeshPlan
from repro.runtime import Trainer as JTrainer
from repro.runtime import TrainerConfig as JTrainerConfig
from repro.runtime import adamw_update as jadamw_update
from repro.runtime import init_opt_state as jinit_opt_state
from repro.runtime import make_batch as jmake_batch
from repro.runtime.optimizer import lr_schedule as jlr_schedule
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import train as launcher
from repro_torch.runtime import (
    AdamWConfig, CheckpointManager, Trainer, TrainerConfig, adamw_update, init_opt_state,
    make_batch)
from repro_torch.runtime.data import PrefetchIterator
from repro_torch.runtime.optimizer import lr_schedule
from repro_torch.weights import params_from_numpy

# f32 on both sides; the global norm sums the leaves in another order (the
# reference's dicts flatten in sorted key order) and XLA may fuse an FMA
OPT_TOL = dict(rtol=1e-6, atol=1e-7)
# eight AdamW steps of a two-layer model: per-step gradients agree to ~1e-6
# relative (tests/test_torch_train.py); Adam's normalised update can turn a
# near-zero gradient's rounding into a sign, so the losses part by up to
# lr-sized moves of a few weights
TRAIN_LOSS_TOL = dict(rtol=2e-4, atol=0.0)
SHAPE = dict(name="t", seq_len=64, global_batch=2, kind="train")


# --------------------------------------------------------------------------
# (c) the optimizer
# --------------------------------------------------------------------------

def _tree(rng):
    return {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal((5,)).astype(np.float32),
                  "d": rng.standard_normal((2, 2)).astype(np.float32)}}


BF16 = ("b/c",)


def _port_tree(tree):
    return {"a": torch.from_numpy(tree["a"].copy()),
            "b": {"c": torch.from_numpy(tree["b"]["c"].copy()).to(torch.bfloat16),
                  "d": torch.from_numpy(tree["b"]["d"].copy())}}


def _jax_tree(tree):
    return {"a": jnp.asarray(tree["a"]),
            "b": {"c": jnp.asarray(tree["b"]["c"]).astype(jnp.bfloat16),
                  "d": jnp.asarray(tree["b"]["d"])}}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield prefix + k, (v.float().numpy() if torch.is_tensor(v)
                               else np.asarray(v, np.float32))


@pytest.mark.parametrize("use_master", [True, False])
def test_adamw_three_steps_match_reference(use_master):
    rng = np.random.default_rng(0)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, weight_decay=0.1, grad_clip=0.5,
              use_master=use_master)
    tcfg, jcfg = AdamWConfig(**kw), JAdamWConfig(**kw)
    params = _tree(rng)
    tp, jp = _port_tree(params), _jax_tree(params)
    tst, jst = init_opt_state(tp, tcfg), jinit_opt_state(jp, jcfg)
    for _ in range(3):
        grads = _tree(rng)
        tp, tst, tm = adamw_update(tp, _port_tree(grads), tst, tcfg)
        jp, jst, jm = jadamw_update(jp, _jax_tree(grads), jst, jcfg)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), **OPT_TOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), **OPT_TOL)
        assert int(tst.step) == int(jst.step)
        for (name, got), (_, want) in zip(_flat(tp), _flat(jp)):
            if name in BF16:     # the same f32 value may round to adjacent bf16 values
                np.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=0, err_msg=name)
            else:
                np.testing.assert_allclose(got, want, err_msg=name, **OPT_TOL)
        for field in ("m", "v") + (("master",) if use_master else ()):
            for (name, got), (_, want) in zip(_flat(getattr(tst, field)),
                                              _flat(getattr(jst, field))):
                np.testing.assert_allclose(got, want, err_msg=f"{field}/{name}", **OPT_TOL)
    assert tp["b"]["c"].dtype == torch.bfloat16 and tp["a"].dtype == torch.float32
    if use_master:
        assert tst.master["b"]["c"].dtype == torch.float32
        assert tst.master["a"].data_ptr() != tp["a"].data_ptr()


@pytest.mark.parametrize("step", [0, 1, 50, 100, 550, 1000, 10_000, 12_000])
def test_lr_schedule_matches_reference(step):
    kw = dict(lr=3e-4, warmup_steps=100, total_steps=10_000, min_lr_ratio=0.1)
    got = float(lr_schedule(AdamWConfig(**kw), torch.tensor(step, dtype=torch.int32)))
    want = float(jlr_schedule(JAdamWConfig(**kw), jnp.asarray(step, jnp.int32)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_init_opt_state_copies_f32_leaves():
    p = {"w": torch.ones(3), "h": torch.ones(2, dtype=torch.bfloat16)}
    st = init_opt_state(p, AdamWConfig())
    assert st.master["w"].data_ptr() != p["w"].data_ptr()
    assert st.master["h"].dtype == torch.float32 and int(st.step) == 0


def test_adamw_against_numpy_reference():
    """The reference's `test_adamw_against_numpy_reference`, on the port."""
    cfg = AdamWConfig(lr=1e-2, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0,
                      grad_clip=1e9, warmup_steps=0, total_steps=1,
                      min_lr_ratio=1.0, use_master=True)
    params = {"w": torch.tensor([1.0, -2.0, 3.0])}
    grads = {"w": torch.tensor([0.1, -0.2, 0.3])}
    new_params, _, metrics = adamw_update(params, grads, init_opt_state(params, cfg), cfg)
    g = np.asarray([0.1, -0.2, 0.3])
    m, v = 0.1 * g, 0.001 * g * g
    upd = (m / 0.1) / (np.sqrt(v / 0.001) + 1e-8)
    expect = np.asarray([1.0, -2.0, 3.0]) - 1e-2 * upd
    np.testing.assert_allclose(new_params["w"].numpy(), expect, rtol=1e-5)
    assert float(metrics["grad_norm"]) > 0


def test_grad_clipping():
    """The reference's `test_grad_clipping`, on the port."""
    cfg = AdamWConfig(grad_clip=0.1, warmup_steps=0, use_master=False)
    params = {"w": torch.zeros(4)}
    grads = {"w": torch.full((4,), 100.0)}
    _, _, metrics = adamw_update(params, grads, init_opt_state(params, cfg), cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)


# --------------------------------------------------------------------------
# (d) data
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-small", "llava-next-mistral-7b"])
def test_make_batch_bitwise_with_reference(arch):
    jcfg, tcfg = jget_config(arch).reduced(), tget_config(arch).reduced()
    for shape, reduced in ((SHAPE, False), (dict(SHAPE, seq_len=4096, global_batch=8), True)):
        for step in (0, 7):
            want = jmake_batch(jcfg, JShape(**shape), seed=3, step=step, reduced=reduced)
            got = make_batch(tcfg, ShapeConfig(**shape), seed=3, step=step, reduced=reduced)
            assert list(got) == list(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_prefetch_order_from_start_step():
    cfg = tget_config("qwen3-0.6b").reduced()
    shape = ShapeConfig(**SHAPE)
    it = PrefetchIterator(lambda s: make_batch(cfg, shape, 0, s), start_step=5, device="cpu")
    try:
        for want in range(5, 9):
            step, batch = next(it)
            assert step == want
            np.testing.assert_array_equal(batch["tokens"].numpy(),
                                          make_batch(cfg, shape, 0, want)["tokens"])
            assert batch["tokens"].device.type == "cpu"
    finally:
        it.close()


# --------------------------------------------------------------------------
# (e) checkpoints
# --------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_keep_n(tmp_path):
    """The reference's `test_checkpoint_roundtrip_and_keep_n`, on the port,
    with a list and a named tuple in the tree (the optimizer state's)."""
    mgr = CheckpointManager(str(tmp_path), keep_n=2, async_save=False)
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)},
            "l": [torch.zeros(2)],
            "opt": init_opt_state({"w": torch.ones(2)}, AdamWConfig())}
    from repro_torch.runtime.tree import tree_map
    for step in (10, 20, 30):
        mgr.save(step, tree_map(lambda x: x + step, tree), block=True)
    assert mgr.all_steps() == [20, 30]
    step, restored = mgr.restore(tree)
    assert step == 30
    np.testing.assert_allclose(restored["a"].numpy(),
                               np.arange(6, dtype=np.float32).reshape(2, 3) + 30)
    assert restored["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(restored["b"]["c"], torch.full((4,), 31.0, dtype=torch.bfloat16))
    assert int(restored["opt"].step) == 30 and restored["opt"].step.dtype == torch.int32
    assert torch.equal(restored["l"][0], torch.full((2,), 30.0))
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]
    # the layout: step_<N>/arrays.npz + meta.json with "/"-joined keys
    with np.load(tmp_path / "step_30" / "arrays.npz") as z:
        assert {"a", "b/c", "l/0", "opt/step", "opt/m/w", "opt/master/w"} <= set(z.files)
        assert z["b/c"].dtype == np.float32
    assert mgr.read_meta(30)["step"] == 30


def test_checkpoint_async_save_then_wait(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=3)
    tree = {"w": torch.arange(1000, dtype=torch.float32)}
    mgr.save(1, tree, meta={"arch": "x"})
    tree["w"].add_(1)                  # the save pulled its copy synchronously
    mgr.save(2, tree)
    mgr.wait()
    assert mgr.all_steps() == [1, 2]
    _, r1 = mgr.restore(tree, step=1)
    assert torch.equal(r1["w"], torch.arange(1000, dtype=torch.float32))
    assert mgr.read_meta(1)["arch"] == "x"


def test_latest_step_ignores_stray_tmp_dir(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(4, {"w": torch.ones(2)})
    os.makedirs(tmp_path / ".tmp_step_9_123")     # a save that died mid-write
    assert mgr.latest_step() == 4 and mgr.all_steps() == [4]


# --------------------------------------------------------------------------
# (f) the trainer
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = (dataclasses.replace(get("qwen3-0.6b").reduced(), dtype="float32")
                  for get in (jget_config, tget_config))
    jp = jax.jit(jget_model(jcfg).init)(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jp)
    return jcfg, tcfg, lambda: params_from_numpy(tree, tcfg, "cpu")


OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)


def _trainer(tcfg, init, ckpt_dir, steps, ckpt_every=4):
    return Trainer(tcfg, ShapeConfig(**SHAPE), None,
                   TrainerConfig(num_steps=steps, ckpt_every=ckpt_every, ckpt_dir=str(ckpt_dir),
                                 keep_n=2, log_every=100),
                   AdamWConfig(**OPT), device="cpu", init_params=init)


@pytest.fixture(scope="module")
def uninterrupted(model, tmp_path_factory):
    """The 10-step run with a checkpoint every 4 steps that the resumed and
    the recovering trainers are held to (its first 8 steps are the 8-step
    run's: the schedule and the batches do not depend on ``num_steps``)."""
    _, tcfg, init = model
    return _trainer(tcfg, init, tmp_path_factory.mktemp("uninterrupted"), 10).train()


def test_trainer_matches_reference_and_resumes(model, uninterrupted, tmp_path):
    jcfg, tcfg, init = model
    jout = JTrainer(jcfg, JShape(**SHAPE), MeshPlan.for_mesh(make_local_mesh()),
                    JTrainerConfig(num_steps=8, ckpt_every=4, ckpt_dir=str(tmp_path / "jax"),
                                   keep_n=2, log_every=100),
                    JAdamWConfig(**OPT)).train()
    out = _trainer(tcfg, init, tmp_path / "a", 8).train()
    assert out["final_step"] == 8 and out["recoveries"] == 0
    np.testing.assert_allclose(out["losses"], jout["losses"], **TRAIN_LOSS_TOL)
    assert np.mean(out["losses"][-3:]) < np.mean(out["losses"][:3])
    # auto-resume: a fresh trainer on the same directory continues from step
    # 8 and gives the uninterrupted 10-step run's losses bit for bit
    tr2 = _trainer(tcfg, init, tmp_path / "a", 10)
    out2 = tr2.train()
    full = uninterrupted
    assert out["losses"] == full["losses"][:8]
    assert out2["final_step"] == 10 and out2["losses"] == full["losses"][8:]
    assert CheckpointManager(str(tmp_path / "a")).all_steps() == [8, 10]
    assert [m["step"] for m in tr2.metrics] == [8, 9]
    assert all(np.isfinite(m["grad_norm"]) and m["lr"] > 0 for m in tr2.metrics)


def test_trainer_recovers_from_non_finite_loss(model, uninterrupted, tmp_path):
    _, tcfg, init = model
    clean = dict(losses=uninterrupted["losses"][:8])      # the 8-step run's
    tr = _trainer(tcfg, init, tmp_path / "nan", 8)
    real, calls = tr.step_fn, []

    def flaky(params, opt, batch):
        calls.append(len(calls))
        if len(calls) in (6, 7):        # the first attempts at steps 5 and 6
            return params, opt, {"loss": torch.tensor(float("nan"))}
        return real(params, opt, batch)
    tr.step_fn = flaky
    out = tr.train()
    # NaNGuard trips on the second non-finite loss in a row: the trainer
    # reloads step 4's checkpoint and replays steps 4-7
    assert out["recoveries"] == 1 and out["final_step"] == 8
    assert len(calls) == 7 + 4
    assert out["losses"][:5] == clean["losses"][:5] and np.isnan(out["losses"][5])
    assert out["losses"][6:] == clean["losses"][4:]


def test_trainer_sigterm_stops_and_saves(model, tmp_path):
    _, tcfg, init = model
    tr = _trainer(tcfg, init, tmp_path, 8, ckpt_every=100)
    real, calls = tr.step_fn, []

    def preempted(params, opt, batch):
        calls.append(1)
        if len(calls) == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(params, opt, batch)
    tr.step_fn = preempted
    out = tr.train()
    assert out["final_step"] == 3 and len(out["losses"]) == 3
    assert CheckpointManager(str(tmp_path)).latest_step() == 3
    assert signal.getsignal(signal.SIGTERM) is not None    # the old handler is back
    assert _trainer(tcfg, init, tmp_path, 4).train()["final_step"] == 4


# --------------------------------------------------------------------------
# (g) the launcher
# --------------------------------------------------------------------------

def test_train_launcher_local_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["train", "--arch", "qwen3-0.6b", "--local", "--device",
                                      "cpu", "--steps", "2", "--ckpt-dir", str(tmp_path)])
    launcher.main()
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("done: step=2 ") and "recoveries=0" in line
    assert CheckpointManager(str(tmp_path)).latest_step() == 2
    assert json.load(open(tmp_path / "step_2" / "meta.json"))["arch"] == "qwen3-0.6b"


# --------------------------------------------------------------------------
# (b) the recurrent families' loss and gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-2b"])
def test_loss_and_gradients_match_reference(arch):
    check_loss_and_gradients(arch)
