"""Port parity, `distributed/compression.py` (EF21 int8-compressed gradient
all-reduce), the elastic restore and the launcher's multi-rank path,
against the JAX package on the CPU.

* `compressed_psum` on 4 gloo ranks (`tests/_torch_dist_worker.py
  compressed`) against the reference's under ``jit(shard_map)`` on 4 forced
  host devices (`tests/_torch_ef21_reference.py`), on per-rank gradients
  and errors made with numpy: every rank's codes, scale and new error bit
  for bit (the port multiplies by XLA's reciprocals of 127 and N); the means
  within `MEAN_TOL` (four f32 values summed in another order: gloo's ring
  against XLA's all-reduce).
* `_quantize_leaf` against the jitted reference on 400 leaves spanning 12
  decades, bit for bit; the reference's error bound and one-rank tests
  mirrored; `make_compressed_grad_fn` at one rank.
* The reference's `tests/_ddp_check.py` convergence run, unchanged but on 4
  ranks (16 rows each): 60 SGD steps, ``l_c < 1.5·l_e + 1e-3`` and weight
  drift < 0.05.
* The reference's `tests/_elastic_check.py` case on the same 4 ranks
  (`elastic`): saved from its ("data", None) blocks on a (4,) mesh,
  restored under ("data", "model") on a (2, 2) mesh, bit for bit.
* `launch/train.py` at a world of 2: two processes with ``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK`` and ``--dist-init file://...`` (no port);
  ``--local`` trains on the reference's local mesh, (1, 2).

Run alone: ~25 s on this container's CPU.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import spawn_ranks
from repro.distributed.compression import _quantize_leaf as jquantize
from repro_torch.distributed.compression import (
    _dequantize_leaf, _quantize_leaf, compressed_psum, make_compressed_grad_fn)
from repro_torch.launch.mesh import make_data_mesh
from repro_torch.runtime import CheckpointManager

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD = 4
# the mean of four f32 dequantized values, summed in another order
MEAN_TOL = dict(rtol=1e-6, atol=1e-7)


def _per_rank(rng):
    """Per-rank gradients and errors, (4, ...) f32 each: a wide leaf, one at
    1e-3, one at 1e3, an all-zero leaf (scale at its 1e-12 floor)."""
    shapes = {"a": (64, 32), "b": (16,), "c": (7, 5), "z": (8,)}
    scale = {"a": 1.0, "b": 1e-3, "c": 1e3, "z": 0.0}
    g = {k: (rng.standard_normal((WORLD,) + s) * scale[k]).astype(np.float32)
         for k, s in shapes.items()}
    e = {k: (rng.standard_normal((WORLD,) + s) * scale[k] * 0.01).astype(np.float32)
         for k, s in shapes.items()}
    return g, e


def _ddp_data():
    """`tests/_ddp_check.py`'s problem: rng 0, dim 512, 64 rows."""
    rng = np.random.default_rng(0)
    dim = 512
    w = rng.normal(size=(dim,)).astype(np.float32)
    xs = rng.normal(size=(64, dim)).astype(np.float32)
    ys = (xs @ rng.normal(size=(dim,)).astype(np.float32)).astype(np.float32)
    return dict(w=w, xs=xs, ys=ys, lr=0.05, steps=60)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("ef21")
    g, e = _per_rank(np.random.default_rng(7))
    np.savez(base / "ref_in.npz", **{f"g/{k}": v for k, v in g.items()},
             **{f"e/{k}": v for k, v in e.items()})
    ref = subprocess.run([sys.executable, str(ROOT / "tests" / "_torch_ef21_reference.py"),
                          str(base / "ref_in.npz"), str(base / "ref_out.npz")],
                         capture_output=True, text=True, timeout=240,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert ref.returncode == 0, ref.stdout + ref.stderr
    with np.load(base / "ref_out.npz") as z:
        want = {k: z[k] for k in z.files}
    w = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    (base / "world").mkdir()
    res = spawn_ranks("compressed,elastic", {
        "compressed": dict(grads=g, errors=e, ddp=_ddp_data()),
        "elastic": dict(dir=str(base / "ckpt"), w=w)}, WORLD, base / "world")
    return dict(want=want, ranks=res, grads=g, errors=e, w=w, base=base)


def test_compressed_psum_codes_scales_errors_bitwise(runs):
    want = runs["want"]
    for r, res in enumerate(runs["ranks"]):
        c = res["compressed"]
        for k in runs["grads"]:
            np.testing.assert_array_equal(c["codes"][k].numpy(), want[f"codes/{k}"][r],
                                          err_msg=f"rank {r} codes {k}")
            assert float(c["scales"][k]) == float(want[f"scale/{k}"][r]), (r, k)
            np.testing.assert_array_equal(c["new_err"][k].numpy(), want[f"err/{k}"][r],
                                          err_msg=f"rank {r} error {k}")
        assert float(c["scales"]["z"]) == np.float32(1e-12)


def test_compressed_psum_means_match_reference(runs):
    want = runs["want"]
    ranks = [res["compressed"] for res in runs["ranks"]]
    for k in runs["grads"]:
        atol = MEAN_TOL["atol"] * max(1.0, float(np.abs(want[f"mean/{k}"]).max()))
        for r, c in enumerate(ranks):
            np.testing.assert_allclose(c["mean"][k].numpy(), want[f"mean/{k}"][r],
                                       rtol=MEAN_TOL["rtol"], atol=atol,
                                       err_msg=f"rank {r} mean {k}")
            assert torch.equal(c["mean"][k], ranks[0]["mean"][k])    # all-reduce: same bits


def test_ef21_tracks_exact_ddp_on_four_ranks(runs):
    """The reference's `_ddp_check.py` criteria, as they are."""
    d = _ddp_data()
    xs, ys = torch.from_numpy(d["xs"]), torch.from_numpy(d["ys"])
    c = runs["ranks"][0]["compressed"]
    w_e, w_c = c["w_e"], c["w_c"]
    l_e = float(torch.mean((xs @ w_e - ys) ** 2))
    l_c = float(torch.mean((xs @ w_c - ys) ** 2))
    print(f"exact loss {l_e:.6f}  compressed+EF loss {l_c:.6f}")
    assert l_c < 1.5 * l_e + 1e-3, (l_e, l_c)
    drift = float(torch.linalg.norm(w_e - w_c) / torch.linalg.norm(w_e))
    print(f"weight drift {drift:.4f}")
    assert drift < 0.05
    for res in runs["ranks"][1:]:
        assert torch.equal(res["compressed"]["w_c"], w_c)


def test_elastic_restore_onto_another_mesh_bitwise(runs):
    """The reference's `_elastic_check.py` case on 4 ranks."""
    for res in runs["ranks"]:
        el = res["elastic"]
        assert el["step"] == 7
        i, j = el["coords"]["data"], el["coords"]["model"]
        assert torch.equal(el["w"], runs["w"][4 * i:4 * i + 4, 4 * j:4 * j + 4])
    mgr = CheckpointManager(str(runs["base"] / "ckpt"))
    _, whole = mgr.restore({"w": torch.zeros(8, 8)})
    assert torch.equal(whole["w"], runs["w"])          # stored whole


def test_quantize_leaf_matches_jitted_reference():
    rng = np.random.default_rng(0)
    jq = jax.jit(jquantize)
    for _ in range(400):
        g = (rng.standard_normal(64) * 10 ** rng.uniform(-9, 3)).astype(np.float32)
        jc, js = jq(jnp.asarray(g))
        tc, ts = _quantize_leaf(torch.from_numpy(g))
        assert float(ts) == float(js)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_int8_quantize_error_bound():
    """The reference's `test_int8_quantize_error_bound`, on the port."""
    g = torch.from_numpy(np.random.default_rng(0).normal(size=(256,)).astype(np.float32))
    codes, scale = _quantize_leaf(g)
    deq = _dequantize_leaf(codes, scale)
    assert codes.dtype == torch.int8
    assert float((deq - g).abs().max()) <= float(scale) * 0.5 + 1e-7


def test_compressed_psum_one_rank_and_ddp_step():
    """At one rank compressed_psum is quantize + dequantize (the
    reference's degenerate shard_map test); the DDP step's loss is the
    loss, its gradient the exact one within half a code step."""
    mesh = make_data_mesh("cpu")
    g = {"w": torch.from_numpy(np.random.default_rng(0).normal(size=(64,)).astype(np.float32))}
    mean, err = compressed_psum(g, mesh.ctx)
    np.testing.assert_allclose((mean["w"] + err["w"]).numpy(), g["w"].numpy(), rtol=1e-5,
                               atol=1e-6)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(8, 16)).astype(np.float32))
    params = {"w": torch.ones(16)}

    def loss_fn(p, b):
        return torch.mean((b["x"] @ p["w"]) ** 2)
    loss, grads, errors = make_compressed_grad_fn(loss_fn, mesh)(params, {"x": x})
    w = params["w"].clone().requires_grad_(True)
    exact_loss = loss_fn({"w": w}, {"x": x})
    exact = torch.autograd.grad(exact_loss, w)[0]
    assert float(loss) == float(exact_loss.detach())
    _, scale = _quantize_leaf(exact)
    assert float((grads["w"] - exact).abs().max()) <= float(scale) * 0.5 + 1e-6
    assert torch.equal(grads["w"] + errors["w"], exact)


def test_train_launcher_two_gloo_ranks(tmp_path):
    """`python -m repro_torch.launch.train --local --device cpu` as rank 0
    and 1 of a world of 2 (the variables torchrun sets, a file rendezvous),
    on the (1, 2) ("data", "model") mesh; its checkpoints hold the whole
    arrays."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), WORLD_SIZE="2", OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen3-0.6b", "--local",
           "--device", "cpu", "--steps", "2", "--ckpt-every", "1",
           "--ckpt-dir", str(tmp_path / "ckpt"), "--dist-init", f"file://{tmp_path / 'store'}"]
    procs = [subprocess.Popen(cmd, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log}"
        done = [line for line in log.splitlines() if line.startswith("done: ")]
        assert done and done[-1].startswith("done: step=2 ") and "recoveries=0" in done[-1]
        assert "mesh: {'data': 1, 'model': 2}" in log.splitlines()
    assert [line for line in logs[0].splitlines() if line.startswith("done: ")] == \
        [line for line in logs[1].splitlines() if line.startswith("done: ")]
    assert CheckpointManager(str(tmp_path / "ckpt")).all_steps() == [1, 2]
    assert json.load(open(tmp_path / "ckpt" / "step_2" / "meta.json"))["arch"] == "qwen3-0.6b"
    with np.load(tmp_path / "ckpt" / "step_2" / "arrays.npz") as z:      # gathered whole
        assert z["params/embed/tok"].shape == (512, 128)
