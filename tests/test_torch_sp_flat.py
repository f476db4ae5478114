"""Port parity, the sequence-sharded flat tick (the JAX package's
`core/sp_decode.py` flat part, the island of the fourth branch of
`_attn_decode`), against the JAX reference.

* B8's partials branch: its plain version against the normalised one
  (acc / l within 1e-6), an empty row exactly (0, -1e30, 0).
* The island (`sp_append_token`, `sp_salca_decode`, `sp_dense_decode`): at
  one rank (in-process gloo) against the reference island on a one-device
  mesh, and at 2 and 4 gloo ranks (spawned processes, `_torch_dist_worker.py
  sp_flat`) against it on 2 and 4 of 4 forced host devices (one subprocess);
  `_torch_sp_reference.py` runs the reference's append eagerly under
  `jax.vmap` and its decode in `shard_map` under `jit`. Pre-pool and pooled
  bins, the all-reduced histogram, the threshold, each shard's Selection and
  every rank's slice of the appended leaves bit for bit; outputs within
  1e-5 (the port merges (acc, m, l) partials where the reference puts the
  global max in the exponent: float order only). The cases: pool windows
  across rank edges, a ring that has wrapped, an inactive slot, dense
  windows over global positions.

The engines that run this tick, and ``ring_local_cache``, are
tests/test_torch_sp_engine.py.
"""

import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_dist_worker
import _torch_sp_reference as R
from _torch_bridge import tn
from repro_torch.core import cache as tc
from repro_torch.distributed.sharding import COLLECTIVES, init_decode_ctx
from repro_torch.kernels.common import LAUNCHES
from repro_torch.kernels.flash_decode.ops import (
    sparse_flash_decode_partials, sparse_flash_decode_plain)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
NEG_INF = -1e30
DATA = tc._DATA_FIELDS
B, KV, H, HD, N = 3, 2, 4, 64, 256


@pytest.fixture(scope="module")
def world1():
    """The in-process world of one rank (gloo over a HashStore)."""
    return init_decode_ctx("cpu")


# ---------------------------------------------------------------------------
# B8's partials branch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g", [1, 2, 4])
def test_b8_partials_plain_vs_normalised(rng, g):
    """acc / l equals the normalised plain version within 1e-6 on every
    row with a live token; a row with nothing selected is exactly
    (0, NEG_INF, 0); CPU tensors never count a launch."""
    bh, c = 6, 40
    q = torch.from_numpy(rng.normal(size=(bh, g, HD)).astype(np.float32))
    kc = torch.from_numpy(rng.integers(-127, 128, (bh, c, HD)).astype(np.int8))
    vc = torch.from_numpy(rng.integers(-127, 128, (bh, c, HD)).astype(np.int8))
    ks = torch.from_numpy(rng.uniform(1e-3, 0.05, (bh, c)).astype(np.float32))
    vs = torch.from_numpy(rng.uniform(1e-3, 0.05, (bh, c)).astype(np.float32))
    mask = torch.from_numpy(rng.random((bh, c)) < 0.6)
    mask[2] = False
    before = dict(LAUNCHES)
    acc, m, l = sparse_flash_decode_partials(q, kc, ks, vc, vs, mask)
    assert dict(LAUNCHES) == before
    assert acc.shape == (bh, g, HD) and m.shape == l.shape == (bh, g)
    want = sparse_flash_decode_plain(q, kc, ks, vc, vs, mask)
    live = mask.any(-1)
    np.testing.assert_allclose(tn(acc / l[..., None])[tn(live)], tn(want)[tn(live)],
                               rtol=1e-6, atol=1e-6)
    assert (tn(acc[2]) == 0).all() and (tn(m[2]) == np.float32(NEG_INF)).all()
    assert (tn(l[2]) == 0).all()


# ---------------------------------------------------------------------------
# the island
# ---------------------------------------------------------------------------

def _case(seed, lengths, cursor, valid_len, window, params, shard_cap=None):
    """Replicated prefills of ``lengths`` (rows beyond a slot's length are
    zero, as in a fresh cache), heavy tokens planted on both sides of the
    rank edges at 2 and 4 ranks (so pool windows cross them), an appended
    token at ``cursor`` (a wrapped ring's: pos % N over full rows), a
    query."""
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(B, N, KV, HD)).astype(np.float32)
    v = rng.normal(size=(B, N, KV, HD)).astype(np.float32)
    q = rng.normal(size=(B, H, HD)).astype(np.float32)
    qg = q.reshape(B, KV, H // KV, HD).mean(2)
    for edge in (N // 4, N // 2, 3 * N // 4):
        for off in (-2, -1, 0, 1):
            k[:, edge + off] += 3.0 * qg / np.linalg.norm(qg, axis=-1, keepdims=True) * 4
    for b, n in enumerate(lengths):
        k[b, n:], v[b, n:] = 0, 0
    c = dict(params=params, k=k, v=v, rows=N, lengths=np.array(lengths), q=q,
             k1=rng.normal(size=(B, KV, HD)).astype(np.float32),
             v1=rng.normal(size=(B, KV, HD)).astype(np.float32),
             cursor=np.array(cursor), valid_len=np.array(valid_len), window=window)
    if shard_cap is not None:
        c["shard_cap"] = shard_cap
    return c


CASES = {
    # pool windows across the rank edges; slot 2 inactive (cursor -1)
    "edges": _case(0, (200, 140, 0), (200, 140, -1), (201, 141, 0), 0,
                   dict(k=24, k_cap=32, pool_window=7)),
    # a ring of N rows that wrapped: the write lands at pos % N, every row
    # valid; no pooling; a small shard capacity that cuts
    "ring_wrapped": _case(1, (N, N, N), (300 % N, 511 % N, 260 % N), (N, N, N), 0,
                          dict(k=32, k_cap=48, pool_window=1), shard_cap=24),
    # the dense tick's window over global positions, across rank edges
    "window": _case(2, (230, 100, 60), (230, 100, 60), (231, 101, 61), 90,
                    dict(k=16, k_cap=32, pool_window=5)),
}


def _assert_rank(j, t, rank, world, case):
    """Rank ``rank``'s results against the reference's run on ``world``
    shards: this rank's slice of every global leaf and bin row, the
    replicated histogram and threshold, this shard's Selection."""
    nl = case["rows"] // world
    rows = slice(rank * nl, (rank + 1) * nl)
    for f in DATA:
        want = j[f"leaf_{f}"][:, rows]
        np.testing.assert_array_equal(tn(t["leaves"][f], want), want, err_msg=f)
    np.testing.assert_array_equal(tn(t["leaves"]["length"]), j["local_len"][:, rank])
    np.testing.assert_array_equal(tn(t["bins"]), j["bins"][..., rows])
    np.testing.assert_array_equal(tn(t["pooled"]).reshape(j["bins"][..., rows].shape),
                                  j["pooled"][..., rows])
    np.testing.assert_array_equal(tn(t["hist"]), j["hist"])
    idx, mask, count, thr = (tn(x) for x in t["sel"])
    cap = idx.shape[-1]
    np.testing.assert_array_equal(idx, j["indices"][..., rank * cap:(rank + 1) * cap])
    np.testing.assert_array_equal(mask, j["mask"][..., rank * cap:(rank + 1) * cap])
    np.testing.assert_array_equal(count, j["count"][..., rank])
    np.testing.assert_array_equal(thr, j["threshold"])
    np.testing.assert_allclose(tn(t["out"]), j["out"], **TOL)
    np.testing.assert_allclose(tn(t["dense"]), j["dense"], **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_island_world1_vs_jax_one_device_mesh(world1, name):
    """The port's island at one rank against the reference island on a
    one-device mesh: everything of `_assert_rank`, the pooled bins too; the
    halo of a world of one is zeros at both ends and sends nothing."""
    case = CASES[name]
    j = R.run_island(case, R.one_device_mesh())
    before = COLLECTIVES["all_gather"]
    t = _torch_dist_worker.sp_flat_case(case, world1)
    assert COLLECTIVES["all_gather"] == before
    _assert_rank(j, t, 0, 1, case)
    assert t["sel"][2].max() > 0


@pytest.fixture(scope="module")
def jax_sharded(tmp_path_factory):
    """The reference island on every case at 2 and 4 shards, one subprocess."""
    work = tmp_path_factory.mktemp("sp_ref")
    with open(work / "in.pkl", "wb") as fh:
        pickle.dump(list(CASES.values()), fh)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, str(ROOT / "tests" / "_torch_sp_reference.py"),
                        str(work)], env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stdout + p.stderr
    with open(work / "out.pkl", "rb") as fh:
        return pickle.load(fh)


def _spawn(task, inp, world, tmp_path):
    """Run ``world`` ranks of `_torch_dist_worker.py` over a FileStore in
    ``tmp_path``; returns each rank's results."""
    torch.save(inp, tmp_path / "in.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_dist_worker.py"),
                               task, str(tmp_path), str(r), str(world)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = [p.communicate(timeout=400)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    return [torch.load(tmp_path / f"out{r}.pt", weights_only=False) for r in range(world)]


@pytest.mark.parametrize("world", [2, 4])
def test_island_gloo_ranks_vs_jax_mesh(jax_sharded, tmp_path, world):
    """2 and 4 gloo ranks against the reference island on as many shards:
    every case, every rank (`_assert_rank`); the union of the shards'
    selections is the reference's; the halo crossed the rank edges (a
    pooled bin next to an edge took its neighbour's value)."""
    res = _spawn("sp_flat", dict(cases=list(CASES.values())), world, tmp_path)
    for i, (name, case) in enumerate(CASES.items()):
        j = jax_sharded[world][i]
        for rank in range(world):
            _assert_rank(j, res[rank][i], rank, world, case)
    j = jax_sharded[world][0]
    edge = N // world
    crossed = (j["pooled"][..., edge - 1] > j["bins"][..., edge - 1]) | (
        j["pooled"][..., edge] > j["bins"][..., edge])
    assert crossed.any()


@pytest.mark.parametrize("window", [1, 40, 300])
def test_sp_dense_decode_window_global_positions(world1, window):
    """`sp_dense_decode` with ``window`` > 0 against the reference's on a
    one-device mesh (the keys at global positions > valid_len - window)."""
    case = dict(CASES["window"], window=window)
    j = R.run_island(case, R.one_device_mesh())
    t = _torch_dist_worker.sp_flat_case(case, world1)
    np.testing.assert_allclose(tn(t["dense"]), j["dense"], **TOL)
