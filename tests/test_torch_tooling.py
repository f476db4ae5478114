"""Port parity of the tooling: the performance model (`core/performance_model.py`),
the conflict simulator (`core/conflict_sim.py`), the useful-FLOPs model
and roofline terms (`analysis/roofline.py`), the synthetic workload of the
benchmarks (`analysis/synthetic.py`) against the JAX package, and the
collectives' byte record (`analysis/collectives.py`) against what one
2-rank gloo tick hands to torch.distributed. Pure arithmetic and numpy:
every value must equal the reference's exactly. ~10 s alone on this
container's CPU (the 2-rank tick ~3 s of it).
"""

import dataclasses
import itertools
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_bridge import tn

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import common as jcommon  # noqa: E402
from repro.analysis import roofline as jroof  # noqa: E402
from repro.configs import ARCH_NAMES as J_ARCHS  # noqa: E402
from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core import conflict_sim as jcs  # noqa: E402
from repro.core import performance_model as jpm  # noqa: E402
from repro_torch.analysis import roofline as troof  # noqa: E402
from repro_torch.analysis import synthetic as tsyn  # noqa: E402
from repro_torch.analysis.collectives import _WIRE_FACTOR, Collectives  # noqa: E402
from repro_torch.configs import ARCH_NAMES as T_ARCHS  # noqa: E402
from repro_torch.configs import SHAPES as T_SHAPES  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import conflict_sim as tcs  # noqa: E402
from repro_torch.core import performance_model as tpm  # noqa: E402


def _same(a, b):
    """Equal values, dataclasses field by field (floats exactly)."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    else:
        assert a == b, (a, b)


# --- the performance model -------------------------------------------------

def test_hardware_spec_is_the_papers_asic():
    """The defaults are the reference's: the paper's ASIC, HBM2 at 500 MHz."""
    assert dataclasses.asdict(tpm.HardwareSpec()) == dataclasses.asdict(jpm.HardwareSpec())
    assert tpm.HardwareSpec().f_cmp == 500e6 and tpm.HardwareSpec().chn == 32


def test_paper_operating_point():
    """The reference test's operating point (tests/test_performance_model.py):
    m_pre 25 at m_att 2; p_pre 16 ⇒ m_pre 17, min retention ≈ 5.8 %, h_pre 11."""
    hw = tpm.HardwareSpec()
    assert tpm.bandwidth_bits_per_cycle(hw) == 8192
    assert int((8192 - tpm.att_bits_per_key(128) * 2) / tpm.pre_bits_per_key(128, 0.5)) == 25
    dp = tpm.solve(hw, s_f=0.5, target_retention=0.05)
    assert (dp.p_pre, dp.m_pre) == (16, 17)
    assert abs(tpm.min_retention(hw, 17, 2) - 0.058) < 0.002
    assert tpm.pc_allocation(hw, 0.5, m_pre=16, m_att=1)[0] == 11
    _same(dp, jpm.solve(jpm.HardwareSpec(), s_f=0.5, target_retention=0.05))


@pytest.mark.parametrize("d,chn,alpha", [(128, 32, 1.17), (64, 16, 1.09), (256, 32, 2.18)])
def test_solve_and_cycles_over_a_grid(d, chn, alpha):
    th = tpm.HardwareSpec(d=d, chn=chn, alpha=alpha)
    jh = jpm.HardwareSpec(d=d, chn=chn, alpha=alpha)
    for s_f, target in itertools.product((0.25, 0.375, 0.5, 1.0), (0.02, 0.05, 0.1, 0.2, 0.5)):
        _same(tpm.solve(th, s_f, target), jpm.solve(jh, s_f, target))
        for m_pre, m_att in ((17, 2), (25, 2), (8, 4), (1, 1)):
            _same(tpm.pc_allocation(th, s_f, m_pre, m_att), jpm.pc_allocation(jh, s_f, m_pre, m_att))
            _same(tpm.min_retention(th, m_pre, m_att), jpm.min_retention(jh, m_pre, m_att))
            for n in (1, 4096, 65536):
                _same(tpm.decode_cycles(th, n, target, m_pre, m_att),
                      jpm.decode_cycles(jh, n, target, m_pre, m_att))


def test_bytes_per_token_over_a_grid():
    """Every per-token byte model, the sharded variants, the pool's bytes
    per block, capacity, the prefix cache's avoided bytes and the PCIe
    prediction, over a grid of arguments."""
    grid = itertools.product((1024, 32768, 131072, 524288), (64, 128, 256), (1, 8),
                             (0.25, 0.5), (0.03125, 0.05))
    for n, d, kv, s_f, ret in grid:
        for dt in ("fp16", "int8", "int4"):
            _same(tpm.kv_store_bits_per_key(d, dt, 32), jpm.kv_store_bits_per_key(d, dt, 32))
            _same(tpm.salca_bytes_per_token(n, d, kv, s_f, ret, dt, 16),
                  jpm.salca_bytes_per_token(n, d, kv, s_f, ret, dt, 16))
            _same(tpm.pool_block_bytes(d, kv, 32, s_f, dt), jpm.pool_block_bytes(d, kv, 32, s_f, dt))
            _same(tpm.max_context_tokens(80e9, d, kv, 28, 32, s_f, dt),
                  jpm.max_context_tokens(80e9, d, kv, 28, 32, s_f, dt))
            _same(tpm.cached_prefill_bytes_avoided(7, d=d, kv_heads=kv, block_size=32,
                                                   layers=28, s_f=s_f, kv_pool_dtype=dt),
                  jpm.cached_prefill_bytes_avoided(7, d=d, kv_heads=kv, block_size=32,
                                                   layers=28, s_f=s_f, kv_pool_dtype=dt))
            _same(tpm.sharded_fused_bytes_per_token(n, d, kv, 2, s_f, ret, 4, 32, 7, dt),
                  jpm.sharded_fused_bytes_per_token(n, d, kv, 2, s_f, ret, 4, 32, 7, dt))
            _same(tpm.sharded_gather_bytes_per_token(n, d, kv, 2, s_f, ret, 4, 32, 256, 2, 7, dt),
                  jpm.sharded_gather_bytes_per_token(n, d, kv, 2, s_f, ret, 4, 32, 256, 2, 7, dt))
        _same(tpm.filter4bit_bytes_per_token(n, d, kv, ret), jpm.filter4bit_bytes_per_token(n, d, kv, ret))
        _same(tpm.dense_bytes_per_token(n, d, kv), jpm.dense_bytes_per_token(n, d, kv))
        for shards in (1, 2, 8):
            t = tpm.sharded_salca_bytes_per_token(n, d, kv, 2, s_f, ret, shards, 32)
            _same(t, jpm.sharded_salca_bytes_per_token(n, d, kv, 2, s_f, ret, shards, 32))
            assert t.interconnect_ratio == jpm.sharded_salca_bytes_per_token(
                n, d, kv, 2, s_f, ret, shards, 32).interconnect_ratio
    for moves in ((0, 0), (3, 5), (1000, 17)):
        t, j = tpm.spill_pcie_traffic(1e6, *moves), jpm.spill_pcie_traffic(1e6, *moves)
        _same(t, j)
        assert t.bytes_per_move == j.bytes_per_move
    with pytest.raises(ValueError, match="unknown kv_pool_dtype"):
        tpm.kv_store_bits_per_key(128, "int2")


# --- the conflict simulator --------------------------------------------------

@pytest.mark.parametrize("structured", [False, True])
def test_conflict_table_equal_ratios(structured):
    """The same draws from the same seeds: the same ratios, and the
    reference's Table 1 band at range 128 on run-structured indices."""
    for seed in (0, 1):
        t = tcs.conflict_table(total=1 << 14, seed=seed, structured=structured)
        assert t == jcs.conflict_table(total=1 << 14, seed=seed, structured=structured)
    if structured:          # the reference test's size (the reference takes ~70 s at it)
        table = tcs.conflict_table(structured=True, total=1 << 18)
        assert 1.0 <= table[128] < 1.35 and 1.0 <= table[256] <= table[128] + 1e-9
    idx = np.random.default_rng(0).integers(0, 65536, size=1 << 14)
    assert tcs.serialized_batches_ratio(idx) == jcs.serialized_batches_ratio(idx)
    with pytest.raises(ValueError):
        tcs.conflict_ratio(idx[:4], 8)


# --- useful FLOPs and roofline terms -----------------------------------------

def test_model_flops_every_arch_and_shape():
    assert T_ARCHS == J_ARCHS and list(T_SHAPES) == list(J_SHAPES)
    for arch, shape in itertools.product(T_ARCHS, T_SHAPES):
        tc, jc = tget(arch), jget(arch)
        assert tc.param_count() == jc.param_count(), arch
        assert tc.active_param_count() == jc.active_param_count(), arch
        assert troof.model_flops(tc, T_SHAPES[shape]) == jroof.model_flops(jc, J_SHAPES[shape]), \
            (arch, shape)
        assert troof.model_flops(tc.reduced(), T_SHAPES[shape].reduced()) == \
            jroof.model_flops(jc.reduced(), J_SHAPES[shape].reduced())


def test_roofline_terms_on_the_h100_peaks():
    """The reference's terms with the H100 SXM's datasheet peaks."""
    assert (troof.PEAK_FLOPS, troof.HBM_BW, troof.NVLINK_BW) == (989e12, 3.35e12, 450e9)
    assert troof.PEAK_OPS == {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}
    t = troof.RooflineTerms(flops_per_chip=989e12, hbm_bytes_per_chip=3.35e12 / 4,
                            wire_bytes_per_chip=450e9 / 8, model_flops_per_chip=989e12 / 2)
    assert (t.compute_s, t.memory_s, t.collective_s) == (1.0, 0.25, 0.125)
    assert t.bottleneck == "compute" and t.bound_s == 1.0
    assert t.useful_ratio == 0.5 and t.roofline_fraction == 0.5
    assert set(t.as_dict()) == set(jroof.RooflineTerms(1.0, 1.0, 1.0).as_dict())
    cfg, shape = tget("qwen3-0.6b"), T_SHAPES["decode_32k"]
    m = troof.make_terms(cfg, shape, 4, 1e12, 1e9, 1e6)
    assert m.model_flops_per_chip == troof.model_flops(cfg, shape) / 4
    row = troof.format_row("qwen3-0.6b", "decode_32k", "1", m)
    assert row.startswith("| qwen3-0.6b | decode_32k | 1 |") and row.count("|") == 10


# --- the synthetic workload --------------------------------------------------

def test_synthetic_case_and_metrics():
    """q, k, v bit for bit the reference's inputs; the true scores within
    f32 summation order; overlap and coverage of the same selection equal."""
    for seed, runs in ((0, True), (3, False)):
        tq, tk, tv, trel = tsyn.synthetic_attention_case(seed, T=512, runs=runs)
        jq, jk, jv, jrel = jcommon.synthetic_attention_case(seed, T=512, runs=runs)
        for t, j in ((tq, jq), (tk, jk), (tv, jv)):
            np.testing.assert_array_equal(tn(t), np.asarray(j))
        np.testing.assert_array_equal(trel, jrel)
    ts, js = tsyn.true_scores(tq, tk), jcommon.true_scores(jq, jk)
    np.testing.assert_allclose(tn(ts), np.asarray(js), rtol=1e-5, atol=1e-5)
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 512, size=(2, 4, 64)).astype(np.int32)
    mask = rng.random((2, 4, 64)) < 0.8
    mask[1, 2] = False                              # a row that selected nothing
    s = np.asarray(js)
    assert tsyn.overlap_coverage(torch.from_numpy(idx), torch.from_numpy(mask),
                                 torch.from_numpy(s.copy()), k_top=40) == \
        jcommon.overlap_coverage(idx, mask, s, k_top=40)


# --- the collectives' record ---------------------------------------------------

def test_collectives_record_rules():
    """The reference's ring factors over the group size, its summary keys; a
    group of one records nothing."""
    c = Collectives()
    c.record("all-reduce", 4096, 4)
    c.record("all-gather", 800, 4)
    c.record("all-reduce", 100, 1)
    c.record("collective-permute", 64, 1)
    assert c.summary() == {
        "all-gather": {"count": 1, "result_bytes": 800, "wire_bytes": 600},
        "all-reduce": {"count": 1, "result_bytes": 4096, "wire_bytes": 6144},
        "collective-permute": {"count": 1, "result_bytes": 64, "wire_bytes": 64}}
    assert c.total_count == 3 and c.total_wire_bytes == 6144 + 600 + 64
    c.reset()
    assert c.summary() == {} and c.total_count == 0


def test_collectives_of_a_two_rank_tick(tmp_path):
    """One decode tick at 2 gloo ranks: the record holds every collective the
    tick hands to torch.distributed, with its result bytes and the ring's
    wire bytes; per layer the flat sequence-sharded tick issues 6
    all-reduces and one halo all-gather, the block-sharded tick 8
    all-reduces (qwen3-0.6b.reduced(): 2 layers)."""
    torch.save({}, tmp_path / "in.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_dist_worker.py"),
                               "collectives", str(tmp_path), str(r), "2"], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    layers = tget("qwen3-0.6b").reduced().num_layers
    want = {"contiguous": {"all-reduce": 6 * layers, "all-gather": layers},
            "paged": {"all-reduce": 8 * layers}}
    results = [torch.load(tmp_path / f"out{r}.pt", weights_only=False) for r in range(2)]
    for res in results:
        for pool, got in res.items():
            counts = {op: sum(1 for o, _ in got["issued"] if o == op) for op in want[pool]}
            assert counts == want[pool], (pool, counts)
            summary = {}
            for op in want[pool]:
                nbytes = sum(b for o, b in got["issued"] if o == op)   # results, in place
                summary[op] = {"count": counts[op], "result_bytes": nbytes,
                               "wire_bytes": round(_WIRE_FACTOR[op](2) * nbytes)}
            assert got["summary"] == summary, (pool, got["summary"], summary)
            assert got["counted"] == {k.replace("-", "_"): v["count"]
                                      for k, v in summary.items()}
    assert results[0] == results[1]
    assert math.isclose(_WIRE_FACTOR["all-reduce"](2), 1.0)
