"""Port parity, prefix sharing with copy-on-write: ``salca_static_channels``,
the pool primitives `share_blocks`, `cow_block` and
`prefill_into_pages(n_shared)`, and `ServingEngine(prefix_sharing=True)`
against the JAX package.

* The static heavy set equals the reference's index for index, from the
  key-projection weights and from a ``calib_salience`` leaf (ties too).
* The primitives in int8, fp16 and int4: every pool leaf equal after every
  step of a share → fault → copy → append sequence.
* Three engine traces of tests/test_prefix_sharing.py (divergent tails,
  copy on write mid-decode, the heavy-set gate) through both engines:
  greedy tokens identical, logits within LOGIT_TOL, the five sharing stats
  equal, layer 0's page table and the host refcount mirror equal at every
  tick, free lists equal at drain and every refcount 0.
* With the host tier: no shared or radix-published block is ever demoted,
  and tokens and counts equal the JAX engine's.
* Seeded random admit / share / decode / finish interleavings on the
  port's pool, `check_invariants` after every step (the reference's
  MiniPool battery).
* The block-sharded engine at one in-process gloo rank and at two spawned
  ranks (tests/_torch_dist_worker.py): tokens equal the unsharded port's;
  the two-rank trace forces one copy across ranks, and a cross-rank
  `cow_block` leaves every rank's leaves equal to its slice of the JAX pool.

Both engines serve qwen3-0.6b.reduced() at float32 compute from the same
weights (the JAX init tree converted by `repro_torch.weights`).
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_bridge import POOL_FIELDS, f32_configs, tn, tt
from repro.core import cache as jc
from repro.core.selection import SalcaParams as JParams
from repro.models import blocks as jblocks
from repro.models import get_model as jget_model
from repro.runtime.serve import Request as JRequest
from repro.runtime.serve import ServingEngine as JEngine
from repro_torch.core import cache as tc
from repro_torch.core.selection import SalcaParams as TParams
from repro_torch.distributed.sharding import init_decode_ctx
from repro_torch.models import blocks as tblocks
from repro_torch.runtime.serve import Request as TRequest
from repro_torch.runtime.serve import ServingEngine as TEngine
from repro_torch.weights import params_from_numpy

ROOT = pathlib.Path(__file__).resolve().parents[1]
JCFG, TCFG = f32_configs()
JSTATIC, TSTATIC = (dataclasses.replace(c, salca_static_channels=True) for c in (JCFG, TCFG))
# logits: f32 summation-order differences through 2 layers, the bound of
# tests/test_torch_engine.py; except where the two prefills' K rounds to
# another int8 code (see EXPECTED)
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
SHARING_KEYS = ("shared_blocks", "cow_copies", "prefix_hits", "effective_blocks_saved",
                "memory_saved_tokens")
MAX_SEQ, BS = 128, 16


@pytest.fixture(scope="module")
def weights():
    jp = jget_model(JCFG).init(jax.random.PRNGKey(0))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), TCFG, "cpu")


def _prompt(rng, n):
    return rng.integers(0, JCFG.vocab_size, n).astype(np.int32)


# ---------------------------------------------------------------------------
# the static heavy set
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", ["weights", "calibrated", "calibrated_ties"])
def test_static_heavy_idx_matches_reference(rng, source):
    d, kv, hd = JCFG.d_model, JCFG.num_kv_heads, JCFG.resolved_head_dim
    attn = {"wk": rng.normal(size=(d, kv, hd)).astype(np.float32)}
    if source == "calibrated":
        attn["calib_salience"] = rng.random((kv, hd)).astype(np.float32)
    elif source == "calibrated_ties":        # few distinct values: ties decide
        attn["calib_salience"] = rng.integers(0, 3, (kv, hd)).astype(np.float32)
    want = np.asarray(jblocks.static_heavy_idx(
        {k: jnp.asarray(v) for k, v in attn.items()}, JSTATIC,
        jblocks.salca_params_for(JSTATIC, MAX_SEQ), 3))
    got = tblocks.static_heavy_idx({k: tt(v) for k, v in attn.items()}, TSTATIC,
                                   tblocks.salca_params_for(TSTATIC, MAX_SEQ), 3)
    assert want.shape == (3, kv, tblocks.salca_params_for(TSTATIC, MAX_SEQ).r(hd))
    np.testing.assert_array_equal(tn(got), want)
    assert tblocks.static_heavy_idx({"wk": tt(attn["wk"])}, TCFG,
                                    tblocks.salca_params_for(TCFG, MAX_SEQ), 3) is None


# ---------------------------------------------------------------------------
# the pool primitives
# ---------------------------------------------------------------------------

NB, PBS, PSLOTS, PMB, PKV, PHD = 12, 4, 3, 6, 2, 32
POOL_PARAMS = dict(feature_sparsity=0.5, k=16, k_cap=32, pool_window=7)


def _assert_pools_equal(jpool, tpool, step):
    for f in POOL_FIELDS:
        j = np.asarray(getattr(jpool, f))
        np.testing.assert_array_equal(tn(getattr(tpool, f), j), j, err_msg=f"{step}: {f}")


@pytest.mark.parametrize("mode", ["int8", "fp16", "int4"])
def test_share_cow_and_shared_prefill_match_reference(rng, mode):
    """Slot 1 holds 10 tokens in blocks [5, 2, 9]; slot 0 shares all three
    (its cursor lies in the partial block 9); an append faults (dropped,
    cursors held) until `cow_block` copies block 9 into 7 for slot 0; both
    writes then land. Slot 2 is admitted over blocks [5, 2, 4] with
    ``n_shared=2`` (mapped, not written); a copy of an unmapped entry is a
    no-op. Every leaf equals the reference's after every step."""
    jp, tp = JParams(**POOL_PARAMS), TParams(**POOL_PARAMS)
    jpool = jc.empty_paged_cache(NB, PBS, PSLOTS, PMB, PKV, PHD, jp.r(PHD), kv_pool_dtype=mode)
    tpool = tc.empty_paged_cache(NB, PBS, PSLOTS, PMB, PKV, PHD, tp.r(PHD), kv_pool_dtype=mode)

    def src(t):
        k, v = (rng.normal(size=(1, t, PKV, PHD)).astype(np.float32) for _ in range(2))
        return (jc.prefill_cache(jnp.asarray(k), jnp.asarray(v), max_seq=PMB * PBS, params=jp),
                tc.prefill_cache(tt(k), tt(v), max_seq=PMB * PBS, params=tp))

    def append():
        k, v = (rng.normal(size=(PSLOTS, PKV, PHD)).astype(np.float32) for _ in range(2))
        tc.append_token_paged(tpool, tt(k), tt(v))
        return jc.append_token_paged(jpool, jnp.asarray(k), jnp.asarray(v))

    pages = np.array([5, 2, 9, -1, -1, -1], np.int32)
    js, ts = src(10)
    jpool = jc.prefill_into_pages(jpool, js, 1, jnp.asarray(pages))
    tc.prefill_into_pages(tpool, ts, 1, tt(pages))
    _assert_pools_equal(jpool, tpool, "prefill")
    jpool = jc.share_blocks(jpool, 1, 3, 0)
    tc.share_blocks(tpool, 1, 3, 0)
    _assert_pools_equal(jpool, tpool, "share")
    before = tn(tpool.k_codes[9]).copy()
    jpool = append()
    _assert_pools_equal(jpool, tpool, "faulted append")
    assert (tn(tpool.length)[:2] == 10).all() and (tn(tpool.k_codes[9]) == before).all()
    jpool = jc.cow_block(jpool, 0, 2, 7)
    tc.cow_block(tpool, 0, 2, 7)
    _assert_pools_equal(jpool, tpool, "copy on write")
    assert int(tpool.refcount[9]) == int(tpool.refcount[7]) == 1
    jpool = append()
    _assert_pools_equal(jpool, tpool, "append after the copy")
    assert (tn(tpool.length)[:2] == 11).all()
    pages2 = np.array([5, 2, 4, -1, -1, -1], np.int32)
    js, ts = src(9)
    jpool = jc.prefill_into_pages(jpool, js, 2, jnp.asarray(pages2), 2)
    tc.prefill_into_pages(tpool, ts, 2, tt(pages2), n_shared=2)
    _assert_pools_equal(jpool, tpool, "shared prefill")
    jpool = append()
    _assert_pools_equal(jpool, tpool, "append")
    jpool = jc.cow_block(jpool, 0, 5, 11)
    tc.cow_block(tpool, 0, 5, 11)
    _assert_pools_equal(jpool, tpool, "copy of an unmapped entry")
    assert tpool.check_invariants().ok


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

def _serve(engine_cls, req_cls, cfg, params, prompts, new_tokens, **kw):
    """Run ``prompts`` through a sharing engine; returns the engine, its
    requests and per tick (mask, logits, layer 0's page table, host
    refcount)."""
    eng = engine_cls(cfg, params, max_seq=MAX_SEQ, paged=True, block_size=BS,
                     prefix_sharing=True, **kw)
    reqs = [req_cls(rid=i, prompt=p.copy(), max_new_tokens=new_tokens)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    ticks = []
    orig = eng._decode

    def recording(*args):
        out = orig(*args)
        if torch.is_tensor(out[1]):
            lg, pt = out[1].float(), eng._state.caches[0].page_table
        else:
            lg, pt = out[1], args[1].period_states[0].page_table[0]
        ticks.append((np.asarray(args[-1]).copy(), np.asarray(lg, np.float32),
                      np.array(pt), eng._refcount.copy()))
        return out

    eng._decode = recording
    eng.run()
    return eng, reqs, ticks


def _traces(rng):
    """The reference's three engine traces (tests/test_prefix_sharing.py):
    (static channels?, prompts, new tokens, engine knobs)."""
    prefix = _prompt(rng, 48)
    tails = [np.concatenate([prefix, _prompt(rng, 15)]) for _ in range(4)]
    same = _prompt(rng, 40)
    return {
        # 4 × (48 shared + 15): 3 full blocks shared by each later request
        "divergent_tails": (True, tails, 2, dict(slots=6, num_blocks=20)),
        # 3 identical 40-token prompts: the partial block faults on the
        # first decode write; the last holder writes in place
        "cow_mid_decode": (True, [same] * 3, 5, dict(slots=4, num_blocks=16)),
        # per-input heavy sets: the divergent tails part at the gate, the
        # identical pair shares all 4 blocks
        "heavy_gate": (False, tails[:3] + [tails[0]], 2, dict(slots=4, num_blocks=16)),
    }


EXPECTED = {"divergent_tails": dict(shared_blocks=9, prefix_hits=3, cow_copies=0),
            "cow_mid_decode": dict(shared_blocks=6, prefix_hits=2, cow_copies=2),
            "heavy_gate": dict(shared_blocks=4, prefix_hits=1, cow_copies=1)}
# cow_mid_decode's prompt: one K code of layer 1 (position 30) lies one int8
# step apart between the two prefills (their f32 K parts in the last bit);
# the unshared engines part by the same 1.34e-4 on the ticks that weigh it
ATOL = {"divergent_tails": LOGIT_TOL["atol"], "cow_mid_decode": 2e-4,
        "heavy_gate": LOGIT_TOL["atol"]}


@pytest.mark.parametrize("trace", list(EXPECTED))
def test_engine_traces_match_reference(weights, trace):
    jp, tp = weights
    static, prompts, new, kw = _traces(np.random.default_rng(21))[trace]
    jcfg, tcfg = (JSTATIC, TSTATIC) if static else (JCFG, TCFG)
    je, jr, jticks = _serve(JEngine, JRequest, jcfg, jp, prompts, new, **kw)
    te, tr, tticks = _serve(TEngine, TRequest, tcfg, tp, prompts, new, device="cpu", **kw)
    assert [r.output for r in tr] == [r.output for r in jr]
    assert all(r.stop_reason == "length" for r in tr)
    js, ts = je.stats.summary(), te.stats.summary()
    assert {k: ts[k] for k in SHARING_KEYS} == {k: js[k] for k in SHARING_KEYS}
    assert {k: ts[k] for k in EXPECTED[trace]} == EXPECTED[trace]
    assert [r.shared_blocks for r in tr] == [r.shared_blocks for r in jr]
    assert len(tticks) == len(jticks) > 0
    for (jm, jl, jpt, jrc), (tm, tl, tpt, trc) in zip(jticks, tticks):
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_allclose(tl[tm], jl[jm], rtol=LOGIT_TOL["rtol"], atol=ATOL[trace])
        np.testing.assert_array_equal(tpt, jpt)
        np.testing.assert_array_equal(trc, jrc)
    assert te._free_blocks == je._free_blocks
    assert sorted(te._free_blocks) == list(range(te.num_blocks))
    assert not te._refcount.any() and not te._prefix_nodes and not te._block_keys
    for pool in te._state.caches:
        assert not tn(pool.refcount).any()
        assert pool.check_invariants(free_blocks=te._free_blocks,
                                     host_refcount=te._refcount).ok


def test_host_spill_never_demotes_a_shared_or_published_block(weights):
    """Sharing with the host tier on a 9-block pool, the selection histogram
    stubbed to report every block unselected (the most eager policy), the
    paper's per-input heavy sets: two identical 64-token prompts share all
    4 blocks; a third with the same 48-token prefix fails the heavy-set
    gate and, larger than the free pool, admits privately in waves; grown
    blocks demote and promote, and no block that is shared or published
    in the radix map ever leaves the device. Tokens, sharing and spill
    counts equal the JAX engine's."""
    jp, tp = weights
    rng = np.random.default_rng(4)
    prefix = _prompt(rng, 48)
    a = np.concatenate([prefix, _prompt(rng, 16)])
    prompts = [a, a.copy(), np.concatenate([prefix, _prompt(rng, 60)])]
    kw = dict(slots=3, num_blocks=9, host_spill=True, demote_after=1, spill_keep_recent=1)
    runs = []
    for eng_cls, req_cls, cfg, params, extra in (
            (JEngine, JRequest, JCFG, jp, {}), (TEngine, TRequest, TCFG, tp, {"device": "cpu"})):
        eng = eng_cls(cfg, params, max_seq=MAX_SEQ, paged=True, block_size=BS,
                      prefix_sharing=True, **kw, **extra)
        real = eng._sel_hist_fn

        def all_cold(state, real=real):
            h = real(state)
            return h * 0 if torch.is_tensor(h) else np.zeros_like(np.asarray(h))

        eng._sel_hist_fn = all_cold
        demoted = []
        if eng_cls is TEngine:
            real_demote = eng.demote_block

            def demote(slot, logical, _inject=True, eng=eng, real_demote=real_demote):
                b = eng._slot_blocks[slot][logical]
                demoted.append(b)
                assert eng._refcount[b] == 1 and b not in eng._block_keys, \
                    f"demoting block {b}: refcount {eng._refcount[b]}, published"
                return real_demote(slot, logical, _inject)

            eng.demote_block = demote
        reqs = [req_cls(rid=i, prompt=p.copy(), max_new_tokens=16) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        stats = eng.run()
        assert all(r.stop_reason == "length" for r in reqs)
        runs.append(([r.output for r in reqs], stats.summary(),
                     [r.shared_blocks for r in reqs], demoted))
    (jo, js, jsh, _), (to, ts, tsh, demoted) = runs
    assert to == jo and tsh == jsh
    for k in SHARING_KEYS + ("demotions", "promotions", "pcie_bytes", "peak_cold_blocks"):
        assert ts[k] == js[k], k
    assert tsh == [0, 4, 0] and ts["cow_copies"] == 0
    assert ts["demotions"] > 5 and ts["promotions"] > 0 and len(demoted) == ts["demotions"]


# ---------------------------------------------------------------------------
# random interleavings on the port's pool
# ---------------------------------------------------------------------------

class MiniPool:
    """The engine's block bookkeeping (free list, host refcount, growth and
    copy on write, release) driving the port's pool ops without a model;
    the reference's property harness, with the admission by
    ``prefill_into_pages(n_shared)`` that the engine uses beside
    `share_blocks`."""

    LENGTHS = (3, 4, 7, 11)

    def __init__(self, rng):
        self.params = TParams(**POOL_PARAMS)
        self.pool = tc.empty_paged_cache(NB, PBS, PSLOTS + 1, PMB, PKV, PHD,
                                         self.params.r(PHD))
        self.free = list(range(NB))
        self.rc = np.zeros(NB, np.int64)
        self.blocks: dict[int, list[int]] = {}
        self.pos: dict[int, int] = {}
        self.rng = rng

    def _src(self, t):
        k, v = (torch.from_numpy(self.rng.normal(size=(1, t, PKV, PHD)).astype(np.float32))
                for _ in range(2))
        return tc.prefill_cache(k, v, max_seq=PMB * PBS, params=self.params)

    def admit(self, slot, t, share_from=None, n=0):
        """A prompt of ``t`` tokens; with ``share_from`` its first ``n``
        blocks are that slot's, mapped by reference."""
        if slot in self.blocks or (share_from is not None and share_from not in self.blocks):
            return
        shared = self.blocks[share_from][:n] if share_from is not None else []
        if share_from is not None:
            t = max(t, len(shared) * PBS)
        need = -(-t // PBS) - len(shared)
        if need > len(self.free):
            return
        ids = shared + [self.free.pop() for _ in range(need)]
        pages = np.full(PMB, -1, np.int32)
        pages[:len(ids)] = ids
        tc.prefill_into_pages(self.pool, self._src(t), slot, pages, n_shared=len(shared))
        for b in ids:
            self.rc[b] += 1
        self.blocks[slot], self.pos[slot] = ids, t

    def share(self, dst, src, n):
        if dst in self.blocks or src not in self.blocks or dst == src:
            return
        ids = self.blocks[src][:n]
        tc.share_blocks(self.pool, src, len(ids), dst)
        for b in ids:
            self.rc[b] += 1
        self.blocks[dst] = list(ids)
        self.pos[dst] = min(self.pos[src], len(ids) * PBS)

    def decode(self):
        for slot in list(self.blocks):
            p, held = self.pos[slot], self.blocks[slot]
            lb = p // PBS
            if p >= PMB * PBS or (lb == len(held) or self.rc[held[lb]] > 1) and not self.free:
                self.finish(slot)
            elif lb == len(held):
                b = self.free.pop()
                self.rc[b] += 1
                held.append(b)
                tc.map_block(self.pool, slot, lb, b)
            elif self.rc[held[lb]] > 1:
                b = self.free.pop()
                self.rc[b] += 1
                self.rc[held[lb]] -= 1
                tc.cow_block(self.pool, slot, lb, b)
                held[lb] = b
        if self.blocks:
            # idle slots map nothing: their writes drop and their cursors hold
            k, v = (torch.from_numpy(self.rng.normal(size=(PSLOTS + 1, PKV, PHD))
                                     .astype(np.float32)) for _ in range(2))
            tc.append_token_paged(self.pool, k, v)
            for slot in self.blocks:
                self.pos[slot] += 1

    def finish(self, slot):
        ids = self.blocks.pop(slot, None)
        tc.free_pages(self.pool, slot)
        for b in ids or ():
            self.rc[b] -= 1
            if self.rc[b] == 0:
                self.free.append(b)
        self.pos.pop(slot, None)

    def check(self):
        rep = self.pool.check_invariants(free_blocks=self.free, host_refcount=self.rc)
        assert rep.ok, rep.violations
        length = tn(self.pool.length)
        for slot in range(PSLOTS + 1):
            assert length[slot] == self.pos.get(slot, 0), slot


@pytest.mark.parametrize("seed", range(4))
def test_random_interleavings_keep_the_pool_invariants(seed):
    """Seeded admit / share (both primitives) / decode / finish sequences,
    double frees included: `check_invariants` (refcount = page-table
    references = the host mirror, free ∩ mapped = ∅, no leak) and the
    cursors hold after every step; at drain every block is free."""
    master = np.random.default_rng(100 + seed)
    for _ in range(3):
        mp = MiniPool(np.random.default_rng(int(master.integers(2 ** 31))))
        for kind, a, b, c in master.integers(0, 64, (14, 4)).tolist():
            slot, active = a % (PSLOTS + 1), sorted(mp.blocks)
            kind %= 5
            if kind == 0:
                mp.admit(slot, MiniPool.LENGTHS[b % 4])
            elif kind == 1 and active:
                mp.share(slot, active[b % len(active)], c % 3 + 1)
            elif kind == 2 and active:
                mp.admit(slot, MiniPool.LENGTHS[c % 4], active[b % len(active)], c % 3 + 1)
            elif kind == 3:
                mp.decode()
            else:
                mp.finish(slot)          # idle or not: a double free is a no-op
            mp.check()
        for slot in list(mp.blocks):
            mp.finish(slot)
            mp.check()
        assert sorted(mp.free) == list(range(NB)) and not tn(mp.pool.refcount).any()


# ---------------------------------------------------------------------------
# the block-sharded engine
# ---------------------------------------------------------------------------

# 16 blocks, 8 per rank at two ranks. A (40 tokens) takes blocks 7, 6, 5 of
# shard 0; its twin shares them; Y (40) takes 15, 14, 13 of shard 1; Z (72)
# takes the rest of shard 0 (a tie of 5 and 5 free goes to shard 0). A's
# first write faults into block 5, whose shard is then full: the copy lands
# in shard 1, across ranks.
SHARD_ENGINE = dict(max_seq=MAX_SEQ, slots=4, block_size=BS, num_blocks=16,
                    prefix_sharing=True)
SHARD_NEW = 4


def _shard_prompts():
    rng = np.random.default_rng(8)
    a = _prompt(rng, 40)
    return [a, a.copy(), _prompt(rng, 40), _prompt(rng, 72)]


def _serve_shard(params, **kw):
    eng = TEngine(TSTATIC, params, paged=True, device="cpu", **SHARD_ENGINE, **kw)
    reqs = [TRequest(rid=i, prompt=p, max_new_tokens=SHARD_NEW)
            for i, p in enumerate(_shard_prompts())]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [r.output for r in reqs], eng


def test_sharded_engine_world1_equals_unsharded(weights):
    _, tp = weights
    want, eng = _serve_shard(tp)
    got, eng1 = _serve_shard(tp, ctx=init_decode_ctx("cpu"))
    assert got == want
    assert eng1.stats.summary()["cow_copies"] == eng.stats.cow_copies == 1
    assert eng1.stats.shared_blocks == 3
    assert sorted(eng1._free_blocks) == list(range(16)) and not eng1._refcount.any()


def _spawn(task, inp, world, tmp_path):
    """``world`` ranks of `_torch_dist_worker.py` over a FileStore in
    ``tmp_path``; returns each rank's results."""
    torch.save(inp, tmp_path / "in.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_dist_worker.py"),
                               task, str(tmp_path), str(r), str(world)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log}"
    return [torch.load(tmp_path / f"out{r}.pt", weights_only=False) for r in range(world)]


# the cross-rank copy at the pool level: 8 blocks, 4 per rank; slot 1 holds
# blocks [1, 2] of rank 0, slot 0 shares both, then copies logical 0 into
# block 3 (rank 0) and logical 1 into block 6 (rank 1)
COW_STEPS = ((0, 0, 3), (0, 1, 6))


def _jax_cow_pool(cow_inp, mode):
    jp = JParams(**POOL_PARAMS)
    pool = jc.empty_paged_cache(8, PBS, 2, PMB, PKV, PHD, jp.r(PHD), kv_pool_dtype=mode)
    src = jc.prefill_cache(jnp.asarray(cow_inp["k"]), jnp.asarray(cow_inp["v"]),
                           max_seq=PMB * PBS, params=jp)
    pool = jc.prefill_into_pages(pool, src, 1, jnp.asarray(cow_inp["pages"]))
    pool = jc.share_blocks(pool, 1, 2, 0)
    for slot, logical, page in COW_STEPS:
        pool = jc.cow_block(pool, slot, logical, page)
    return jc.append_token_paged(pool, jnp.asarray(cow_inp["k1"]), jnp.asarray(cow_inp["v1"]))


def test_sharded_engine_two_gloo_ranks_copy_across_ranks(weights, tmp_path):
    """Two SPMD ranks: the trace's one copy on write crosses ranks (the old
    block on rank 0, the copy on rank 1), the greedy tokens equal the
    unsharded port's, both ranks drain leak-free; and at the pool level a
    cross-rank and a same-rank `cow_block` leave each rank's leaves equal
    to its slice of the JAX pool, in every storage mode."""
    _, tp = weights
    want, _ = _serve_shard(tp)
    rng = np.random.default_rng(9)
    cow = dict(k=rng.normal(size=(1, 7, PKV, PHD)).astype(np.float32),
               v=rng.normal(size=(1, 7, PKV, PHD)).astype(np.float32),
               k1=rng.normal(size=(2, PKV, PHD)).astype(np.float32),
               v1=rng.normal(size=(2, PKV, PHD)).astype(np.float32),
               pages=np.array([1, 2, -1, -1, -1, -1], np.int32))
    res = _spawn("prefix", dict(
        weights=tp, prompts=_shard_prompts(), new_tokens=SHARD_NEW, engine=SHARD_ENGINE,
        cfg=dict(salca_static_channels=True),
        cow=dict(params=POOL_PARAMS, steps=COW_STEPS, shape=(8, PBS, 2, PMB, PKV, PHD),
                 **{k: tt(v) for k, v in cow.items()})), 2, tmp_path)
    for rank, r in enumerate(res):
        assert r["outputs"] == want
        assert r["free"] == list(range(16)) and r["pools_ok"]
        assert r["stats"]["cow_copies"] == 1 and r["stats"]["shared_blocks"] == 3
        pt = tn(r["ticks"][0][2])
        assert pt[1, 2] == 5 and pt[0, 2] >= 8, pt        # the copy crossed ranks
        lo, hi = 4 * rank, 4 * rank + 4
        for mode, leaves in r["cow"].items():
            jpool = _jax_cow_pool(cow, mode)
            for f in tc._DATA_FIELDS:
                j = np.asarray(getattr(jpool, f))[lo:hi]
                np.testing.assert_array_equal(tn(leaves[f], j), j, err_msg=f"{mode} {f}")
            for f in ("page_table", "length", "refcount", "heavy_idx"):
                np.testing.assert_array_equal(tn(leaves[f]), np.asarray(getattr(jpool, f)),
                                              err_msg=f"{mode} {f}")
    for (m0, l0, pt0), (m1, l1, pt1) in zip(res[0]["ticks"], res[1]["ticks"]):
        assert torch.equal(l0, l1) and torch.equal(pt0, pt1)
