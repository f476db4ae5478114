"""Port parity, paged KV cache: every leaf of the pool (data, page table,
refcount, lengths, selection history) after prefill, append, map, free and
block reuse over scrambled physical pages — bit for bit against the JAX
reference (cases of tests/test_paged_cache.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_bridge import CACHE_FIELDS, POOL_FIELDS, assert_fields_equal, tn, tt
from repro.core import cache as jc
from repro.core.selection import SalcaParams as JParams
from repro_torch.core import cache as tc
from repro_torch.core.selection import SalcaParams as TParams

MAX_SEQ, BS = 64, 16
MB = MAX_SEQ // BS
JP = JParams(feature_sparsity=0.5, k=16, k_cap=32, pool_window=7)
TP = TParams(feature_sparsity=0.5, k=16, k_cap=32, pool_window=7)


def _prefill(rng, t):
    k = rng.normal(size=(1, t, 2, 32)).astype(np.float32)
    v = rng.normal(size=(1, t, 2, 32)).astype(np.float32)
    return (jc.prefill_cache(jnp.asarray(k), jnp.asarray(v), max_seq=MAX_SEQ, params=JP),
            tc.prefill_cache(tt(k), tt(v), max_seq=MAX_SEQ, params=TP))


def _pools(num_blocks=20, slots=3):
    return (jc.empty_paged_cache(num_blocks, BS, slots, MB, kv_heads=2, head_dim=32, r=16),
            tc.empty_paged_cache(num_blocks, BS, slots, MB, kv_heads=2, head_dim=32, r=16))


def _pages(ids):
    p = np.full(MB, -1, np.int32)
    p[:len(ids)] = ids
    return p


@pytest.mark.parametrize("t", [1, 16, 40, 64])
def test_prefill_cache_bitwise(rng, t):
    jd, td = _prefill(rng, t)
    assert_fields_equal(jd, td, CACHE_FIELDS)


def test_prefill_into_pages_scrambled_bitwise(rng):
    jd, td = _prefill(rng, 40)
    jp, tp = _pools()
    pages = _pages([13, 2, 7])
    jp = jc.prefill_into_pages(jp, jd, 1, jnp.asarray(pages))
    tc.prefill_into_pages(tp, td, 1, tt(pages))
    assert_fields_equal(jp, tp, POOL_FIELDS)
    np.testing.assert_array_equal(tn(tp.mapped_valid_mask()), np.asarray(jp.mapped_valid_mask()))
    np.testing.assert_array_equal(tn(tp.clamped_pages()), np.asarray(jp.clamped_pages()))


def test_append_map_free_reuse_bitwise(rng):
    """Appends cross a block boundary through `map_block`, an unmapped slot
    drops its write, a free returns the blocks, and a second request reuses
    them (stale rows behind the valid mask) — the pool stays bit-equal."""
    jd, td = _prefill(rng, 40)
    jp, tp = _pools()
    jp = jc.prefill_into_pages(jp, jd, 1, jnp.asarray(_pages([13, 2, 7])))
    tc.prefill_into_pages(tp, td, 1, tt(_pages([13, 2, 7])))
    fresh = [17, 18, 19]
    for _ in range(10):
        k3 = rng.normal(size=(3, 2, 32)).astype(np.float32)
        v3 = rng.normal(size=(3, 2, 32)).astype(np.float32)
        cur = int(jp.length[1])
        if cur % BS == 0 and int(jp.page_table[1, cur // BS]) < 0:
            b = fresh.pop(0)
            jp = jc.map_block(jp, 1, cur // BS, b)
            tc.map_block(tp, 1, cur // BS, b)
        # eager on purpose: under jit XLA turns (hi - lo) / 3 into a multiply
        # by 1/3, 1 ulp off IEEE division on some rows; the port divides
        jp = jc.append_token_paged(jp, jnp.asarray(k3), jnp.asarray(v3))
        tc.append_token_paged(tp, tt(k3), tt(v3))
        assert_fields_equal(jp, tp, POOL_FIELDS)
    assert int(tp.length[1]) == 50 and int(tp.length[0]) == 0
    jp, tp = jc.free_pages(jp, 1), tc.free_pages(tp, 1)
    assert_fields_equal(jp, tp, POOL_FIELDS)
    jd2, td2 = _prefill(rng, 25)
    jp = jc.prefill_into_pages(jp, jd2, 0, jnp.asarray(_pages([17, 13])))
    tc.prefill_into_pages(tp, td2, 0, tt(_pages([17, 13])))
    assert_fields_equal(jp, tp, POOL_FIELDS)
    assert tp.check_invariants(free_blocks=[b for b in range(20) if b not in (17, 13)]).ok


def test_full_slot_and_masked_cursor_drop_writes(rng):
    """A cursor at max_seq or at -1 (the engine's inactive-slot sentinel)
    and a slot at full capacity drop their writes and hold their cursor."""
    jd, td = _prefill(rng, MAX_SEQ)
    jp, tp = _pools()
    jp = jc.prefill_into_pages(jp, jd, 0, jnp.asarray(_pages([3, 4, 5, 6])))
    tc.prefill_into_pages(tp, td, 0, tt(_pages([3, 4, 5, 6])))
    jp2 = jc.prefill_into_pages(jp, jd, 1, jnp.asarray(_pages([7, 8, 9, 10])))
    tc.prefill_into_pages(tp, td, 1, tt(_pages([7, 8, 9, 10])))
    jp = jp2._replace(length=jp2.length.at[1].set(-1))
    tp.length[1] = -1
    k3 = rng.normal(size=(3, 2, 32)).astype(np.float32)
    jp = jc.append_token_paged(jp, jnp.asarray(k3), jnp.asarray(k3))
    tc.append_token_paged(tp, tt(k3), tt(k3))
    assert_fields_equal(jp, tp, POOL_FIELDS)
    assert int(tp.length[0]) == MAX_SEQ and int(tp.length[1]) == -1


def test_record_selection_bitwise(rng):
    jd, td = _prefill(rng, 40)
    jp, tp = _pools()
    jp = jc.prefill_into_pages(jp, jd, 1, jnp.asarray(_pages([13, 2, 7])))
    tc.prefill_into_pages(tp, td, 1, tt(_pages([13, 2, 7])))
    idx = rng.integers(0, MAX_SEQ, (3, 2, 12)).astype(np.int32)
    mask = rng.integers(0, 2, (3, 2, 12)).astype(bool)
    for _ in range(2):
        jp = jc.record_selection(jp, jnp.asarray(idx), jnp.asarray(mask))
        tc.record_selection(tp, tt(idx), tt(mask))
    assert_fields_equal(jp, tp, POOL_FIELDS)


def test_check_invariants_flags_leaks_and_mismatch(rng):
    _, td = _prefill(rng, 40)
    _, tp = _pools()
    tc.prefill_into_pages(tp, td, 1, tt(_pages([13, 2, 7])))
    free = [b for b in range(20) if b not in (13, 2, 7)]
    assert tp.check_invariants(free_blocks=free).ok
    assert not tp.check_invariants(free_blocks=free[:-1]).ok        # leaked block
    assert not tp.check_invariants(free_blocks=free + [13]).ok      # free ∩ mapped
    tp.refcount[2] += 1
    assert not tp.check_invariants().ok                             # refcount mismatch
