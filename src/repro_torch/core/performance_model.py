"""The paper's §4.4 performance model, and the bytes-per-token model of
decode attention.

Port of the reference `core/performance_model.py`: pure arithmetic, the
same functions with the same values. The ASIC model balances HBM
pseudo-channel (PC) allocation and compute parallelism between the
*pre-computing* (relevance estimation) stream and the *attention* (sparse
K/V gather) stream:

* per-key pre-computing cost:  ``2·d·s_f + 32`` bits (2-bit features + two
  FP16 factors);
* per-key attention cost:      ``16·d`` bits (INT8 K and V);
* bandwidth constraint: ``(pre_bits·m_pre + att_bits·m_att)·f_cmp ≤
  bw·chn·f_hbm``;
* pipeline balance: minimum supported retention rate
  ``r_q = (β_att·m_att) / (β_pre·m_pre·α)``.

`solve()` gives the paper's operating point (m_pre=25 at m_att=2; after
parallelism rounding p_pre=16 ⇒ m_pre=17, min retention ≈ 5.8%, h_pre=11).
`HardwareSpec`'s defaults are the paper's ASIC (one HBM2 stack of 32
pseudo-channels, a 500 MHz compute clock): they describe that design, not
a TPU and not the GPU the port runs on.

The bytes-per-token half counts the bytes that must cross HBM per decoded
token per attention layer — dense, a 4-bit full-feature filter, and Salca
— plus the block-sharded tick's collectives, the paged pool's bytes per
block and the host tier's PCIe traffic. Divided by a device's memory rate
(`analysis.roofline.HBM_BW` for the H100) they give a byte bound.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace


@dataclass(frozen=True)
class HardwareSpec:
    """ASIC-side constants (defaults = the paper's design)."""

    d: int = 128                 # head dimension
    chn: int = 32                # HBM pseudo-channel count (one HBM2)
    bw_bits: int = 128           # bits per PC per HBM cycle (512 GB/s / 32 PCs @1GHz)
    f_cmp: float = 500e6         # compute clock
    f_hbm: float = 1e9           # HBM clock
    alpha: float = 1.17          # channel-conflict latency multiplier (range 128)
    beta_pre: float = 0.95       # HBM transfer efficiency, sequential stream
    beta_att: float = 0.55       # HBM transfer efficiency, gathered stream


@dataclass(frozen=True)
class DesignPoint:
    m_pre: int                   # memory-access parallelism, pre-computing
    m_att: int                   # memory-access parallelism, attention
    p_pre: int                   # compute parallelism, pre-computing
    p_att: int                   # compute parallelism, attention
    h_pre: int                   # HBM PCs allocated to pre-computing
    h_att: int                   # HBM PCs allocated to attention
    min_retention: float         # minimum r_q the pipeline sustains
    u_pre: float                 # hardware utilization, pre-computing
    u_att: float


def pre_bits_per_key(d: int, s_f: float) -> float:
    """2-bit features over the heavy channels + two FP16 factors."""
    return 2.0 * d * s_f + 32.0


def att_bits_per_key(d: int) -> float:
    """INT8 K + INT8 V per selected token."""
    return 16.0 * d


def bandwidth_bits_per_cycle(hw: HardwareSpec) -> float:
    """HBM bits deliverable per *compute* cycle."""
    return hw.bw_bits * hw.chn * hw.f_hbm / hw.f_cmp


def pc_allocation(hw: HardwareSpec, s_f: float, m_pre: int, m_att: int) -> tuple[int, int]:
    h_pre = math.ceil(pre_bits_per_key(hw.d, s_f) * m_pre * hw.f_cmp
                      / (hw.beta_pre * hw.bw_bits * hw.f_hbm))
    h_att = math.ceil(att_bits_per_key(hw.d) * m_att * hw.f_cmp
                      / (hw.beta_att * hw.bw_bits * hw.f_hbm))
    return h_pre, h_att


def min_retention(hw: HardwareSpec, m_pre: int, m_att: int) -> float:
    """Pipeline-balance bound: below this retention, pre-computing is the
    critical path and extra attention bandwidth is wasted."""
    return (hw.beta_att * m_att) / (hw.beta_pre * m_pre * hw.alpha)


def decode_cycles(hw: HardwareSpec, n: int, r_q: float, m_pre: int, m_att: int) -> float:
    """Per-head decode latency (compute cycles): max of the two streams."""
    t_pre = n / (hw.beta_pre * m_pre)
    t_att = n * r_q * hw.alpha / (hw.beta_att * m_att)
    return max(t_pre, t_att)


def solve(hw: HardwareSpec, s_f: float, target_retention: float) -> DesignPoint:
    """Pareto search over (m_pre, m_att) under the bandwidth constraint,
    then parallelism rounding (§4.4's two-step procedure)."""
    bw = bandwidth_bits_per_cycle(hw)
    pre_b, att_b = pre_bits_per_key(hw.d, s_f), att_bits_per_key(hw.d)
    best = None
    for m_att in range(1, hw.chn + 1):
        rem = bw - att_b * m_att
        if rem <= 0:
            break
        m_pre = int(rem // pre_b)
        if m_pre < 1:
            continue
        if min_retention(hw, m_pre, m_att) > target_retention:
            continue  # cannot sustain the target sparsity
        t = decode_cycles(hw, n=1, r_q=target_retention, m_pre=m_pre, m_att=m_att)
        if best is None or t < best[0]:
            best = (t, m_pre, m_att)
    if best is None:  # fall back to the most filter-heavy feasible point
        m_att = 1
        m_pre = max(1, int((bw - att_b) // pre_b))
        best = (decode_cycles(hw, 1, target_retention, m_pre, m_att), m_pre, m_att)
    _, m_pre, m_att = best
    # Parallelism rounding per the paper: match compute to *effective* data
    # supply, then floor to hardware-regular powers of two (§4.4 sets
    # p_att=1 "given m_att·β_att = 1.1 ≪ 2", i.e. floor, not ceil).
    p_pre = 1 << int(math.log2(max(m_pre * hw.beta_pre, 1.0)))
    p_att = 1 << int(math.log2(max(m_att * hw.beta_att, 1.0)))
    m_pre_f = math.ceil(p_pre / hw.beta_pre)
    m_att_f = math.ceil(p_att / hw.beta_att)
    h_pre, h_att = pc_allocation(hw, s_f, p_pre, p_att)
    # PC-budget feasibility: shrink the hungrier side until it fits.
    while h_pre + h_att > hw.chn and (p_pre > 1 or p_att > 1):
        if h_att > h_pre and p_att > 1:
            p_att //= 2
        elif p_pre > 1:
            p_pre //= 2
        else:
            p_att //= 2
        m_pre_f = math.ceil(p_pre / hw.beta_pre)
        m_att_f = math.ceil(p_att / hw.beta_att)
        h_pre, h_att = pc_allocation(hw, s_f, p_pre, p_att)
    return DesignPoint(
        m_pre=m_pre_f, m_att=m_att_f, p_pre=p_pre, p_att=p_att,
        h_pre=h_pre, h_att=h_att,
        min_retention=min_retention(hw, m_pre_f, m_att_f),
        u_pre=(m_pre_f * hw.beta_pre) / math.ceil(m_pre_f * hw.beta_pre),
        u_att=(m_att_f * hw.beta_att) / math.ceil(m_att_f * hw.beta_att),
    )


# ---------------------------------------------------------------------------
# HBM bytes per decoded token per attention layer
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DecodeBytes:
    feature_stream: float   # sequential pre-computing reads
    kv_gather: float        # gathered exact-attention reads
    total: float


def kv_store_bits_per_key(d: int, kv_pool_dtype: str = "int8",
                          block_size: int = 16) -> float:
    """Bits ONE token's exact K+V rows occupy in the paged block pool.

    Matches `core.cache.empty_paged_cache` byte for byte: int8 carries two
    per-token f32 scales, int4 packs two values per byte and amortizes one
    per-block, per-head f32 scale pair over `block_size` tokens, fp16 is the
    raw-rows baseline (its unit scales are never read on the hot path)."""
    if kv_pool_dtype == "fp16":
        return 2.0 * 16.0 * d
    if kv_pool_dtype == "int8":
        return 2.0 * 8.0 * d + 2.0 * 32.0
    if kv_pool_dtype == "int4":
        return 2.0 * 4.0 * d + 2.0 * 32.0 / block_size
    raise ValueError(f"unknown kv_pool_dtype {kv_pool_dtype!r}")


def _decode_bytes(n: int, kv_heads: int, feat_bits_per_key: float,
                  kv_bits_per_key: float, retention: float) -> DecodeBytes:
    """The one DecodeBytes composition every per-token helper reduces to:
    a sequential feature stream over all n keys plus a gathered K/V fetch
    over the retained fraction."""
    feat = kv_heads * n * feat_bits_per_key / 8.0
    kv = kv_heads * (n * retention) * kv_bits_per_key / 8.0
    return DecodeBytes(feat, kv, feat + kv)


def salca_bytes_per_token(n: int, d: int, kv_heads: int, s_f: float,
                          retention: float, kv_pool_dtype: str = "int8",
                          block_size: int = 16) -> DecodeBytes:
    """Bytes/step/layer with Salca dual compression (per the paper's layout;
    `kv_pool_dtype` swaps the exact-attention tier's storage precision)."""
    return _decode_bytes(n, kv_heads, pre_bits_per_key(d, s_f),
                         kv_store_bits_per_key(d, kv_pool_dtype, block_size),
                         retention)


def filter4bit_bytes_per_token(n: int, d: int, kv_heads: int, retention: float) -> DecodeBytes:
    """Energon/Sanger-style 4-bit full-feature filter + INT8 attention."""
    return _decode_bytes(n, kv_heads, 4.0 * d + 32.0,
                         kv_store_bits_per_key(d, "int8"), retention)


def dense_bytes_per_token(n: int, d: int, kv_heads: int, dtype_bytes: float = 2.0) -> DecodeBytes:
    return _decode_bytes(n, kv_heads, 0.0, 2.0 * d * dtype_bytes * 8.0, 1.0)


# ---------------------------------------------------------------------------
# Sequence-sharded paged decode: interconnect vs shard-local HBM per tick
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShardedDecodeBytes:
    """Per-(slot, layer, tick) traffic of the block-sharded paged decode."""

    local_feature_stream: float   # sequential pre-computing reads, per shard
    local_kv_gather: float        # gathered exact-attention reads, per shard
    interconnect: float           # collective payload crossing the mesh
    local_total: float            # HBM bytes each shard streams

    @property
    def interconnect_ratio(self) -> float:
        """Collective bytes / shard-local HBM bytes — how cheap the two
        sharded-tick collectives are next to the streamed pool slice."""
        return self.interconnect / max(self.local_total, 1e-9)


def sharded_interconnect_bytes(d: int, kv_heads: int, groups: int,
                               max_blocks: int, n_shards: int,
                               pool_window: int = 7) -> float:
    """Collective payload bytes per (slot, layer, tick) of the sharded tick.

    Collective phase 1 (threshold): the binning bounds pmin/pmax (2 f32 per
    kv head), the pre-pool block-edge halos (2·MB·(w//2) int32), the
    ADDITIVE 256-bin histogram psum and the per-block kept-count psum
    (MB int32). Collective phase 2 (merge): the online-softmax partials
    (m, l: 2 f32; o: d f32 — per query head of the kv group). Every term is
    O(max_blocks + 256 + d) — independent of context length n, which is the
    paper's additive-histogram property doing the distributed work. A ring
    all-reduce moves ~2·(n_shards−1)/n_shards × payload per device; that
    factor is included."""
    if n_shards <= 1:
        return 0.0
    halo = pool_window // 2
    per_kv = (2 * 4                       # lo/hi bounds
              + 2 * max_blocks * halo * 4  # maxpool halo edges (int32 psum)
              + 256 * 4                    # additive histogram
              + max_blocks * 4             # kept-count ranks
              + groups * (2 + d) * 4)      # (m, l, o) softmax merge
    ring = 2.0 * (n_shards - 1) / n_shards
    return kv_heads * per_kv * ring


def sharded_salca_bytes_per_token(n: int, d: int, kv_heads: int, groups: int,
                                  s_f: float, retention: float,
                                  n_shards: int, block_size: int,
                                  pool_window: int = 7) -> ShardedDecodeBytes:
    """Per-shard traffic of one sharded paged decode tick.

    The streamed regions divide by the shard count (each shard reads only
    the feature/K-V blocks it owns); the collectives are context-length-
    independent, so the interconnect share *shrinks* as contexts grow — the
    regime the sharded pool exists for."""
    base = salca_bytes_per_token(n, d, kv_heads, s_f, retention)
    max_blocks = -(-n // block_size)
    ic = sharded_interconnect_bytes(d, kv_heads, groups, max_blocks,
                                    n_shards, pool_window)
    return ShardedDecodeBytes(
        local_feature_stream=base.feature_stream / n_shards,
        local_kv_gather=base.kv_gather / n_shards,
        interconnect=ic,
        local_total=base.total / n_shards)


def sharded_fused_bytes_per_token(n: int, d: int, kv_heads: int, groups: int,
                                  s_f: float, retention: float,
                                  n_shards: int, block_size: int,
                                  pool_window: int = 7,
                                  kv_pool_dtype: str = "int8"
                                  ) -> ShardedDecodeBytes:
    """Per-shard traffic of the FULLY-PIPELINED fused island tick.

    Kernel 1 streams each owned ACTIVE feature block from HBM exactly once
    (≈ n/n_shards keys; unowned blocks clamp to a single repeated fetch the
    pipeline elides), kernel 2 consumes the scores in place, and the
    partials flash kernel fetches only the shard's share of the SELECTED
    blocks — block-granular, since the grid walks whole physical blocks.
    The two collectives are context-length-independent
    (`sharded_interconnect_bytes`). This is what the fused tick actually
    moves: O(owned-active + owned-selected), against the legacy island's
    capacity-shaped `sharded_gather_bytes_per_token`.
    """
    feat = kv_heads * (n / n_shards) * pre_bits_per_key(d, s_f) / 8.0
    sel_blocks = -(-int(math.ceil(n * retention)) // block_size)
    kv = (kv_heads * sel_blocks * block_size / n_shards
          * kv_store_bits_per_key(d, kv_pool_dtype, block_size) / 8.0)
    ic = sharded_interconnect_bytes(d, kv_heads, groups, -(-n // block_size),
                                    n_shards, pool_window)
    return ShardedDecodeBytes(
        local_feature_stream=feat, local_kv_gather=kv,
        interconnect=ic, local_total=feat + kv)


def sharded_gather_bytes_per_token(n: int, d: int, kv_heads: int, groups: int,
                                   s_f: float, retention: float,
                                   n_shards: int, block_size: int,
                                   max_blocks: int, slots: int = 1,
                                   pool_window: int = 7,
                                   kv_pool_dtype: str = "int8"
                                   ) -> ShardedDecodeBytes:
    """Per-shard traffic of the logical-gather island tick (the legacy island).

    Each tick every shard re-materializes full-capacity logical views of
    all seven pool leaves through the page table — (slots, max_blocks·BS,
    KV, ·) copies shaped by pool CAPACITY, not by live tokens or local
    ownership (unowned entries still write clamped rows). Each copy is
    written once and re-read by the consuming op: 2× its bytes. ``n`` and
    ``retention`` do not appear in the streamed terms — that invariance is
    exactly the pathology the fused island removes.
    """
    l_cap = max_blocks * block_size
    feat = 2.0 * slots * kv_heads * l_cap * pre_bits_per_key(d, s_f) / 8.0
    kv = (2.0 * slots * kv_heads * l_cap
          * kv_store_bits_per_key(d, kv_pool_dtype, block_size) / 8.0)
    ic = sharded_interconnect_bytes(d, kv_heads, groups, max_blocks,
                                    n_shards, pool_window)
    return ShardedDecodeBytes(
        local_feature_stream=feat, local_kv_gather=kv,
        interconnect=ic, local_total=feat + kv)


# ---------------------------------------------------------------------------
# Tiered KV memory: pool capacity per HBM budget + host-spill PCIe traffic
# ---------------------------------------------------------------------------

def pool_block_bytes(d: int, kv_heads: int, block_size: int, s_f: float,
                     kv_pool_dtype: str = "int8") -> float:
    """Bytes ONE physical block's data rows occupy per layer: the exact K/V
    tier at `kv_pool_dtype` plus the (precision-independent) packed 2-bit
    feature stream with its two f32 factors per token."""
    kv = block_size * kv_store_bits_per_key(d, kv_pool_dtype, block_size) / 8.0
    feat = block_size * pre_bits_per_key(d, s_f) / 8.0
    return kv_heads * (kv + feat)


def max_context_tokens(hbm_bytes: float, d: int, kv_heads: int, layers: int,
                       block_size: int, s_f: float,
                       kv_pool_dtype: str = "int8") -> int:
    """Longest single context a paged pool of `hbm_bytes` holds across
    `layers` attention layers — the capacity row of the README table.
    Dropping int8 → int4 (or fp16 → int8) raises this near-proportionally
    to the K/V tier's share of the block bytes."""
    per_block = layers * pool_block_bytes(d, kv_heads, block_size, s_f,
                                          kv_pool_dtype)
    return int(hbm_bytes // per_block) * block_size


def cached_prefill_bytes_avoided(hit_blocks: int, *, d: int, kv_heads: int,
                                 block_size: int, layers: int,
                                 s_f: float = 0.5,
                                 kv_pool_dtype: str = "int8") -> float:
    """HBM write traffic a persistent prefix cache saved: every cross-request
    cache-hit block is adopted by reference instead of being re-prefilled,
    skipping the K/V quantize + feature-stream write for that block across
    all `layers`. (Compute savings are strictly larger — this counts only
    the memory-side term the rest of this model is denominated in.)"""
    return hit_blocks * layers * pool_block_bytes(d, kv_heads, block_size,
                                                  s_f, kv_pool_dtype)


@dataclass(frozen=True)
class SpillTraffic:
    """Predicted PCIe cost of a host-spill run (demote + promote moves)."""

    moves: int            # demotions + promotions
    bytes: float          # block_bytes · moves
    seconds: float        # bytes / link bandwidth

    @property
    def bytes_per_move(self) -> float:
        return self.bytes / max(self.moves, 1)


def spill_pcie_traffic(block_bytes: float, demotions: int, promotions: int,
                       pcie_gbps: float = 16.0) -> SpillTraffic:
    """Predicted PCIe transfer for a measured (demotions, promotions) pair.

    Every tier move copies one logical block's data rows (all layers)
    across the link once; `pcie_gbps` defaults to a PCIe 4.0 x16 effective
    rate. The serving benchmark prints this prediction next to measured
    tick times so the model is falsifiable."""
    moves = demotions + promotions
    total = block_bytes * moves
    return SpillTraffic(moves=moves, bytes=total,
                        seconds=total / (pcie_gbps * 1e9))
