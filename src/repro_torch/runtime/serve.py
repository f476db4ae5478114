"""Serving engine: continuous batching over a slot-pooled or paged Salca KV cache.

Port of the reference `runtime/serve.py`. The engine keeps ONE pooled
decode state. Admission is FIFO: a request is prefilled alone (batch 1,
kernel B3) and written into a free slot of that state; each tick makes
exactly ONE decode call that advances all active slots under an
active-slot mask (`runtime.steps`: on the card, one CUDA graph replay
without ``ctx``). Sampling is greedy (argmax, on the device) unless
``greedy=False``: a request with ``temperature > 0`` then draws its token on
the host from its logits row in float64 with Gumbel noise from the engine's
generator (``seed``), as the reference does. Every write into the state —
admission, growth, release, host-tier moves, aborts — is in place: the
state's tensors are the ones the tick's graph was captured over.

Contiguous slot pool (``paged=False``, the default, as in the reference):
every layer's cache is a dense ``(slots, max_seq, ·)`` `SalcaCache`; the
prefill is copied into the slot's row, a finished slot is reset (length
0), and the tick runs kernels B7, B9 and B8 in every global ("A") layer.
A slot that reached ``max_seq`` finishes with an ``overflow`` stop.

Recurrent layers (mamba2's "S", recurrentgemma's "R") keep a dense per-slot
state on both pools: the prefill's final state is copied into the slot's
row, a finished slot's row is zeroed, the tick updates it in place for the
active slots only, and the paged pool's block operations pass it by. A
model with no paged layer (mamba2) still charges and frees blocks on the
paged engine, as the reference's does, and its audit reports the
reference's "no PagedSalcaCache substates" violation.

Sliding-window ("L") layers (gemma3's "LLLLLA") keep a W-slot ring per slot
wherever the window W is shorter than ``max_seq``, on both pools: the
prefill writes the ring whole, the tick attends over it densely (no Salca,
no kernel), and the paged pool's block operations pass it by. Under
``ctx`` every rank holds W / world of each ring's rows and the tick is the
sequence-sharded flat tick. With ``flags.perf_flags(ring_local_cache=False)``
an "L" layer keeps the full context instead, attended under the window mask.

Sequence-sharded contiguous pool (``paged=False, ctx=DecodeCtx(...)``, the
reference's flat ``sp_*`` decode): every rank holds ``max_seq / world``
rows of each slot's cache, writes the rows of the replicated prefill that
fall in its range, and runs the flat tick (kernels B7, B10, B11 and B8's
partials branch around the all-reduces and the halo exchange of
`core.sp_decode`); ``stats.shards`` stays 1, as it counts pool shards.

Paged pool (``paged=True``): every layer's attention cache is a shared
physical block pool with per-slot page tables. Admission writes the
prompt into the ``ceil(prompt / block_size)`` blocks it takes from the
free list and waits head-of-line while the pool cannot cover it. Each tick
first grows every slot whose cursor crossed a block boundary by one block
(or finishes it with an ``overflow`` stop when the free list is empty);
the tick runs kernels B1 and B2 in every global layer. ``fused_decode=False``
pins the reference's unfused baseline instead (B7 over the feature stream
gathered into logical order, B8 over the gathered rows; the same
selection); on a pool sharded over more than one rank it pins the
logical-gather island.

Block-sharded paged pool (``ctx=DecodeCtx(...)``): the physical block dim is
split evenly across the ranks of the context's process group, each rank
holding ``num_blocks / world_size`` blocks, and the tick runs the sharded
island (kernels B4, B5, B6 and two collective phases). Every rank runs this
same host loop on the same requests (SPMD): allocation is deterministic, so
page tables stay identical across ranks, and the all-reduced attention
gives every rank the same logits and hence the same greedy tokens. One free
list per shard (`ShardedBlockAllocator`): admission takes blocks from the
least-loaded shards, so one request can span shards; growth prefers the
shard holding the slot's tail block.

Prefix sharing (``prefix_sharing=True``, paged only) maps identical
prompt prefixes (system prompts, few-shot headers) onto the same physical
blocks, as in the reference. A radix map keys each full block of a
prompt, and a prompt's partial last block, by the SHA-1 digest of the
token ids up to its end and names the block that holds it. Admission
prefills the queue head once (stashed across head-of-line retries), maps
the longest matched prefix by reference and charges only the rest against
the free list; a matched block is shared only while its owner's heavy sets
equal the request's, as the packed features are encoded against them
(``salca_static_channels`` makes them request-independent). Release
decrements a host mirror of the refcount and frees a block, and prunes its
radix entry, at zero. Before a tick a slot whose cursor block is shared
gets a private copy (`core.cache.cow_block`): the write that the append
would drop lands in the copy.

The persistent prefix cache (``prefix_cache=True``, with
``prefix_sharing``) makes the radix map a cache across requests, as in the
reference: a radix-published block whose last resident owner releases it
stays mapped in the radix map under a host-side cache pin (its refcount
stays 0; the allocator just does not get the id back), so a later request
with the same prefix admits against it by reference. A prompt matched in
full whose first-token logits row was kept admits with no prefill at all:
a metadata-only ``adopt_pages`` maps its blocks (all-"A" stacks with
``salca_static_channels``, where the kept rows carry the static heavy
sets), and its TTFT shrinks to that call. Eviction is LRU by last hit, the
deepest block first within a stamp, so a radix chain never loses an
ancestor before its descendants; a pin is the cheapest block to reclaim,
so admission, chunk charging, growth, copy on write and preemption drain
the cache's cold end before any host-tier demotion or preemption. With
``host_spill`` a squeezed pin demotes to a bounded host cold tier
(``CACHE_COLD``) instead and is rehydrated on its next hit. The kept rows
are what a cold prefill writes, so outputs equal a cold engine's. int4
pools are refused: their append requantizes a whole partial block.

Tiered KV memory (paged only): ``kv_pool_dtype`` picks the pool's K/V
storage — "int8" (the default), "fp16" or "int4" (`core.cache`); the
2-bit feature stream, and so the selection, is the same in every mode.
``host_spill=True`` adds a host tier: a private block outside a slot's
``spill_keep_recent`` trailing blocks that no layer selected for
``demote_after`` consecutive ticks demotes to pinned host memory in
storage format (bit-exact both ways) and frees its physical block; a
spilled block is unselectable (`mapped_valid_mask`) until it is promoted
back, highest cumulative selection count first, at most one per slot per
tick and only while more than ``promote_headroom`` blocks are free.
Demotion also fires under pressure (admission and growth with a dry free
list, coldest first), and a prompt larger than the free pool is admitted
in waves, each wave but the last demoted as soon as it lands. The policy
reads the layers' selection histograms once per tick (one device sync,
only with ``host_spill``). Transfers run on the tick's stream, so a freed
block is not rewritten before its bytes have left. A block-sharded pool
(``ctx`` over more than one rank) refuses ``host_spill``, as the reference:
its island records no selection histograms.

Continuous batching (paged only), as in the reference: ``prefill_chunk=C``
streams a prompt into its reserved slot in C-token chunks, one chunk per
scheduler pass between decode ticks of the other slots, so a long prompt
stalls their token streams for one chunk instead of one whole prefill. At
most one prefill is in flight; its slot stays masked off until the final
chunk activates it, each chunk charges the blocks it first covers, and a
dry free list stalls the chunk (decode keeps running). Each chunk runs
kernel B3 over the prompt's full-precision K/V buffers with the causal mask
shifted by the chunk's offset, so its rows, and the pool rows it writes,
equal the monolithic prefill's. It needs ``salca_static_channels`` (the
per-input heavy sets need the whole prompt's K) and an int8 or fp16 pool.
``preempt=True`` answers a dry free list at block growth by preempting the
newest occupant — an active slot or the in-flight prefill — instead of an
``overflow`` stop: its blocks are released, and its request goes back to
the queue head, re-prefills its prompt and is force-fed its recorded tokens
through ordinary ticks, so its output equals a never-preempted run's. A
request's queue wait sums over its admission cycles.

Failure model, as in the reference: every failure path degrades instead of
crashing. A request may carry ``deadline_ms`` (expiry ends it with
``stop_reason="deadline"`` and full block, stash and radix cleanup, wherever
it is: queued, mid-chunked-prefill or resident); ``cancel(rid)`` works on
queued, in-flight and resident requests; a bounded queue (``max_queue``)
sheds new submits with ``stop_reason="rejected"``. A failed host-tier
transfer retries with capped exponential backoff (``spill_max_retries``,
``spill_backoff_base``, ``spill_backoff_cap``, in ticks); a promotion that
runs out of retries pins the block cold — unmapped, so the selection never
reads it and decode goes on with sparser attention (`stats.degraded_ticks`
counts such ticks) — and a demotion that runs out pins it hot. A slot
whose logits row comes back non-finite (the tick's ``finite`` output) is
quarantined with ``stop_reason="error"`` without touching the tick's other
slots. A seeded `runtime.faults.FaultPlan` (``faults=``) injects all of
these deterministically; ``audit_every`` runs `check_invariants` (the
pools' refcounts against their page tables and the host mirror, free ∩
mapped = ∅, cursor bounds, host against device page tables, the spill
mirror) every N ticks and raises on a violation; ``monitor`` /
``heartbeat_path`` record every tick's time in a `runtime.monitor.StepMonitor`
(straggler flags, a heartbeat file).

Knobs that the reference rejects raise its `ValueError`s.
"""

from __future__ import annotations

import dataclasses
import hashlib
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cache import InvariantReport, PagedSalcaCache, SalcaCache
from repro_torch.distributed.sharding import DecodeCtx
from repro_torch.flags import perf_flags
from repro_torch.kernels.common import resolve_device
from repro_torch.models.registry import get_model
from repro_torch.runtime.faults import FaultPlan
from repro_torch.runtime.monitor import NaNGuard, StepMonitor
from repro_torch.runtime.steps import ServeDecodeStep, to_host

SPILLED = -1     # a slot's logical block that lives in the host tier
# a radix node whose cache-pinned block was demoted to the host cold tier
# (`_cold_cache`): its key stays matchable and is rehydrated on a hit
CACHE_COLD = -2


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (T,) int32
    max_new_tokens: int = 16
    stop_token: int | None = None
    temperature: float = 0.0           # 0: greedy; > 0: sampled (greedy=False)
    deadline_ms: float | None = None   # wall-clock budget from submission
    submitted: float = field(default_factory=time.time)
    admitted: float | None = None
    first_token_time: float | None = None
    done_time: float | None = None
    # "length" | "stop"; capacity: "overflow"; lifecycle: "deadline" |
    # "cancelled" | "rejected" (shed by the bounded queue); fault: "error"
    # (the slot's logits row was not finite)
    stop_reason: str | None = None
    output: list = field(default_factory=list)
    shared_blocks: int = 0             # blocks admitted by prefix sharing
    preemptions: int = 0               # times evicted and requeued
    token_times: list = field(default_factory=list)   # wall time per fresh token
    # host-side stashes kept across head-of-line retries: the prompt's
    # prefix digests and its heavy-set bytes
    _digests: tuple | None = field(default=None, repr=False, compare=False)
    _heavy: bytes | None = field(default=None, repr=False, compare=False)
    # preemption: the recorded output to force-feed after the re-prefill,
    # the queue wait summed over admission cycles, the requeue time, and
    # whether the current cycle has counted its wait
    _replay: list | None = field(default=None, repr=False, compare=False)
    _queue_wait: float = field(default=0.0, repr=False, compare=False)
    _requeued_at: float | None = field(default=None, repr=False, compare=False)
    _cycle_started: bool = field(default=False, repr=False, compare=False)

    @property
    def queue_wait_s(self) -> float | None:
        """Time spent queued, summed over the first submission and every
        preemption requeue (None until work starts)."""
        return None if self.admitted is None else self._queue_wait

    @property
    def ttft_s(self) -> float | None:
        return None if self.first_token_time is None else self.first_token_time - self.submitted

    def stats(self) -> dict:
        """Per-request stats, the reference's keys."""
        return {"rid": self.rid, "prompt_tokens": int(len(self.prompt)),
                "output_tokens": len(self.output), "stop_reason": self.stop_reason,
                "queue_wait_s": self.queue_wait_s, "ttft_s": self.ttft_s,
                "preemptions": self.preemptions}


class ShardedBlockAllocator:
    """Host-side per-shard free lists over a block pool whose physical block
    dim is split into ``n_shards`` contiguous ranges (shard of block ``b`` =
    ``b // (num_blocks // n_shards)``, the rule `local_block_range` applies
    on the device). The lists are disjoint, every id stays in its shard's
    range, and an allocated block is in no list until released.
    ``n_shards=1`` is a single free list popping the highest id."""

    def __init__(self, num_blocks: int, n_shards: int = 1):
        if num_blocks % n_shards:
            raise ValueError(f"num_blocks {num_blocks} must divide evenly "
                             f"across {n_shards} shards")
        self.num_blocks = num_blocks
        self.n_shards = n_shards
        self.blocks_per_shard = num_blocks // n_shards
        self._free = [list(range(s * self.blocks_per_shard, (s + 1) * self.blocks_per_shard))
                      for s in range(n_shards)]

    def shard_of(self, block: int) -> int:
        return block // self.blocks_per_shard

    @property
    def total_free(self) -> int:
        return sum(len(f) for f in self._free)

    def free_counts(self) -> list[int]:
        return [len(f) for f in self._free]

    def free_ids(self) -> list[int]:
        """Flat snapshot of every free block id."""
        return [b for f in self._free for b in f]

    def alloc(self, need: int, prefer: int | None = None) -> list[int] | None:
        """Pop ``need`` blocks, or None (nothing popped) if the pool cannot
        cover them. ``prefer`` drains that shard first; otherwise blocks come
        from the least-loaded shards (most free first), spilling across
        shards so one request can exceed one shard's pool."""
        if need > self.total_free:
            return None
        order = sorted(range(self.n_shards), key=lambda s: -len(self._free[s]))
        if prefer is not None:
            order = [prefer] + [s for s in order if s != prefer]
        out: list[int] = []
        for s in order:
            while self._free[s] and len(out) < need:
                out.append(self._free[s].pop())
            if len(out) == need:
                break
        return out

    def release(self, block: int) -> None:
        self._free[self.shard_of(block)].append(block)

    def take(self, block: int) -> None:
        """Remove a specific id from its shard's list."""
        self._free[self.shard_of(block)].remove(block)


@dataclass
class ServeStats:
    prefill_s: float = 0.0
    decode_s: float = 0.0
    decode_steps: int = 0      # per-slot token decodes (Σ active over ticks)
    ticks: int = 0
    decode_calls: int = 0      # decode dispatches (== ticks by design)
    completed: int = 0
    tokens_generated: int = 0  # includes the prefill-produced first token
    queue_wait_s: float = 0.0  # summed over admission cycles
    ttft_s: float = 0.0        # summed over first tokens
    admissions: int = 0        # admission cycles begun (re-admissions count)
    ttft_count: int = 0        # requests that produced a first token
    peak_active_slots: int = 0
    overflows: int = 0
    dropped_writes: int = 0
    # continuous batching (zero unless prefill_chunk / preempt are set)
    preemptions: int = 0       # occupants evicted to free blocks and requeued
    replayed_tokens: int = 0   # recorded tokens force-fed after a re-prefill
    prefill_chunks: int = 0    # chunk steps run
    chunk_stalls: int = 0      # chunk passes that waited on the block pool
    prefill_tokens: int = 0    # prompt tokens prefilled (whole and by chunks)
    block_pool_size: int = 0
    block_size: int = 0
    blocks_in_use: int = 0
    peak_blocks_in_use: int = 0
    shards: int = 1                      # pool shards (the ctx's world size)
    peak_shard_blocks_in_use: int = 0    # hottest single shard at peak (shards > 1)
    # prefix sharing (zero unless prefix_sharing=True): `shared_blocks` and
    # `prefix_hits` count sharing between requests resident together; hits
    # on the persistent cache are the `cache_*` counters
    shared_blocks: int = 0     # blocks admitted by reference instead of written
    cow_copies: int = 0        # shared blocks copied on their first write
    prefix_hits: int = 0       # requests that shared at least one resident block
    # the persistent prefix cache (zero unless prefix_cache=True)
    cache_hits: int = 0        # requests that took at least one cache-pinned block
    cache_hit_blocks: int = 0  # cache-pinned blocks taken (refcount 0 → 1)
    cache_evictions: int = 0   # pins and cold entries dropped under pressure
    cache_pinned_blocks: int = 0   # pins held (last sample)
    peak_cache_blocks: int = 0
    zero_prefill_hits: int = 0     # prompts matched in full, admitted with no prefill
    # tiered KV memory (zero unless host_spill=True)
    host_spill: bool = False
    hot_blocks: int = 0        # device-resident blocks in use (last sample)
    cold_blocks: int = 0       # host-resident spilled blocks (last sample)
    peak_cold_blocks: int = 0
    demotions: int = 0         # block moves device → host
    promotions: int = 0        # block moves host → device
    pcie_bytes: int = 0        # block bytes × moves
    # request lifecycle and fault tolerance; `admissions` still equals
    # `completed + preemptions` at drain: a deadline, cancel or error stop
    # of a request whose cycle began counts in `completed`, a request ended
    # in the queue before any work only in its own counter
    deadline_stops: int = 0    # deadline expiries (queued, in flight, resident)
    cancellations: int = 0     # cancel() calls that ended a request
    rejections: int = 0        # submits shed by the bounded queue
    errors: int = 0            # slots quarantined on a non-finite logits row
    retries: int = 0           # failed transfers and chunk steps left to retry
    degraded_ticks: int = 0    # ticks with a stalled slot or a cold-pinned block
    faults_injected: int = 0   # FaultPlan injections that fired
    audits: int = 0            # integrity audits run (audit_every)
    audit_failures: int = 0    # audits that reported violations
    straggler_ticks: int = 0   # ticks the StepMonitor flagged slow
    tick_ewma_s: float = 0.0   # the monitor's tick-time EWMA (0: no monitor)

    def summary(self) -> dict:
        """The reference's summary keys, and only those, rounded as there
        (seconds to 4 places, ms and utilisations to 3); the fault, audit and
        monitor keys only when they have counted, the block-pool and sharing
        keys only for a paged engine, the shard keys only over several
        shards, the persistent cache's keys only once it has held a pin."""
        out = {
            "completed": self.completed, "prefill_s": round(self.prefill_s, 4),
            "decode_s": round(self.decode_s, 4), "decode_steps": self.decode_steps,
            "ticks": self.ticks, "decode_calls": self.decode_calls,
            "tokens_generated": self.tokens_generated,
            "decode_ms_per_step": round(1e3 * self.decode_s / max(self.decode_steps, 1), 3),
            "decode_ms_per_tick": round(1e3 * self.decode_s / max(self.ticks, 1), 3),
            "mean_queue_wait_s": round(self.queue_wait_s / max(self.admissions, 1), 4),
            "mean_ttft_s": round(self.ttft_s / max(self.ttft_count, 1), 4),
            "admissions": self.admissions, "peak_active_slots": self.peak_active_slots,
            "overflows": self.overflows, "dropped_writes": self.dropped_writes,
            "preemptions": self.preemptions, "replayed_tokens": self.replayed_tokens,
            "prefill_chunks": self.prefill_chunks, "chunk_stalls": self.chunk_stalls,
            "deadline_stops": self.deadline_stops, "cancellations": self.cancellations,
            "rejections": self.rejections, "errors": self.errors, "retries": self.retries,
            "degraded_ticks": self.degraded_ticks,
        }
        if self.faults_injected:
            out["faults_injected"] = self.faults_injected
        if self.audits:
            out.update(audits=self.audits, audit_failures=self.audit_failures)
        if self.tick_ewma_s:
            out.update(straggler_ticks=self.straggler_ticks,
                       tick_ewma_ms=round(1e3 * self.tick_ewma_s, 3))
        if self.block_pool_size:
            out.update(block_pool_size=self.block_pool_size,
                       peak_blocks_in_use=self.peak_blocks_in_use,
                       block_utilization=round(self.peak_blocks_in_use / self.block_pool_size,
                                               3))
            if self.shards > 1:
                out.update(shards=self.shards,
                           peak_shard_blocks_in_use=self.peak_shard_blocks_in_use,
                           shard_block_utilization=round(
                               self.peak_shard_blocks_in_use
                               / (self.block_pool_size // self.shards), 3))
            # each shared or adopted admission saved a block, each copy paid
            # one back
            saved = self.shared_blocks + self.cache_hit_blocks - self.cow_copies
            out.update(shared_blocks=self.shared_blocks, cow_copies=self.cow_copies,
                       prefix_hits=self.prefix_hits, effective_blocks_saved=saved,
                       memory_saved_tokens=saved * self.block_size)
            if self.cache_hits or self.cache_evictions or self.peak_cache_blocks:
                out.update(cache_hits=self.cache_hits, cache_hit_blocks=self.cache_hit_blocks,
                           cache_saved_tokens=self.cache_hit_blocks * self.block_size,
                           cache_evictions=self.cache_evictions,
                           cache_pinned_blocks=self.cache_pinned_blocks,
                           peak_cache_blocks=self.peak_cache_blocks,
                           zero_prefill_hits=self.zero_prefill_hits)
            if self.host_spill:
                out.update(hot_blocks=self.hot_blocks, cold_blocks=self.cold_blocks,
                           peak_cold_blocks=self.peak_cold_blocks, demotions=self.demotions,
                           promotions=self.promotions, pcie_bytes=self.pcie_bytes)
        return out


@dataclass
class _InflightPrefill:
    """The one chunked prefill in flight. Its slot is reserved (out of the
    free list) and masked off until the final chunk; ``_slot_blocks`` and
    ``_slot_pos`` hold what its chunks have charged and written, so a
    preemption releases exactly that."""
    req: Request
    slot: int
    cursor: object                      # `models.transformer.PrefillCursor`
    consumed: int = 0                   # prompt tokens prefilled so far
    n_shared: int = 0                   # radix-matched prefix blocks
    n_cache: int = 0                    # of those, taken from the cache's pins
    shared_ids: list = field(default_factory=list)
    pages: np.ndarray | None = None     # the page row mapped so far (-1 beyond)


class ServingEngine:
    """Slot-pooled continuous-batching engine.

    ``paged=False`` (the default): a contiguous ``(slots, max_seq, ·)`` cache
    per layer; ``ctx`` (`distributed.sharding.DecodeCtx`) splits its rows
    across the ranks (``max_seq`` and every ring must divide evenly).
    ``paged=True``: ``num_blocks`` physical blocks of ``block_size`` tokens
    shared by ``slots`` request slots; ``block_size`` must divide
    ``max_seq``; ``ctx`` splits the pool's blocks across its ranks, and
    ``num_blocks`` must then divide evenly by the world size. ``prefix_sharing``: common prompt
    prefixes share blocks, copied on write; ``prefix_cache``: the persistent
    prefix cache of the module docstring. ``kv_pool_dtype`` and ``host_spill``
    (with ``demote_after``, ``spill_keep_recent``, ``promote_headroom``):
    the tiered pool of the module docstring. ``prefill_chunk`` (a chunk's
    tokens) and ``preempt``: continuous batching, as the module docstring
    says. ``greedy`` / ``seed``: sampling (the module docstring);
    ``max_queue``, ``faults``, ``audit_every``, ``spill_max_retries``,
    ``spill_backoff_base``, ``spill_backoff_cap``, ``monitor`` and
    ``heartbeat_path``: the failure model of the module docstring. Runs on
    ``device`` ("cuda" by default, which raises on a machine without a
    card); ``device="cpu"`` runs every kernel's plain version.
    """

    def __init__(self, cfg: ModelConfig, params: dict, max_seq: int, slots: int = 4,
                 paged: bool = False,
                 block_size: int = 32, num_blocks: int | None = None,
                 device="cuda", *, ctx: DecodeCtx | None = None,
                 prefix_sharing: bool = False,
                 prefix_cache: bool = False, fused_decode: bool | None = None,
                 kv_pool_dtype: str | None = None,
                 host_spill: bool = False, demote_after: int = 4,
                 spill_keep_recent: int = 2, promote_headroom: int = 1,
                 prefill_chunk: int | None = None, preempt: bool = False,
                 greedy: bool = True, seed: int = 0, max_queue: int | None = None,
                 faults: FaultPlan | None = None, audit_every: int | None = None,
                 spill_max_retries: int = 3, spill_backoff_base: int = 1,
                 spill_backoff_cap: int = 8, monitor: StepMonitor | None = None,
                 heartbeat_path: str | None = None):
        if cfg.encdec:
            raise ValueError(f"{cfg.name}: the enc-dec family is not served by this engine: "
                             "its requests carry tokens and no frames, and the enc-dec "
                             "prefill needs the encoder's frames; serve it through its "
                             "model API (models.get_model: prefill(frames=), init_state, "
                             "write_into_slot, decode_step, reset_slot)")
        self.device = resolve_device(device)
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if audit_every is not None and audit_every < 1:
            raise ValueError(f"audit_every must be >= 1, got {audit_every}")
        if spill_max_retries < 0 or spill_backoff_base < 1 \
                or spill_backoff_cap < spill_backoff_base:
            raise ValueError("need spill_max_retries >= 0 and "
                             "1 <= spill_backoff_base <= spill_backoff_cap")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, got {prefill_chunk}")
        # the reference's ValueErrors for knobs that need the paged pool
        if kv_pool_dtype is not None and kv_pool_dtype != cfg.kv_pool_dtype:
            if not paged:
                raise ValueError("kv_pool_dtype override requires paged=True "
                                 "(the knob names the paged pool's storage)")
            cfg = dataclasses.replace(cfg, kv_pool_dtype=kv_pool_dtype)
        if not paged:
            for knob, on, why in (
                    ("prefix_sharing", prefix_sharing, ""),
                    ("host_spill", host_spill, " (the host tier holds physical pool blocks)"),
                    ("preempt", preempt, " (preemption frees pool blocks; dense slots have "
                                         "nothing to free)"),
                    ("prefill_chunk", prefill_chunk is not None,
                     " (chunks stream into a partially-filled paged slot)")):
                if on:
                    raise ValueError(f"{knob} requires paged=True{why}")
        if prefix_cache and not prefix_sharing:
            raise ValueError("prefix_cache requires prefix_sharing=True (the cache retains "
                             "radix-mapped blocks past their last resident owner)")
        if prefix_cache and cfg.kv_pool_dtype == "int4":
            raise ValueError("prefix_cache does not support int4 pools: the in-place append "
                             "requantizes a whole partial block, so retained prefix bytes "
                             "would diverge from a cold prefill")
        self.cfg, self.params, self.max_seq, self.slots = cfg, params, max_seq, slots
        self.paged = paged
        self.api = get_model(cfg)
        if prefill_chunk is not None:
            if host_spill:
                raise ValueError("prefill_chunk cannot combine with host_spill's wave "
                                 "admission (one pressure valve per engine; use preempt "
                                 "instead)")
            reason = self.api.prefill_chunk_unsupported()
            if reason is not None:
                raise ValueError(f"chunked prefill unsupported: {reason}")
            if cfg.kv_pool_dtype == "int4":
                raise ValueError("chunked prefill does not support int4 pools "
                                 "(per-block requantization is not chunk-incremental)")
        self.prefill_chunk, self.preempt = prefill_chunk, preempt
        self._inflight: _InflightPrefill | None = None
        self._static_heavy_cache: bytes | None = None
        self.stats = ServeStats()
        self.greedy = greedy
        self._rng = np.random.default_rng(seed)
        # the failure model: the queue bound, the fault plan, the audit
        self.max_queue = max_queue
        self._faults = faults
        self.audit_every = audit_every
        self.last_audit = None          # the latest InvariantReport
        self._audited_tick = -1         # each tick index is audited once
        self.spill_max_retries = spill_max_retries
        self.spill_backoff_base = spill_backoff_base
        self.spill_backoff_cap = spill_backoff_cap
        # patience 1: a non-finite logits row cannot give a token
        self._nan_guard = NaNGuard(patience=1)
        self.monitor = monitor
        if monitor is None and heartbeat_path is not None:
            self.monitor = StepMonitor(heartbeat_path=heartbeat_path)
        elif monitor is not None and heartbeat_path is not None \
                and monitor.heartbeat_path is None:
            monitor.heartbeat_path = heartbeat_path
        # slots whose growth a fault denied: masked off for one tick, re-armed
        # after it; the slots the last tick decoded (the audit compares only
        # their cursors with the device lengths)
        self._stalled: set[int] = set()
        self._last_decoded: set[int] = set()
        # host-tier transfer retries by (slot, logical): failures in a row,
        # the tick a retry is due, and the blocks pinned after the retries
        # ran out (cold: stays spilled and unselectable; hot: stays resident)
        self._xfer_attempts: dict[tuple[int, int], int] = {}
        self._xfer_retry_at: dict[tuple[int, int], int] = {}
        self._pinned_cold: set[tuple[int, int]] = set()
        self._pinned_hot: set[tuple[int, int]] = set()
        self._queue: deque[Request] = deque()
        self._active: dict[int, Request] = {}
        self._free = sorted(range(slots), reverse=True)          # pop() → lowest
        self._tokens = np.zeros((slots,), np.int32)
        self._mask = np.zeros((slots,), bool)
        self.ctx = ctx
        # pool shards: a contiguous cache split by rows has none to count
        self.n_shards = 1 if ctx is None or not paged else ctx.world_size
        # ``fused_decode`` pins the paged tick's data path for this engine
        # (None: the global flags decide), around every tick — the first
        # eager one and the capture, so every replay too. As in the
        # reference it steers ``sharded_fused_decode`` on a pool sharded
        # over more than one rank and ``paged_fused_decode`` otherwise: at
        # one rank the block-sharded island follows the global flag.
        self.fused_decode = fused_decode
        decode_step = self.api.decode_step
        if fused_decode is not None:
            flag = ("sharded_fused_decode" if paged and self.n_shards > 1
                    else "paged_fused_decode")

            def decode_step(*a, _real=self.api.decode_step, **kw):
                with perf_flags(**{flag: fused_decode}):
                    return _real(*a, **kw)
        self.host_spill = host_spill
        self.prefix_sharing = prefix_sharing
        self.prefix_cache = prefix_cache
        # the zero-prefill warm hit: sound exactly where chunked prefill is
        # (all-"A" stacks whose kept rows carry the static heavy sets); other
        # configs still hit the cache, but re-prefill and map the matched
        # blocks by reference
        self._adopt = (self.api.adopt_pages if prefix_cache and cfg.salca_static_channels
                       and self.api.prefill_chunk_unsupported() is None else None)
        # at most one request's prefill (the queue head's) waits for blocks
        self._stash: tuple[Request, tuple] | None = None
        if not paged:
            self._state = self.api.init_state(slots, max_seq, self.device, ctx)
            self._step = ServeDecodeStep(decode_step, params, self._state, slots,
                                         self.device, ctx)
            return
        if max_seq % block_size:
            raise ValueError(f"block_size {block_size} must divide max_seq {max_seq}")
        self.block_size = block_size
        self.max_blocks = max_seq // block_size
        self.num_blocks = num_blocks or slots * self.max_blocks
        self.stats.block_pool_size = self.num_blocks
        self.stats.block_size = block_size
        self.stats.shards = self.n_shards
        self._alloc = ShardedBlockAllocator(self.num_blocks, self.n_shards)
        self._slot_blocks: dict[int, list[int]] = {}
        self._slot_pos: dict[int, int] = {}                      # next write position
        self._refcount = np.zeros((self.num_blocks,), np.int64)  # host mirror
        # radix map: digest of a prompt prefix → (the block holding it, its
        # owner's heavy-set bytes); and each published block's key
        self._prefix_nodes: dict[bytes, tuple[int, bytes]] = {}
        self._block_keys: dict[int, bytes] = {}
        # the persistent prefix cache: pinned block → its LRU stamp (the
        # clock ticks once per release), each published block's logical
        # depth (eviction takes the deepest of a stamp first), the
        # first-token logits row per full-prompt key (what lets a full hit
        # skip the prefill), and the host cold tier: key → (payload, heavy
        # bytes, depth, stamp), its radix node holding CACHE_COLD
        self._cached: dict[int, int] = {}
        self._cache_clock = 0
        self._node_depth: dict[int, int] = {}
        self._logits_cache: dict[bytes, np.ndarray] = {}
        self._cold_cache: dict[bytes, tuple] = {}
        self._state = self.api.init_paged_state(slots, max_seq, block_size,
                                                self.num_blocks, self.device, ctx)
        self._step = ServeDecodeStep(decode_step, params, self._state, slots,
                                     self.device, ctx)
        if host_spill:
            if self.n_shards > 1:
                raise ValueError("host_spill is not supported on a block-sharded pool: the "
                                 "sharded decode island does not record selection "
                                 "histograms")
            if demote_after < 1 or spill_keep_recent < 1:
                raise ValueError("demote_after and spill_keep_recent must be >= 1 (the "
                                 "cursor block must stay hot)")
            self.demote_after = demote_after
            self.spill_keep_recent = spill_keep_recent
            self.promote_headroom = promote_headroom
            self._sel_hist_fn = self.api.selection_hist
            self._spilled: dict[tuple[int, int], tuple] = {}   # (slot, logical) → payload
            self._spill_score: dict[tuple[int, int], float] = {}
            self._hist_snap = np.zeros((slots, self.max_blocks), np.int64)
            self._cold_streak = np.zeros((slots, self.max_blocks), np.int32)
            # one logical block's data rows across every layer: the transfer unit
            self._block_bytes = sum(t.numel() * t.element_size()
                                    for rows in self.api.read_block(self._state, 0)
                                    for t in rows)
            self.stats.host_spill = True

    @property
    def _free_blocks(self) -> list[int]:
        """Flat snapshot of the free block ids (all shards)."""
        return self._alloc.free_ids()

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Enqueue a request. Returns False when the bounded queue sheds it
        (``stop_reason="rejected"``): under overload the queue wait, and so
        every admitted request's TTFT, stays bounded. A malformed request
        raises."""
        if len(req.prompt) + req.max_new_tokens > self.max_seq:
            raise ValueError(f"request {req.rid}: prompt({len(req.prompt)}) + "
                             f"max_new_tokens({req.max_new_tokens}) exceeds "
                             f"max_seq={self.max_seq}")
        lifetime = len(req.prompt) + max(req.max_new_tokens - 1, 0)
        # with the host tier a context larger than the device pool is the
        # case spilling exists for: admitted in waves
        if self.paged and not self.host_spill and self._blocks_for(lifetime) > self.num_blocks:
            raise ValueError(f"request {req.rid}: needs {self._blocks_for(lifetime)} "
                             f"blocks over its lifetime but the pool has {self.num_blocks}")
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            req.done_time = time.time()
            req.stop_reason = "rejected"
            self.stats.rejections += 1
            return False
        self._queue.append(req)
        return True

    def cancel(self, rid: int) -> bool:
        """End a request by id wherever it is: queued (removed), in its
        chunked prefill (its slot, charged blocks and cursor released) or
        resident (finished through the release path). False when no live
        request has that id."""
        now = time.time()
        for req in self._queue:
            if req.rid == rid:
                self._queue.remove(req)
                self._terminate_queued(req, now, "cancelled")
                self.stats.cancellations += 1
                return True
        if self._inflight is not None and self._inflight.req.rid == rid:
            self._abort_inflight(now, "cancelled")
            self.stats.cancellations += 1
            return True
        for slot, req in list(self._active.items()):
            if req.rid == rid:
                self._finish(slot, req, now, "cancelled")
                self.stats.cancellations += 1
                return True
        return False

    # -- deadlines and ends in the queue -------------------------------
    @staticmethod
    def _expired(req: Request, now: float) -> bool:
        return req.deadline_ms is not None and (now - req.submitted) * 1e3 >= req.deadline_ms

    def _terminate_queued(self, req: Request, now: float, reason: str) -> None:
        """End a request that is still queued. If its admission cycle began
        (the prefix-sharing gate's prefill starts work on the queue head
        before its blocks are there), the cycle closes in `completed`, so
        ``admissions == completed + preemptions`` holds at drain."""
        req.done_time = now
        req.stop_reason = reason
        self._drop_stash(req)
        if req._cycle_started:
            self.stats.completed += 1

    def _abort_inflight(self, now: float, reason: str) -> None:
        """Tear down the in-flight chunked prefill: its reserved slot, the
        blocks its chunks charged and its cursor are released (the slot's
        reset is in place); its admission cycle closes in `completed`."""
        inf = self._inflight
        self._inflight = None           # drops the cursor's buffers
        req = inf.req
        req.done_time = now
        req.stop_reason = reason
        self.stats.completed += 1
        self._free.append(inf.slot)
        self._free.sort(reverse=True)
        self._release_blocks(inf.slot)
        self.api.reset_slot(self._state, inf.slot)

    def _shed_expired_queue(self) -> None:
        """Drop queued requests whose deadline passed: a prefill for a
        request nobody waits for only delays the live ones behind it."""
        if not any(r.deadline_ms is not None for r in self._queue):
            return
        now = time.time()
        keep: deque[Request] = deque()
        while self._queue:
            req = self._queue.popleft()
            if self._expired(req, now):
                self._terminate_queued(req, now, "deadline")
                self.stats.deadline_stops += 1
            else:
                keep.append(req)
        self._queue = keep

    # -- fault injection -------------------------------------------------
    def _fault(self, site: str, **ctx) -> bool:
        """Consult the engine's `FaultPlan` at one injection site."""
        if self._faults is not None and self._faults.fires(site, **ctx):
            self.stats.faults_injected += 1
            return True
        return False

    def _alloc_blocks(self, need: int, prefer: int | None = None) -> list[int] | None:
        """The allocator behind the ``alloc_exhausted`` site: a fired fault
        makes this call report an empty pool, and the caller takes the path
        a dry pool takes (admission waits, a chunk stalls, growth stalls the
        slot)."""
        if need > 0 and self._fault("alloc_exhausted", need=need):
            return None
        return self._alloc.alloc(need, prefer)

    def _stall(self, slot: int) -> None:
        """Pause one active slot for this tick: masked off, so the tick
        neither reads nor writes it and its cursor holds; its tokens go on,
        bit for bit, once the fault clears."""
        self._mask[slot] = False
        self._stalled.add(slot)

    def _xfer_failed(self, key: tuple[int, int], pin: str) -> None:
        """One failed host-tier transfer: back off base·2^(n-1) ticks
        (capped); once the retries ran out, pin the block where it is —
        ``cold`` (stays spilled and unselectable) or ``hot`` (stays
        resident)."""
        self.stats.retries += 1
        n = self._xfer_attempts.get(key, 0) + 1
        self._xfer_attempts[key] = n
        if n > self.spill_max_retries:
            (self._pinned_cold if pin == "cold" else self._pinned_hot).add(key)
            self._xfer_retry_at.pop(key, None)
        else:
            self._xfer_retry_at[key] = self.stats.ticks + min(
                self.spill_backoff_base * 2 ** (n - 1), self.spill_backoff_cap)

    def _xfer_ok(self, key: tuple[int, int]) -> None:
        self._xfer_attempts.pop(key, None)
        self._xfer_retry_at.pop(key, None)

    def _xfer_blocked(self, key: tuple[int, int]) -> bool:
        """True while a key backs off (its retry is not due yet)."""
        return self._xfer_retry_at.get(key, -1) > self.stats.ticks

    def _blocks_for(self, tokens: int) -> int:
        return max(1, -(-tokens // self.block_size))

    def _note_block_usage(self) -> None:
        used = self.num_blocks - self._alloc.total_free
        self.stats.blocks_in_use = used
        self.stats.peak_blocks_in_use = max(self.stats.peak_blocks_in_use, used)
        if self.host_spill:
            self.stats.hot_blocks = used
            self.stats.cold_blocks = len(self._spilled)
            self.stats.peak_cold_blocks = max(self.stats.peak_cold_blocks, len(self._spilled))
        if self.n_shards > 1:
            hot = max(self._alloc.blocks_per_shard - f for f in self._alloc.free_counts())
            self.stats.peak_shard_blocks_in_use = max(self.stats.peak_shard_blocks_in_use,
                                                      hot)

    # -- tiered KV memory: host spill of cold blocks -------------------
    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """A host copy of device rows, enqueued on the current stream (pinned
        memory on a card, so the copy is asynchronous)."""
        if t.device.type == "cpu":
            return t.clone()
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return h.copy_(t, non_blocking=True)

    def demote_block(self, slot: int, logical: int, _inject: bool = True) -> bool:
        """Move one mapped private block device → host: copy its rows in
        storage format to pinned host memory, unmap the page-table entry
        (the block becomes unselectable) and free the physical block. False
        when the transfer fails (the ``spill_transfer`` site): the block
        stays resident and intact, and its key backs off and in the end
        pins hot. ``_inject=False`` skips the site (wave admission's
        demotions, one transaction with the install)."""
        held = self._slot_blocks[slot]
        blk = held[logical]
        assert blk >= 0 and self._refcount[blk] == 1, \
            f"demote needs a mapped private block, got ({slot}, {logical}) -> {blk}"
        if _inject and self._fault("spill_transfer", direction="demote", slot=slot,
                                   logical=logical):
            self._xfer_failed((slot, logical), pin="hot")
            return False
        self._xfer_ok((slot, logical))
        self._spilled[(slot, logical)] = tuple(
            tuple(self._to_host(t) for t in rows)
            for rows in self.api.read_block(self._state, blk))
        # resurrect priority: the block's cumulative selection count
        self._spill_score[(slot, logical)] = float(self._hist_snap[slot, logical])
        self.api.map_block(self._state, slot, logical, SPILLED)
        self._refcount[blk] -= 1
        self._alloc.release(blk)
        held[logical] = SPILLED
        self.stats.demotions += 1
        self.stats.pcie_bytes += self._block_bytes
        self._note_block_usage()
        return True

    def promote_block(self, slot: int, logical: int) -> bool:
        """Move one spilled block host → device into a fresh physical block
        and remap it (bit-exact: storage format both ways). False when no
        block is free or the transfer fails (the ``spill_transfer`` site):
        the key backs off and, its retries run out, pins cold — the payload
        stays on the host and the block unselectable."""
        payload = self._spilled[(slot, logical)]
        if self._fault("spill_transfer", direction="promote", slot=slot, logical=logical):
            self._xfer_failed((slot, logical), pin="cold")
            return False
        fresh = self._alloc_blocks(1)
        if fresh is None:
            return False
        self._xfer_ok((slot, logical))
        blk, = fresh
        self.api.write_block(self._state, blk, payload)
        self.api.map_block(self._state, slot, logical, blk)
        self._refcount[blk] += 1
        self._slot_blocks[slot][logical] = blk
        del self._spilled[(slot, logical)]
        self._spill_score.pop((slot, logical), None)
        self._cold_streak[slot, logical] = 0
        self.stats.promotions += 1
        self.stats.pcie_bytes += self._block_bytes
        self._note_block_usage()
        return True

    def _update_cold_streaks(self) -> None:
        """Diff the layers' selection histograms (one device sync) against
        the last snapshot: a (slot, block) whose count did not move went one
        more tick unselected."""
        hist = self._sel_hist_fn(self._state).cpu().numpy().astype(np.int64)
        touched = (hist - self._hist_snap) > 0
        self._hist_snap = hist
        self._cold_streak[touched] = 0
        self._cold_streak[~touched] += 1

    def _demote_candidates(self) -> list[tuple[int, int, int]]:
        """Eligible demotions, coldest first: (-streak, slot, logical) for
        every mapped private, unpublished block outside its slot's
        `spill_keep_recent` trailing blocks (the cursor block among them)."""
        out = []
        for slot in self._active:
            held = self._slot_blocks[slot]
            n_blocks = self._blocks_for(max(self._slot_pos[slot], 1))
            for j in range(min(max(n_blocks - self.spill_keep_recent, 0), len(held))):
                b = held[j]
                # a shared or radix-published block must stay on the device;
                # so must one pinned hot or backing off
                if b != SPILLED and self._refcount[b] == 1 and b not in self._block_keys \
                        and (slot, j) not in self._pinned_hot \
                        and not self._xfer_blocked((slot, j)):
                    out.append((-int(self._cold_streak[slot, j]), slot, j))
        out.sort()
        return out

    def _spill_policy(self) -> None:
        """Post-tick demotion pass: every candidate no layer selected for
        `demote_after` consecutive ticks moves to the host tier."""
        if not (self.host_spill and self._active):
            return
        self._update_cold_streaks()
        for neg_streak, slot, j in self._demote_candidates():
            if -neg_streak >= self.demote_after:
                self.demote_block(slot, j)

    def _promote_resurrected(self) -> None:
        """Pre-tick promotion pass: while more than `promote_headroom` blocks
        are free, bring back each active slot's spilled block with the
        highest score — at most one per slot per tick; a block pinned cold
        or backing off waits."""
        if not (self.host_spill and self._spilled):
            return
        best: dict[int, tuple[float, int]] = {}
        for (slot, j), score in self._spill_score.items():
            if slot in self._active and (slot, j) not in self._pinned_cold \
                    and not self._xfer_blocked((slot, j)):
                cur = best.get(slot)
                if cur is None or (score, -j) > (cur[0], -cur[1]):
                    best[slot] = (score, j)
        for slot in sorted(best):
            if self._alloc.total_free <= self.promote_headroom:
                break
            self.promote_block(slot, best[slot][1])

    def _demote_for(self, need: int) -> None:
        """Pressure relief: demote the coldest candidates until ``need``
        blocks are free or none is left."""
        for _ in range(need - self._alloc.total_free):
            cand = self._demote_candidates()
            if not cand:
                break
            self.demote_block(cand[0][1], cand[0][2])

    def _prefill(self, req: Request):
        t0 = time.time()
        tokens = torch.from_numpy(np.asarray(req.prompt, np.int32)[None]).to(self.device)
        logits, state1 = self.api.prefill(self.params, tokens, self.max_seq)
        logits_row = logits[0].float().cpu().numpy()         # waits for the device
        self.stats.prefill_s += time.time() - t0
        self.stats.prefill_tokens += len(req.prompt)
        return logits_row, state1

    def _ensure_prefill(self, req: Request):
        """Prefill once per request: the result is stashed so that a queue
        head waiting for blocks after the heavy-set gate does not pay it
        twice. The stash holds one request's batch=1 state at most; another
        request taking the head (a preemption's requeue) replaces it."""
        if self._stash is None or self._stash[0] is not req:
            self._stash = (req, self._prefill(req))
        return self._stash[1]

    def _drop_stash(self, req: Request) -> None:
        """Free the prefill stash if it holds ``req``'s state."""
        if self._stash is not None and self._stash[0] is req:
            self._stash = None

    def _begin_cycle(self, req: Request, t0: float) -> None:
        """Open one admission cycle: close the queue wait that began at the
        submission (first cycle) or at the preemption's requeue (later
        ones). ``submitted`` and ``admitted`` are never reset, so TTFT
        counts from the submission; the wait adds up over cycles. Once per
        cycle: the gate's prefill may start work on an attempt that then
        waits for blocks."""
        if req._cycle_started:
            return
        req._cycle_started = True
        wait = max(t0 - (req.submitted if req._requeued_at is None else req._requeued_at), 0.0)
        req._queue_wait += wait
        self.stats.queue_wait_s += wait
        self.stats.admissions += 1
        if req.admitted is None:
            req.admitted = t0

    # -- prefix sharing ------------------------------------------------
    def _request_digests(self, req: Request):
        """Cumulative SHA-1 digests of the prompt's token-id bytes: one per
        full block, and one of the whole prompt when it ends in a partial
        block (digest j = sha1(prompt[:(j+1)·BS])). Kept on the request."""
        if req._digests is None:
            bs, prompt = self.block_size, req.prompt
            buf = np.ascontiguousarray(prompt, np.int32).tobytes()
            h = hashlib.sha1()
            full_keys = []
            for j in range(len(prompt) // bs):
                h.update(buf[j * bs * 4:(j + 1) * bs * 4])
                full_keys.append(h.copy().digest())
            partial_key = None
            if len(prompt) % bs:
                h.update(buf[len(full_keys) * bs * 4:])
                partial_key = h.digest()
            req._digests = (full_keys, partial_key)
        return req._digests

    @staticmethod
    def _heavy_bytes(state1) -> bytes:
        """Every attention layer's heavy-channel indices of a batch=1
        prefill, as bytes (empty for a model with none): the identity that
        two requests must share to alias feature rows."""
        return b"".join(c.heavy_idx.cpu().numpy().tobytes() for c in state1.caches
                        if isinstance(c, SalcaCache))

    def _match_tokens(self, req: Request) -> list[tuple[bytes, int, bytes]]:
        """Longest radix match on the token ids alone: full blocks first,
        then, when every one matched, the whole prompt's partial block.
        [(key, block, owner's heavy bytes), ...]."""
        full_keys, partial_key = self._request_digests(req)
        out = []
        for key in full_keys:
            node = self._prefix_nodes.get(key)
            if node is None:
                return out
            out.append((key,) + node)
        if partial_key is not None and partial_key in self._prefix_nodes:
            out.append((partial_key,) + self._prefix_nodes[partial_key])
        return out

    def _register_blocks(self, req: Request, blocks: list[int], n_shared: int,
                         heavy: bytes, logits_row: np.ndarray | None = None) -> None:
        """Publish the request's private prompt blocks in the radix map (its
        shared ones are published already), each with its logical depth.
        With the persistent cache the first-token logits row is kept under
        the full-prompt key, so the same prompt later admits with no prefill
        (`_try_adopt`): the row is a function of the prompt alone."""
        full_keys, partial_key = self._request_digests(req)
        keys = full_keys + ([partial_key] if partial_key is not None else [])
        for j in range(n_shared, len(keys)):
            if keys[j] not in self._prefix_nodes and blocks[j] not in self._block_keys:
                self._prefix_nodes[keys[j]] = (blocks[j], heavy)
                self._block_keys[blocks[j]] = keys[j]
                self._node_depth[blocks[j]] = j
        if self.prefix_cache and logits_row is not None and keys[-1] in self._prefix_nodes:
            self._logits_cache[keys[-1]] = np.array(logits_row, copy=True)

    def _prune_node(self, block: int) -> None:
        """Drop a block's radix entry with what hangs on its key: the logits
        row, the depth and any cold payload."""
        key = self._block_keys.pop(block, None)
        if key is not None:
            self._prefix_nodes.pop(key, None)
            self._logits_cache.pop(key, None)
            self._cold_cache.pop(key, None)
        self._node_depth.pop(block, None)

    def _admit(self) -> None:
        """FIFO admission: prefill the queue head alone and write it into the
        lowest free slot (paged: into the blocks its matched prefix shares
        and freshly allocated ones, waiting head-of-line when the pool is
        short; with ``host_spill`` cold blocks are demoted first and a
        prompt larger than the free pool admits in waves, unshared). With
        ``prefill_chunk`` one pass runs one chunk instead
        (`_advance_prefill`). Queued requests past their deadline are shed
        first. With the persistent cache a prompt matched in full admits with
        no prefill (`_try_adopt`), cold matches are rehydrated, and the
        cache's cold end is reclaimed before any demotion or wait."""
        self._shed_expired_queue()
        if self.prefill_chunk is not None:
            self._advance_prefill()
            return
        while self._queue and self._free:
            req = self._queue[0]
            t0 = time.time()
            if not self.paged:
                self._queue.popleft()
                slot = self._free.pop()
                self._begin_cycle(req, t0)
                logits_row, state1 = self._ensure_prefill(req)
                self.api.write_into_slot(self._state, state1, slot, None, self.ctx)
                self._drop_stash(req)
                self._activate(req, slot, logits_row)
                continue
            need_full = self._blocks_for(len(req.prompt))
            shared: list[int] = []
            if self.prefix_sharing:
                cand = self._match_tokens(req)
                # what pressure could reclaim counts: every pin outside the
                # match, less one block to rehydrate per cold match
                cand_blocks = {b for _, b, _ in cand if b >= 0}
                n_cold = sum(b == CACHE_COLD for _, b, _ in cand)
                reclaim = sum(b not in cand_blocks for b in self._cached)
                if need_full - len(cand) + n_cold > self._alloc.total_free + reclaim:
                    break          # short of blocks even if every match is shared
                if self._try_adopt(req, cand, t0):
                    continue       # a zero-prefill warm hit
                self._begin_cycle(req, t0)
                _, state1 = self._ensure_prefill(req)
                if req._heavy is None:
                    req._heavy = self._heavy_bytes(state1)
                hot = set(cand_blocks)
                for key, block, owner_heavy in cand:
                    if owner_heavy != req._heavy:
                        break      # the first heavy-set mismatch ends the share
                    if block == CACHE_COLD:
                        # rehydrate (other pins may make room; the match's own
                        # blocks are protected)
                        block = self._promote_cached(key, protect=hot)
                        if block is None:
                            break  # too tight to rehydrate: the rest is prefilled
                        hot.add(block)
                    shared.append(block)
            need = need_full - len(shared)
            if need > self._alloc.total_free:
                # the cheapest reclaim first: the cache's LRU end, never the
                # admission's own hit
                self._reclaim_cache(need, protect=set(shared))
            if self.host_spill and need > self._alloc.total_free:
                # admission pressure: cold blocks of active slots go to the
                # host tier before the queue waits on the device pool
                self._demote_for(need)
            fresh = None
            if self.host_spill and need > self._alloc.total_free:
                if not self._alloc.total_free:
                    break      # head-of-line wait (the host tier needs one free block)
                shared = []    # wave admission writes the whole prompt privately
            else:
                fresh = self._alloc_blocks(need)
                if fresh is None:
                    break      # head-of-line wait
            self._queue.popleft()
            slot = self._free.pop()
            self._begin_cycle(req, t0)
            logits_row, state1 = self._ensure_prefill(req)
            self._slot_pos[slot] = len(req.prompt)
            if self.host_spill:
                self._hist_snap[slot] = 0
                self._cold_streak[slot] = 0
            n_cache = self._take_pins(shared)
            self._install_prompt(slot, shared, need_full, state1, fresh)
            if self.prefix_sharing:
                self._count_shared(req, len(shared), n_cache)
                if fresh is not None:  # a prompt admitted in waves is not published
                    self._register_blocks(req, self._slot_blocks[slot], len(shared),
                                          req._heavy, logits_row)
            self._drop_stash(req)
            self._activate(req, slot, logits_row)

    def _install_prompt(self, slot: int, shared: list[int], need: int, state1,
                        fresh: list[int] | None) -> None:
        """Write a prefilled prompt of ``need`` blocks into ``slot``: the
        ``shared`` prefix blocks are mapped by reference, the rest written
        into the ``fresh`` blocks the admission allocated (least-loaded
        shards first) in one write; with ``fresh=None`` (host_spill) into
        blocks allocated in free-pool-sized waves, each demoted to the host
        before the next lands, the last — the recency tail with the cursor
        block — staying hot. A write drops the rows of the blocks outside
        its wave (their pages are -1)."""
        n_shared = len(shared)
        held = shared + [SPILLED] * (need - n_shared)
        self._slot_blocks[slot] = held
        for b in shared:
            self._refcount[b] += 1
        lo = n_shared
        while True:
            ids = fresh if fresh is not None else self._alloc.alloc(
                min(self._alloc.total_free, need - lo))
            w = len(ids)
            held[lo:lo + w] = ids
            for b in held[lo:lo + w]:
                self._refcount[b] += 1
            self._note_block_usage()
            pages = np.full((self.max_blocks,), -1, np.int32)
            pages[:lo + w] = held[:lo + w]            # earlier waves: spilled, -1
            self.api.write_into_pages(self._state, state1, slot, pages, self.ctx, n_shared)
            lo += w
            if lo == need:
                return
            for j in range(lo - w, lo):
                self.demote_block(slot, j, _inject=False)

    def _sample(self, req: Request, logits_row: np.ndarray) -> int:
        """The request's token from a (V_pad,) logits row: the argmax, or
        with ``greedy=False`` and a temperature > 0 the argmax of the row
        over the temperature in float64 plus one Gumbel draw per column
        from the engine's generator (the reference's draws, in its order)."""
        temp = 0.0 if self.greedy else req.temperature
        if temp <= 0.0:
            return int(np.argmax(logits_row))
        z = logits_row.astype(np.float64) / temp
        return int(np.argmax(z + self._rng.gumbel(size=z.shape)))

    def _next_token(self, req: Request, logits_row: np.ndarray | None,
                    greedy_tok: int | None = None) -> int:
        """The request's next token: inside its preemption replay window the
        recorded one (force-fed, never sampled again, so the continuation is
        exact under temperature too; not counted as generated, no new
        timestamp); otherwise a sample of ``logits_row``, or the tick's
        greedy ``greedy_tok`` when no row is given."""
        idx = len(req.output)
        if req._replay is not None and idx < len(req._replay):
            tok = int(req._replay[idx])
            self.stats.replayed_tokens += 1
        else:
            req._replay = None
            tok = int(greedy_tok) if logits_row is None else self._sample(req, logits_row)
            self.stats.tokens_generated += 1
            req.token_times.append(time.time())
        req.output.append(tok)
        return tok

    def _activate(self, req: Request, slot: int, logits_row: np.ndarray) -> None:
        """Make a prefilled request live (monolithic admission or the final
        chunk): its first (or replayed) token, the slot masked on, the stop
        rules. TTFT is stamped on the first activation only."""
        tok = self._next_token(req, logits_row)
        if req.first_token_time is None:
            req.first_token_time = time.time()
            self.stats.ttft_s += req.ttft_s
            self.stats.ttft_count += 1
        self._active[slot] = req
        self._tokens[slot] = tok
        self._mask[slot] = True
        self.stats.peak_active_slots = max(self.stats.peak_active_slots,
                                           int(self._mask.sum()))
        if req.stop_token is not None and tok == req.stop_token:
            self._finish(slot, req, time.time(), "stop")
        elif req.max_new_tokens <= 1:
            self._finish(slot, req, time.time(), "length")

    def _finish(self, slot: int, req: Request, now: float, reason: str) -> None:
        if self._active.get(slot) is not req:
            return                      # finished already (racing finishers)
        req.done_time = now
        req.stop_reason = reason
        self.stats.completed += 1
        del self._active[slot]
        self._mask[slot] = False
        self._stalled.discard(slot)
        self._nan_guard.reset_slot(slot)
        self._free.append(slot)
        self._free.sort(reverse=True)
        if self.paged:
            self._release_blocks(slot)
        self.api.reset_slot(self._state, slot)

    def _release_blocks(self, slot: int) -> None:
        """Decref every block the slot holds; a block reaching 0 returns to
        its shard's free list and leaves the radix map — unless the
        persistent cache is on and the block is radix-published: then it
        stays mapped under a cache pin, one LRU stamp for the whole release.
        Releasing a slot that holds nothing (an overflow finish racing a
        preemption) is a no-op."""
        blocks = self._slot_blocks.pop(slot, None)
        if blocks is None:
            return
        stamp = None
        for b in blocks:
            if b == SPILLED:
                continue                              # host-tier entry: no device block
            self._refcount[b] -= 1
            assert self._refcount[b] >= 0, f"block {b} refcount underflow"
            if self._refcount[b] == 0:
                if self.prefix_cache and b in self._block_keys:
                    if stamp is None:
                        self._cache_clock += 1
                        stamp = self._cache_clock
                    self._cached[b] = stamp
                    self._note_cache_usage()
                else:
                    self._alloc.release(b)
                    self._prune_node(b)
        self._slot_pos.pop(slot, None)
        if self.host_spill:
            for key in [k for k in self._spilled if k[0] == slot]:
                del self._spilled[key]
                self._spill_score.pop(key, None)
            self._hist_snap[slot] = 0
            self._cold_streak[slot] = 0
            # transfer retries and pins belong to one occupancy
            for d in (self._xfer_attempts, self._xfer_retry_at):
                for key in [k for k in d if k[0] == slot]:
                    del d[key]
            self._pinned_cold = {k for k in self._pinned_cold if k[0] != slot}
            self._pinned_hot = {k for k in self._pinned_hot if k[0] != slot}
        self._note_block_usage()

    # -- the persistent prefix cache ------------------------------------
    def _note_cache_usage(self) -> None:
        n = len(self._cached)
        self.stats.cache_pinned_blocks = n
        self.stats.peak_cache_blocks = max(self.stats.peak_cache_blocks, n)

    def _take_pins(self, blocks: list[int]) -> int:
        """Pop the cache pins among ``blocks`` an admission maps (each goes
        back to resident); returns how many it popped."""
        n = sum(self._cached.pop(b, None) is not None for b in blocks)
        self._note_cache_usage()
        return n

    def _count_shared(self, req: Request, n_shared: int, n_cache: int) -> None:
        """An admission's sharing counts: ``n_cache`` of its ``n_shared``
        mapped prefix blocks were cache pins, the rest resident."""
        req.shared_blocks = n_shared
        self.stats.shared_blocks += n_shared - n_cache
        self.stats.cache_hit_blocks += n_cache
        self.stats.prefix_hits += bool(n_shared - n_cache)
        self.stats.cache_hits += bool(n_cache)

    def _cache_victim(self, protect=frozenset()) -> int | None:
        """The LRU pin: the oldest stamp first and, on a tie, the deepest
        block. A block's owners own its ancestors too, so an ancestor's last
        release comes at or after its descendants': this order never takes
        an ancestor while a pinned descendant remains."""
        cand = [(stamp, -self._node_depth.get(b, 0), b)
                for b, stamp in self._cached.items() if b not in protect]
        return min(cand)[2] if cand else None

    def _evict_cache_block(self, protect=frozenset()) -> bool:
        """Reclaim one pin outright: drop its radix entry and return the id
        to its shard's list. The block is unmapped already (refcount 0), so
        this is bookkeeping only. False when no pin is left."""
        b = self._cache_victim(protect)
        if b is None:
            return False
        del self._cached[b]
        self._prune_node(b)
        self._alloc.release(b)
        self.stats.cache_evictions += 1
        self._note_cache_usage()
        self._note_block_usage()
        return True

    def _demote_cache_block(self, protect=frozenset()) -> bool:
        """Move one pin's rows to the host cold tier (with ``host_spill``):
        its radix key stays matchable under CACHE_COLD and is rehydrated on
        its next hit. The tier holds at most ``num_blocks`` entries; past
        that its LRU entry is dropped (an eviction)."""
        b = self._cache_victim(protect)
        if b is None:
            return False
        key = self._block_keys.pop(b)          # the physical id is about to be reused
        heavy = self._prefix_nodes[key][1]
        payload = tuple(tuple(self._to_host(t) for t in rows)
                        for rows in self.api.read_block(self._state, b))
        self._cold_cache[key] = (payload, heavy, self._node_depth.pop(b, 0), self._cached.pop(b))
        self._prefix_nodes[key] = (CACHE_COLD, heavy)
        self._alloc.release(b)
        self.stats.demotions += 1
        self.stats.pcie_bytes += self._block_bytes
        if len(self._cold_cache) > self.num_blocks:
            old = min(self._cold_cache,
                      key=lambda k: (self._cold_cache[k][3], -self._cold_cache[k][2]))
            self._prefix_nodes.pop(old, None)
            self._logits_cache.pop(old, None)
            del self._cold_cache[old]
            self.stats.cache_evictions += 1
        self._note_cache_usage()
        self._note_block_usage()
        return True

    def _promote_cached(self, key: bytes, protect=frozenset()) -> int | None:
        """Rehydrate one cold entry into a fresh block (a radix hit on a
        demoted prefix; bit-exact, storage format both ways), pinned again
        under its old stamp. A dry pool first reclaims other pins
        (``protect``: the blocks the match in progress maps). None when no
        block can be had, or the squeeze dropped this very entry: the
        caller cuts its match there and prefills the rest."""
        if key not in self._cold_cache:
            return None
        fresh = self._alloc.alloc(1)
        if fresh is None:
            self._reclaim_cache(1, protect=protect)
            if key not in self._cold_cache:
                return None
            fresh = self._alloc.alloc(1)
            if fresh is None:
                return None
        b, = fresh
        payload, heavy, depth, stamp = self._cold_cache.pop(key)
        self.api.write_block(self._state, b, payload)
        self._prefix_nodes[key] = (b, heavy)
        self._block_keys[b] = key
        self._node_depth[b] = depth
        self._cached[b] = stamp
        self.stats.promotions += 1
        self.stats.pcie_bytes += self._block_bytes
        self._note_cache_usage()
        self._note_block_usage()
        return b

    def _reclaim_cache(self, need: int, protect=frozenset()) -> None:
        """Drain the cache's LRU end until ``need`` blocks are free or no
        pin is left: with the host tier by demotion (the entry stays
        warm), else by eviction. A pin costs no resident request anything,
        so every pressure path calls this before host-tier demotion or
        preemption."""
        while self._alloc.total_free < need:
            if self.host_spill and self._demote_cache_block(protect):
                continue
            if not self._evict_cache_block(protect):
                return

    def flush_prefix_cache(self) -> int:
        """Drop every entry of the persistent cache, its pins and its cold
        payloads; returns how many. Resident requests and their radix
        entries stay."""
        if not self.paged:
            return 0
        n = 0
        while self._evict_cache_block():
            n += 1
        for key in list(self._cold_cache):
            self._prefix_nodes.pop(key, None)
            self._logits_cache.pop(key, None)
            del self._cold_cache[key]
            self.stats.cache_evictions += 1
            n += 1
        return n

    def _try_adopt(self, req: Request, cand: list, t0: float) -> bool:
        """The zero-prefill warm hit: when the radix match covers the whole
        prompt and its first-token logits row was kept, map the matched
        blocks by reference (`adopt_pages`: metadata only, no prefill) and
        activate the slot at once; the adoption's time counts in
        ``prefill_s``. False — the caller prefills and still maps the match
        by reference — when adoption is off for the config, the match is
        partial, the row is missing, a heavy set differs or a cold entry
        cannot be rehydrated (those rehydrated stay pinned for the
        prefill path)."""
        if self._adopt is None or len(cand) < self._blocks_for(len(req.prompt)):
            return False
        logits_row = self._logits_cache.get(cand[-1][0])
        if logits_row is None:
            return False
        heavy = self._static_heavy_bytes()
        if any(owner_heavy != heavy for _, _, owner_heavy in cand):
            return False
        blocks: list[int] = []
        hot = {b for _, b, _ in cand if b >= 0}
        for key, block, _ in cand:
            if block == CACHE_COLD:
                block = self._promote_cached(key, protect=hot)
                if block is None:
                    return False
                hot.add(block)
            blocks.append(block)
        self._queue.popleft()
        slot = self._free.pop()
        self._begin_cycle(req, t0)
        req._heavy = heavy
        n_cache = self._take_pins(blocks)
        for b in blocks:
            self._refcount[b] += 1
        plen = len(req.prompt)
        pages = np.full((self.max_blocks,), -1, np.int32)
        pages[:len(blocks)] = blocks
        self._slot_blocks[slot] = list(blocks)
        self._slot_pos[slot] = plen
        if self.host_spill:
            self._hist_snap[slot] = 0
            self._cold_streak[slot] = 0
        self._note_block_usage()
        t1 = time.time()
        self._adopt(self.params, self._state, slot, pages, plen)
        self.stats.prefill_s += time.time() - t1
        self._count_shared(req, len(blocks), n_cache)
        self.stats.zero_prefill_hits += 1
        self._drop_stash(req)
        self._activate(req, slot, logits_row)
        return True

    # -- preemption ----------------------------------------------------
    def _pick_victim(self) -> int | None:
        """The pool's lowest-priority occupant: the latest-submitted request
        (ties to the highest rid) among the active slots and the in-flight
        prefill — the newest arrival gives its blocks back first."""
        cands = [(req.submitted, req.rid, slot) for slot, req in self._active.items()]
        if self._inflight is not None:
            inf = self._inflight
            cands.append((inf.req.submitted, inf.req.rid, inf.slot))
        return max(cands)[2] if cands else None

    def _preempt_slot(self, slot: int) -> None:
        """Evict one occupant (an active slot or the in-flight prefill) and
        requeue its request at the queue head. The unmap takes the
        overflow finish's idempotent paths (`_release_blocks`, and
        ``reset_slot``'s `free_pages`), so a preemption racing a finish or
        another reset of the slot frees nothing twice. The recorded output
        becomes the replay window: the re-admission re-prefills the prompt
        and force-feeds the recorded tokens through ordinary ticks, which
        write the same KV again, so the output equals a never-preempted
        run's."""
        now = time.time()
        if self._inflight is not None and self._inflight.slot == slot:
            req = self._inflight.req
            self._inflight = None       # drops the cursor's buffers
        else:
            req = self._active.pop(slot)
        self._mask[slot] = False
        self._stalled.discard(slot)
        self._nan_guard.reset_slot(slot)
        self.stats.preemptions += 1
        req.preemptions += 1
        # keep the longest record: a request preempted again while replaying
        # must not cut its window to the part replayed so far
        if not (req._replay is not None and len(req._replay) >= len(req.output)):
            req._replay = list(req.output) or None
        req.output = []
        req.shared_blocks = 0
        req._requeued_at = now
        req._cycle_started = False
        self._drop_stash(req)
        self._free.append(slot)
        self._free.sort(reverse=True)
        self._release_blocks(slot)
        self.api.reset_slot(self._state, slot)
        self._queue.appendleft(req)

    def _preempt_for_blocks(self, needy_slot: int) -> bool:
        """Preempt victims until the free list holds a block (a victim's
        blocks may all be shared: go on). Cache pins go first, demoted with
        the host tier, else evicted: they are cheaper than any victim, and a
        victim whose released blocks land in the cache is reclaimed on the
        next pass instead of another victim. False once ``needy_slot``
        itself was preempted, or when no victim is left."""
        while not self._alloc.total_free:
            if self.host_spill and self._demote_cache_block():
                continue
            if self._evict_cache_block():
                continue
            victim = self._pick_victim()
            if victim is None:
                return False
            self._preempt_slot(victim)
            if victim == needy_slot:
                return False
        return True

    # -- chunked prefill -------------------------------------------------
    def _static_heavy_bytes(self) -> bytes:
        """The heavy-set bytes of the sharing gate for a chunked admission:
        the static sets from the weights (chunked prefill needs static
        channels, so every request's are the same), in `_heavy_bytes`'s
        layout, so both admission paths publish interchangeable radix
        entries. Computed once."""
        if self._static_heavy_cache is None:
            parts = self.api.static_heavy(self.params, self.max_seq)
            self._static_heavy_cache = b"".join(p.cpu().numpy().tobytes() for p in parts)
        return self._static_heavy_cache

    def _advance_prefill(self) -> None:
        """One budgeted prefill chunk per scheduler pass (the reference's
        `_advance_prefill`). Starting a prefill pops the queue head, reserves
        a slot (masked off until the final chunk), radix-matches the prompt
        and pins every shared prefix block at once (a lazy pin would let the
        owner free a block this prefill still maps). Each pass then charges
        the fresh blocks the next ``prefill_chunk`` tokens first cover and
        runs one chunk step, which streams the chunk's K/V into the slot's
        blocks. A dry free list stalls the chunk (decode goes on and frees or
        preempts blocks): the in-flight request is the newest occupant, so
        preempting others for it would invert priority. The final chunk
        gives the first-token logits and activates the slot as monolithic
        admission does. The chunk step runs eagerly. An in-flight prefill
        past its deadline is aborted first; a chunk failed by the
        ``prefill_chunk`` site charged and wrote nothing, so the next pass
        retries it exactly. With the persistent cache a prompt matched in
        full admits with no prefill (`_try_adopt`) instead, a new prefill
        takes its matched pins (rehydrating cold ones) and a chunk short of
        blocks reclaims the cache's cold end before it stalls."""
        if self._inflight is not None and self._expired(self._inflight.req, time.time()):
            self.stats.deadline_stops += 1
            self._abort_inflight(time.time(), "deadline")
        if self._inflight is None:
            if not (self._queue and self._free):
                return
            if self.prefix_sharing and self._try_adopt(
                    self._queue[0], self._match_tokens(self._queue[0]), time.time()):
                return                  # a zero-prefill warm hit
            req = self._queue.popleft()
            self._begin_cycle(req, time.time())
            slot = self._free.pop()
            shared: list[int] = []
            n_cache = 0
            if self.prefix_sharing:
                req._heavy = self._static_heavy_bytes()
                cand = self._match_tokens(req)
                hot = {b for _, b, _ in cand if b >= 0}
                for key, block, owner_heavy in cand:
                    if owner_heavy != req._heavy:
                        break           # unreachable with static channels
                    if block == CACHE_COLD:
                        block = self._promote_cached(key, protect=hot)
                        if block is None:
                            break       # too tight to rehydrate
                        hot.add(block)
                    shared.append(block)
                n_cache = self._take_pins(shared)
            pages = np.full((self.max_blocks,), -1, np.int32)
            pages[:len(shared)] = shared
            for b in shared:            # the first chunk counts them on the device
                self._refcount[b] += 1
            self._inflight = _InflightPrefill(
                req, slot, self.api.prefill_begin(len(req.prompt), self.device),
                n_shared=len(shared), n_cache=n_cache, shared_ids=list(shared), pages=pages)
            self._slot_blocks[slot] = list(shared)
            self._slot_pos[slot] = 0
        inf = self._inflight
        req, slot = inf.req, inf.slot
        if self._fault("prefill_chunk", rid=req.rid, consumed=inf.consumed):
            self.stats.retries += 1                 # the step failed before it ran
            return
        c = min(self.prefill_chunk, len(req.prompt) - inf.consumed)
        held = self._slot_blocks[slot]
        fresh_needed = max(self._blocks_for(inf.consumed + c) - len(held), 0)
        if fresh_needed > self._alloc.total_free:
            # a pin is cheaper than a lost chunk (this prefill's own shared
            # prefix is protected)
            self._reclaim_cache(fresh_needed, protect=set(inf.shared_ids))
        fresh = self._alloc_blocks(fresh_needed)
        if fresh is None:
            self.stats.chunk_stalls += 1            # pool dry: try again next pass
            return
        for j, b in enumerate(fresh, start=len(held)):
            inf.pages[j] = b
            self._refcount[b] += 1
        held.extend(fresh)
        self._note_block_usage()
        t0 = time.time()
        final = inf.consumed + c == len(req.prompt)
        tokens = torch.from_numpy(np.asarray(req.prompt[inf.consumed:inf.consumed + c],
                                             np.int32)[None]).to(self.device)
        logits, _, _ = self.api.prefill_chunk(self.params, self._state, tokens, inf.cursor,
                                              slot, inf.pages, inf.n_shared, self.max_seq,
                                              final=final, ctx=self.ctx)
        inf.consumed += c
        self._slot_pos[slot] = inf.consumed
        self.stats.prefill_chunks += 1
        self.stats.prefill_tokens += c
        if not final:
            self.stats.prefill_s += time.time() - t0
            return
        logits_row = logits[0].float().cpu().numpy()         # waits for the device
        self.stats.prefill_s += time.time() - t0
        self._inflight = None
        if self.prefix_sharing:
            self._count_shared(req, inf.n_shared, inf.n_cache)
            self._register_blocks(req, held, inf.n_shared, req._heavy, logits_row)
        self._activate(req, slot, logits_row)

    def _grow_or_overflow(self) -> None:
        """Before a tick every active slot must be able to store its next KV
        write privately. Paged: a slot whose cursor crossed a block boundary
        maps one fresh block in every layer; a slot whose cursor block is
        shared (refcount > 1) takes one and gets a private copy of it
        (`cow_block`), the write the append would otherwise drop. Either
        block comes from the shard holding the slot's tail or faulted block
        when that shard has one; a dry free list first reclaims the prefix
        cache's cold end, then with ``host_spill`` demotes the coldest
        candidate. A slot that cannot (no block free, or
        a contiguous slot holding ``max_seq`` tokens) finishes with an
        ``overflow`` stop and the write that could not land is counted. With
        ``preempt`` a dry free list preempts the newest occupant (this slot,
        maybe) instead: a request alone always fits the pool (`submit`), so
        a preempting engine never stops one with ``overflow``. A growth that
        a fault denies (a failed demotion, an allocator reporting an empty
        pool) stalls the slot for one tick (`_stall`)."""
        now = time.time()
        for slot, req in list(self._active.items()):
            if self._active.get(slot) is not req:
                continue                              # preempted in this pass
            if not self.paged:
                if len(req.prompt) + len(req.output) - 1 < self.max_seq:
                    continue
                self.stats.overflows += 1
                self.stats.dropped_writes += 1
                self._finish(slot, req, now, "overflow")
                continue
            pos = self._slot_pos[slot]
            held = self._slot_blocks[slot]
            logical = pos // self.block_size
            if pos < self.max_seq and logical < len(held) and held[logical] >= 0 \
                    and self._refcount[held[logical]] <= 1:
                continue                              # private room in place
            if pos < self.max_seq and not self._alloc.total_free:
                self._reclaim_cache(1)                # the cheapest reclaim first
            if pos < self.max_seq and self.host_spill and not self._alloc.total_free:
                # growth pressure; a failed demotion (a fault) is transient:
                # the slot stalls one tick instead of overflowing
                cand = self._demote_candidates()
                if cand and not self.demote_block(cand[0][1], cand[0][2]):
                    self._stall(slot)
                    continue
            if pos < self.max_seq and self.preempt and not self._alloc.total_free:
                if not self._preempt_for_blocks(slot):
                    continue                          # this slot was the victim
                if logical < len(held) and held[logical] >= 0 \
                        and self._refcount[held[logical]] <= 1:
                    continue                          # a victim's release made it private
            if pos < self.max_seq and self._alloc.total_free:
                near = held[logical] if logical < len(held) else held[-1]
                prefer = self._alloc.shard_of(near) if near >= 0 else None
                got = self._alloc_blocks(1, prefer=prefer)
                if got is None:
                    # a fault reported an empty pool: the slot cannot land its
                    # next write, so it pauses one tick and nothing is lost
                    self._stall(slot)
                    continue
                blk, = got
                self._refcount[blk] += 1
                if logical == len(held):              # growth
                    held.append(blk)
                    self.api.map_block(self._state, slot, logical, blk)
                else:                                 # copy on write
                    self._refcount[held[logical]] -= 1
                    held[logical] = blk
                    self.stats.cow_copies += 1
                    self.api.cow_block(self._state, slot, logical, blk, self.ctx)
                self._note_block_usage()
                continue
            self.stats.overflows += 1
            self.stats.dropped_writes += 1
            self._finish(slot, req, now, "overflow")

    def _decode(self, tokens: np.ndarray, mask: np.ndarray):
        """The tick's one decode call (`runtime.steps`: a CUDA graph replay on
        the card without ``ctx``): (greedy next tokens (S,), logits (S, V_pad),
        finite (S,))."""
        return self._step(tokens, mask)

    def _tick(self) -> None:
        """ONE decode call advancing every active slot, between the
        lifecycle's host work: resident requests past their deadline end,
        cold blocks come back, slots grow (a denied growth stalls its slot
        for this tick); after the call the per-slot quarantine and the
        tokens, the degraded-tick count, the re-arming of stalled slots, the
        spill policy and the audit."""
        now = time.time()
        for slot, req in list(self._active.items()):
            if self._active.get(slot) is req and self._expired(req, now):
                self.stats.deadline_stops += 1
                self._finish(slot, req, now, "deadline")
        self._promote_resurrected()
        self._grow_or_overflow()
        if not self._active:
            return
        if self._mask.any():            # not every active slot is stalled
            self.stats.peak_active_slots = max(self.stats.peak_active_slots,
                                               int(self._mask.sum()))
            self._last_decoded = set(np.flatnonzero(self._mask).tolist())
            t0 = time.time()
            nxt, logits, finite = self._decode(self._tokens.copy(), self._mask.copy())
            nxt_host, finite_host = to_host(nxt, finite)    # one wait for the device
            finite_host = finite_host.copy()                # the fault site writes it
            tick_s = time.time() - t0
            self.stats.decode_s += tick_s
            self.stats.decode_calls += 1
            self.stats.ticks += 1
            self.stats.decode_steps += int(self._mask.sum())
            if self.monitor is not None:
                rec = self.monitor.record(self.stats.ticks, tick_s)
                self.stats.tick_ewma_s = float(rec["ewma"] or 0.0)
                self.stats.straggler_ticks += rec["flagged"]
            # the decode_logits site poisons a slot's flag after the fact: the
            # check below is the path a real non-finite row takes
            if self._faults is not None:
                for slot, req in list(self._active.items()):
                    if slot not in self._stalled and self._fault(
                            "decode_logits", rid=req.rid, slot=slot, tick=self.stats.ticks):
                        finite_host[slot] = False
            logits_host = None                  # reaches the host only to sample
            now = time.time()
            for slot in list(self._active):
                req = self._active[slot]
                if slot in self._stalled:
                    continue                    # paused this tick: nothing advanced
                if self.paged:
                    self._slot_pos[slot] += 1
                if not finite_host[slot] and self._nan_guard.check_slot(slot, False):
                    # quarantine: this slot's request ends; the other rows
                    # of the tick do not depend on it
                    self.stats.errors += 1
                    self._finish(slot, req, now, "error")
                    continue
                if self.greedy or req.temperature <= 0.0:
                    tok = self._next_token(req, None, greedy_tok=int(nxt_host[slot]))
                else:
                    if logits_host is None:
                        logits_host = logits.float().cpu().numpy()
                    tok = self._next_token(req, logits_host[slot])
                self._tokens[slot] = tok
                if req.stop_token is not None and tok == req.stop_token:
                    self._finish(slot, req, now, "stop")
                elif len(req.output) >= req.max_new_tokens:
                    self._finish(slot, req, now, "length")
        # a tick with a stalled slot, or with a cold-pinned block of an active
        # slot, served degraded: available, but paused or sparser
        if self._stalled or any(k[0] in self._active for k in self._pinned_cold):
            self.stats.degraded_ticks += 1
        for slot in self._stalled:              # a stall lasts one tick
            if slot in self._active:
                self._mask[slot] = True
        self._stalled.clear()
        self._spill_policy()
        if self.audit_every and self.stats.ticks != self._audited_tick \
                and self.stats.ticks % self.audit_every == 0:
            self._audited_tick = self.stats.ticks
            self.stats.audits += 1
            rep = self.check_invariants()
            self.last_audit = rep
            if not rep.ok:
                self.stats.audit_failures += 1
                raise RuntimeError(f"integrity audit failed at tick {self.stats.ticks}: {rep}")

    # -- the integrity audit ---------------------------------------------
    def check_invariants(self) -> InvariantReport:
        """Audit the engine's bookkeeping against the device state (the
        reference's audit): every layer's pool passes
        `PagedSalcaCache.check_invariants` against the free list and the
        host refcount mirror (holes allowed with the host tier); every
        allocator shard holds only its own ids; the host's `_slot_blocks`
        rows equal layer 0's page table entry for entry; the host cursors
        equal the device lengths of the slots the last tick decoded (a tick
        zeroes a masked slot's length); every cursor lies in [0, max_seq];
        with the host tier the SPILLED entries and the spill mirror name the
        same blocks; every cache pin has host refcount 0, a radix entry and
        is off the free list, and every radix node and cold payload
        correspond both ways (a CACHE_COLD node to a payload, any other node
        to its block's key). Reads device tensors: run it between ticks,
        never inside a capture. Returns an `InvariantReport`."""
        rep = InvariantReport()
        if not self.paged:
            rep.checked["paged"] = 0            # a contiguous engine: nothing to audit
            return rep
        inf = self._inflight
        if inf is not None and inf.consumed == 0 and inf.n_shared > 0:
            # the shared prefix is counted on the host when the prefill
            # starts and on the device by its first chunk, not run yet
            rep.checked["skipped"] = "inflight shared-pin window"
            return rep
        free = self._alloc.free_ids()
        for sh in range(self.n_shards):
            for b in self._alloc._free[sh]:
                if self._alloc.shard_of(b) != sh:
                    rep.fail(f"free id {b} filed under shard {sh}, owned by "
                             f"{self._alloc.shard_of(b)}")
        # the paged layers' pools (an "L" layer's ring holds no blocks)
        pools = [c for c in self._state.caches if isinstance(c, PagedSalcaCache)]
        rep.checked["pools"] = len(pools)
        for i, pool in enumerate(pools):
            rep.merge(pool.check_invariants(free_blocks=free, host_refcount=self._refcount,
                                            allow_holes=self.host_spill,
                                            cache_pinned=self._cached.keys()),
                      prefix=f"pool[{i}]: ")
        if not pools:
            rep.fail("paged engine with no PagedSalcaCache substates")
            return rep
        free_set = set(free)
        for b in self._cached:
            if self._refcount[b] != 0:
                rep.fail(f"cache-pinned block {b} has host refcount {int(self._refcount[b])} "
                         f"(a pin has no resident owner)")
            if b not in self._block_keys:
                rep.fail(f"cache-pinned block {b} has no radix registration")
            if b in free_set:
                rep.fail(f"cache-pinned block {b} is on the free list")
        for key, (b, _) in self._prefix_nodes.items():
            if b == CACHE_COLD:
                if key not in self._cold_cache:
                    rep.fail("cold radix node without a cold-cache payload")
            elif self._block_keys.get(b) != key:
                rep.fail(f"radix node block {b} not back-registered in _block_keys")
        for key in self._cold_cache:
            node = self._prefix_nodes.get(key)
            if node is None or node[0] != CACHE_COLD:
                rep.fail("cold-cache payload without a CACHE_COLD radix node")
        pt = pools[0].page_table.cpu().numpy()
        ln = pools[0].length.cpu().numpy()
        for slot in range(self.slots):
            held = self._slot_blocks.get(slot)
            if held is None:
                if (pt[slot] >= 0).any():
                    rep.fail(f"slot {slot} holds no blocks host-side but has mapped "
                             f"page-table entries")
                continue
            for j in range(self.max_blocks):
                want = -1 if j >= len(held) or held[j] == SPILLED else held[j]
                if pt[slot, j] != want:
                    rep.fail(f"slot {slot} logical {j}: host says {want}, device page "
                             f"table says {int(pt[slot, j])}")
                    break
            pos = self._slot_pos.get(slot)
            if pos is not None and slot in self._active and slot in self._last_decoded \
                    and int(ln[slot]) != pos:
                rep.fail(f"slot {slot}: host cursor {pos} != device length {int(ln[slot])}")
            if pos is not None and not 0 <= pos <= self.max_seq:
                rep.fail(f"slot {slot}: host cursor {pos} out of [0, {self.max_seq}]")
        if self.host_spill:
            cold = {(slot, j) for slot, held in self._slot_blocks.items()
                    for j, b in enumerate(held) if b == SPILLED}
            if cold != set(self._spilled):
                rep.fail(f"spill-mirror mismatch: SPILLED entries {sorted(cold)} vs mirror "
                         f"payloads {sorted(self._spilled)}")
        return rep

    def run(self, max_ticks: int = 10_000) -> ServeStats:
        ticks = 0
        while (self._queue or self._active or self._inflight is not None) \
                and ticks < max_ticks:
            self._admit()
            if self._active:
                self._tick()
            ticks += 1
        return self.stats
