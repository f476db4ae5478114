"""Serving engine: continuous batching over a slot-pooled or paged Salca KV cache.

Port of the reference `runtime/serve.py`. The engine keeps ONE pooled
decode state. Admission is FIFO: a request is prefilled alone (batch 1,
kernel B3) and written into a free slot of that state; each tick makes
exactly ONE decode call that advances all active slots under an
active-slot mask (`runtime.steps`: on the card, one CUDA graph replay
without ``ctx``). Sampling is greedy (argmax). Every write into the state
— admission, growth, release, host-tier moves — is in place: the state's
tensors are the ones the tick's graph was captured over.

Contiguous slot pool (``paged=False``, the default, as in the reference):
every layer's cache is a dense ``(slots, max_seq, ·)`` `SalcaCache`; the
prefill is copied into the slot's row, a finished slot is reset (length
0), and the tick runs kernels B7, B9 and B8 in every layer. A slot that
reached ``max_seq`` finishes with an ``overflow`` stop.

Paged pool (``paged=True``): every layer's attention cache is a shared
physical block pool with per-slot page tables. Admission writes the
prompt into the ``ceil(prompt / block_size)`` blocks it takes from the
free list and waits head-of-line while the pool cannot cover it. Each tick
first grows every slot whose cursor crossed a block boundary by one block
(or finishes it with an ``overflow`` stop when the free list is empty);
the tick runs kernels B1 and B2 in every layer.

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

Knobs that the reference rejects without ``paged=True`` raise its
`ValueError`s; knobs of the reference engine that later slices port raise
`NotImplementedError` naming that slice instead of being ignored.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import DecodeCtx
from repro_torch.kernels.common import resolve_device
from repro_torch.models.registry import get_model
from repro_torch.runtime.steps import ServeDecodeStep

# reference knob → the port slice (ROADMAP Queue A) that brings it
_LATER = {
    "prefix_sharing": "A.7 (prefix sharing with copy-on-write)",
    "prefix_cache": "A.7 (persistent prefix cache)",
    "prefill_chunk": "A.7 (chunked prefill and preemption)",
    "preempt": "A.7 (chunked prefill and preemption)",
    "faults": "A.7 (fault injection, deadlines and the auditor)",
}
SPILLED = -1     # a slot's logical block that lives in the host tier


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (T,) int32
    max_new_tokens: int = 16
    stop_token: int | None = None
    submitted: float = field(default_factory=time.time)
    admitted: float | None = None
    first_token_time: float | None = None
    done_time: float | None = None
    stop_reason: str | None = None     # "length" | "stop" | "overflow"
    output: list = field(default_factory=list)
    token_times: list = field(default_factory=list)

    @property
    def ttft_s(self) -> float | None:
        return None if self.first_token_time is None else self.first_token_time - self.submitted


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
    queue_wait_s: float = 0.0
    ttft_s: float = 0.0
    admissions: int = 0
    ttft_count: int = 0
    peak_active_slots: int = 0
    overflows: int = 0
    dropped_writes: int = 0
    prefill_tokens: int = 0
    block_pool_size: int = 0
    block_size: int = 0
    blocks_in_use: int = 0
    peak_blocks_in_use: int = 0
    shards: int = 1                      # pool shards (the ctx's world size)
    peak_shard_blocks_in_use: int = 0    # hottest single shard at peak (shards > 1)
    # tiered KV memory (zero unless host_spill=True)
    host_spill: bool = False
    hot_blocks: int = 0        # device-resident blocks in use (last sample)
    cold_blocks: int = 0       # host-resident spilled blocks (last sample)
    peak_cold_blocks: int = 0
    demotions: int = 0         # block moves device → host
    promotions: int = 0        # block moves host → device
    pcie_bytes: int = 0        # block bytes × moves

    def summary(self) -> dict:
        """The reference's summary keys that this port has, rounded as there
        (seconds to 4 places, ms and utilisations to 3); the block-pool keys
        only for a paged engine, the shard keys only over several shards."""
        out = {
            "completed": self.completed, "prefill_s": round(self.prefill_s, 4),
            "decode_s": round(self.decode_s, 4), "decode_steps": self.decode_steps,
            "ticks": self.ticks, "decode_calls": self.decode_calls,
            "tokens_generated": self.tokens_generated,
            "decode_ms_per_step": round(1e3 * self.decode_s / max(self.decode_steps, 1), 3),
            "decode_ms_per_tick": round(1e3 * self.decode_s / max(self.ticks, 1), 3),
            "decode_tokens_per_s": self.decode_steps / self.decode_s if self.decode_s else 0.0,
            "mean_queue_wait_s": round(self.queue_wait_s / max(self.admissions, 1), 4),
            "mean_ttft_s": round(self.ttft_s / max(self.ttft_count, 1), 4),
            "admissions": self.admissions, "peak_active_slots": self.peak_active_slots,
            "overflows": self.overflows, "dropped_writes": self.dropped_writes,
            "prefill_tokens": self.prefill_tokens,
        }
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
            if self.host_spill:
                out.update(hot_blocks=self.hot_blocks, cold_blocks=self.cold_blocks,
                           peak_cold_blocks=self.peak_cold_blocks, demotions=self.demotions,
                           promotions=self.promotions, pcie_bytes=self.pcie_bytes)
        return out


class ServingEngine:
    """Slot-pooled continuous-batching engine.

    ``paged=False`` (the default): a contiguous ``(slots, max_seq, ·)`` cache
    per layer. ``paged=True``: ``num_blocks`` physical blocks of
    ``block_size`` tokens shared by ``slots`` request slots; ``block_size``
    must divide ``max_seq``; ``ctx`` (`distributed.sharding.DecodeCtx`)
    splits the pool's blocks across its ranks, and ``num_blocks`` must then
    divide evenly by the world size. ``kv_pool_dtype`` and ``host_spill``
    (with ``demote_after``, ``spill_keep_recent``, ``promote_headroom``):
    the tiered pool of the module docstring. Runs on ``device`` ("cuda" by
    default, which raises on a machine without a card); ``device="cpu"``
    runs every kernel's plain version.
    """

    def __init__(self, cfg: ModelConfig, params: dict, max_seq: int, slots: int = 4,
                 paged: bool = False,
                 block_size: int = 32, num_blocks: int | None = None,
                 device="cuda", *, ctx: DecodeCtx | None = None,
                 prefix_sharing: bool = False,
                 prefix_cache: bool = False, kv_pool_dtype: str | None = None,
                 host_spill: bool = False, demote_after: int = 4,
                 spill_keep_recent: int = 2, promote_headroom: int = 1,
                 prefill_chunk: int | None = None, preempt: bool = False, faults=None):
        self.device = resolve_device(device)
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
            if ctx is not None:
                raise NotImplementedError("ctx with paged=False: the sequence-sharded "
                                          "contiguous tick is not ported yet (ROADMAP A.9)")
        if prefix_cache and not prefix_sharing:
            raise ValueError("prefix_cache requires prefix_sharing=True")
        asked = {"prefix_sharing": prefix_sharing, "prefix_cache": prefix_cache,
                 "prefill_chunk": prefill_chunk is not None, "preempt": preempt,
                 "faults": faults is not None}
        for knob, on in asked.items():
            if on:
                raise NotImplementedError(f"{knob}: not ported yet; comes with slice "
                                          f"{_LATER[knob]}")
        self.cfg, self.params, self.max_seq, self.slots = cfg, params, max_seq, slots
        self.paged = paged
        self.api = get_model(cfg)
        self.stats = ServeStats()
        self._queue: deque[Request] = deque()
        self._active: dict[int, Request] = {}
        self._free = sorted(range(slots), reverse=True)          # pop() → lowest
        self._tokens = np.zeros((slots,), np.int32)
        self._mask = np.zeros((slots,), bool)
        self.ctx = ctx
        self.n_shards = 1 if ctx is None else ctx.world_size
        self.host_spill = host_spill
        if not paged:
            self._state = self.api.init_state(slots, max_seq, self.device)
            self._step = ServeDecodeStep(self.api.decode_step, params, self._state, slots,
                                         self.device)
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
        self._state = self.api.init_paged_state(slots, max_seq, block_size,
                                                self.num_blocks, self.device, ctx)
        self._step = ServeDecodeStep(self.api.decode_step, params, self._state, slots,
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
        """Enqueue a request; returns True (the reference's bounded queue,
        which returns False when it sheds one, is not ported yet). A
        malformed request raises."""
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
        self._queue.append(req)
        return True

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

    def demote_block(self, slot: int, logical: int) -> bool:
        """Move one mapped private block device → host: copy its rows in
        storage format to pinned host memory, unmap the page-table entry
        (the block becomes unselectable) and free the physical block."""
        held = self._slot_blocks[slot]
        blk = held[logical]
        assert blk >= 0 and self._refcount[blk] == 1, \
            f"demote needs a mapped private block, got ({slot}, {logical}) -> {blk}"
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
        block is free."""
        payload = self._spilled[(slot, logical)]
        fresh = self._alloc.alloc(1)
        if fresh is None:
            return False
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
        every mapped private block outside its slot's `spill_keep_recent`
        trailing blocks (the cursor block among them)."""
        out = []
        for slot in self._active:
            held = self._slot_blocks[slot]
            n_blocks = self._blocks_for(max(self._slot_pos[slot], 1))
            for j in range(min(max(n_blocks - self.spill_keep_recent, 0), len(held))):
                b = held[j]
                if b != SPILLED and self._refcount[b] == 1:
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
        highest score — at most one per slot per tick."""
        if not (self.host_spill and self._spilled):
            return
        best: dict[int, tuple[float, int]] = {}
        for (slot, j), score in self._spill_score.items():
            if slot in self._active:
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

    def _admit(self) -> None:
        """FIFO admission: prefill the queue head alone and write it into the
        lowest free slot (paged: into freshly allocated blocks, waiting
        head-of-line when the pool is short; with ``host_spill`` cold blocks
        are demoted first and a prompt larger than the free pool admits in
        waves)."""
        while self._queue and self._free:
            if not self.paged:
                req = self._queue.popleft()
                slot = self._free.pop()
                t0 = time.time()
                req.admitted = t0
                self.stats.admissions += 1
                self.stats.queue_wait_s += t0 - req.submitted
                logits_row, state1 = self._prefill(req)
                self.api.write_into_slot(self._state, state1, slot)
                self._activate(req, slot, logits_row)
                continue
            req = self._queue[0]
            need = self._blocks_for(len(req.prompt))
            if self.host_spill and need > self._alloc.total_free:
                # admission pressure: cold blocks of active slots go to the
                # host tier before the queue waits on the device pool
                self._demote_for(need)
            free = self._alloc.total_free
            if need > free and not (self.host_spill and free):
                break          # head-of-line wait (the host tier needs one free block)
            t0 = time.time()
            self._queue.popleft()
            slot = self._free.pop()
            req.admitted = t0
            self.stats.admissions += 1
            self.stats.queue_wait_s += t0 - req.submitted
            logits_row, state1 = self._prefill(req)
            self._slot_pos[slot] = len(req.prompt)
            if self.host_spill:
                self._hist_snap[slot] = 0
                self._cold_streak[slot] = 0
            self._install_prompt(slot, need, state1)
            self._activate(req, slot, logits_row)

    def _install_prompt(self, slot: int, need: int, state1) -> None:
        """Write a prefilled prompt into ``need`` freshly allocated blocks
        (least-loaded shards first): in one write when the free pool covers
        it; otherwise (host_spill) in free-pool-sized waves, each demoted to
        the host before the next lands, the last — the recency tail with the
        cursor block — staying hot. A write drops the rows of the blocks
        outside its wave (their pages are -1)."""
        held = [SPILLED] * need
        self._slot_blocks[slot] = held
        lo = 0
        while lo < need:
            w = min(self._alloc.total_free, need - lo)
            ids = self._alloc.alloc(w)
            pages = np.full((self.max_blocks,), -1, np.int32)
            pages[lo:lo + w] = ids
            for j, b in zip(range(lo, lo + w), ids):
                held[j] = b
                self._refcount[b] += 1
            self._note_block_usage()
            self.api.write_into_pages(self._state, state1, slot, pages, self.ctx)
            lo += w
            if lo < need:
                for j in range(lo - w, lo):
                    self.demote_block(slot, j)

    def _next_token(self, req: Request, tok: int) -> int:
        self.stats.tokens_generated += 1
        req.token_times.append(time.time())
        req.output.append(tok)
        return tok

    def _activate(self, req: Request, slot: int, logits_row: np.ndarray) -> None:
        tok = self._next_token(req, int(np.argmax(logits_row)))
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
        req.done_time = now
        req.stop_reason = reason
        self.stats.completed += 1
        del self._active[slot]
        self._mask[slot] = False
        self._free.append(slot)
        self._free.sort(reverse=True)
        if self.paged:
            for b in self._slot_blocks.pop(slot):
                if b == SPILLED:
                    continue                          # host-tier entry: no device block
                self._refcount[b] -= 1
                if self._refcount[b] == 0:
                    self._alloc.release(b)
            self._slot_pos.pop(slot)
            if self.host_spill:
                for key in [k for k in self._spilled if k[0] == slot]:
                    del self._spilled[key]
                    self._spill_score.pop(key, None)
                self._hist_snap[slot] = 0
                self._cold_streak[slot] = 0
            self._note_block_usage()
        self.api.reset_slot(self._state, slot)

    def _grow_or_overflow(self) -> None:
        """Before a tick every active slot must be able to store its next KV
        write. Paged: a slot whose cursor crossed a block boundary maps one
        fresh block in every layer, from the shard holding its tail block
        when that shard has one; with ``host_spill`` a dry free list first
        demotes the coldest candidate. A slot that cannot (no block free, or
        a contiguous slot holding ``max_seq`` tokens) finishes with an
        ``overflow`` stop and the write that could not land is counted."""
        now = time.time()
        for slot, req in list(self._active.items()):
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
            if pos < self.max_seq and logical < len(held):
                continue
            if pos < self.max_seq and self.host_spill:
                self._demote_for(1)                   # growth pressure
            if pos < self.max_seq and self._alloc.total_free:
                blk, = self._alloc.alloc(1, prefer=self._alloc.shard_of(held[-1]))
                self._refcount[blk] += 1
                held.append(blk)
                self.api.map_block(self._state, slot, logical, blk)
                self._note_block_usage()
                continue
            self.stats.overflows += 1
            self.stats.dropped_writes += 1
            self._finish(slot, req, now, "overflow")

    def _decode(self, tokens: np.ndarray, mask: np.ndarray):
        """The tick's one decode call (`runtime.steps`: a CUDA graph replay on
        the card without ``ctx``): (greedy next tokens (S,), logits (S, V_pad))."""
        return self._step(tokens, mask)

    def _tick(self) -> None:
        self._promote_resurrected()
        self._grow_or_overflow()
        if not self._active:
            return
        self.stats.peak_active_slots = max(self.stats.peak_active_slots,
                                           int(self._mask.sum()))
        t0 = time.time()
        nxt, _ = self._decode(self._tokens.copy(), self._mask.copy())
        nxt_host = nxt.cpu().numpy()                          # waits for the device
        self.stats.decode_s += time.time() - t0
        self.stats.decode_calls += 1
        self.stats.ticks += 1
        self.stats.decode_steps += int(self._mask.sum())
        now = time.time()
        for slot in list(self._active):
            req = self._active[slot]
            if self.paged:
                self._slot_pos[slot] += 1
            tok = self._next_token(req, int(nxt_host[slot]))
            self._tokens[slot] = tok
            if req.stop_token is not None and tok == req.stop_token:
                self._finish(slot, req, now, "stop")
            elif len(req.output) >= req.max_new_tokens:
                self._finish(slot, req, now, "length")
        self._spill_policy()

    def run(self, max_ticks: int = 10_000) -> ServeStats:
        ticks = 0
        while (self._queue or self._active) and ticks < max_ticks:
            self._admit()
            if self._active:
                self._tick()
            ticks += 1
        return self.stats
