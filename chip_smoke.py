#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. the card's name and power limit (nvidia-smi);
2. build the CUDA kernels' five sources from ``src/repro_torch/csrc`` (the
   eleven TPU kernels' counterparts and B3-bwd, B3's backward)
   (nvcc, sm_90a, one process per source, all started together);
3. hold each kernel against its plain PyTorch version on the card, at the
   shapes the main paths give it, with kernel, plain and library times and
   the roofline bound — the paged kernels (B1 paged scores, B4 scores +
   bounds and B5 bin/pool/histogram: bit-identical, with their CTA counts
   from the trace, B5 also timed with the L2 flushed before each call, and
   the share of B4's (slot, block) pairs that hold no valid token printed
   apart; B2 sparse decode
   attention and B6 its unnormalised partials: f32, in each of the pool's
   storage branches int8, fp16 and int4, split over output channels with
   their CTA count from the trace, B2 with SDPA over the listed blocks
   as its yardstick, timed without and with the gather and the
   dequantization; B3 causal prefill attention:
   bf16 on the tensor cores, with its TFLOP/s, its time over SDPA's and
   the count of HMMA/HGMMA lines in its library's SASS, which must not be
   0), the contiguous tick's (B7 flat scores in both of its chains, with
   its CTA count and its time on a flushed L2, and B9
   bin/pool/histogram/threshold: bit-identical, likewise with its CTA
   count and cold time; B8 sparse decode
   attention over gathered rows, split over output channels: f32, with
   SDPA over the dequantized rows as its yardstick, timed without and
   with the dequantization), and B10 (max-pool) and B11
   (histogram + threshold), bit-identical, driven once through their
   public entry points, with their CTA counts and cold times; the
   sequence-sharded flat tick's (B10 over the halo-padded bins and B11 on
   the pooled ones, bit-identical, and B8's partials branch (acc, m, l)
   over one rank's selection, at qwen3-0.6b's and gemma3-12b's contiguous
   shapes: `check_sp_flat_kernels`); at
   gemma3-12b's shapes (HD 256, G 2, W = r/16 = 8; k and k_cap from its
   first layer's ring of 1024) B1 bit-identical, B2 int8 with its
   yardstick and B3 at HD 256, causal and under the window of 1024 (with
   SDPA under the same mask), then B3's HD-256 f32 cases (causal, windowed,
   at ``q_offset`` > 0) and bf16 chunks at ``q_offset`` > 0, and B2/B6's
   fp16 and int4 branches, checked and printed; then check the whole
   serving path on a small input — paged, contiguous, a fp16 pool, an
   int4 pool with the host tier on a pool small enough that blocks demote
   and promote, and gemma3-12b.reduced() paged and contiguous (rings of 64
   that every prompt wraps): the port on the card against the port's plain
   versions on the CPU (greedy tokens identical, logits close);
4. serve full-width qwen3-0.6b (random bf16 weights from a seed) through
   ``ServingEngine(paged=True, slots=4, max_seq=8192, block_size=32)``:
   4 requests of 2048-4096-token prompts × 16 new tokens, with every
   kernel's launch counter set to 0 just before and read just after; the
   tick of every unsharded run is a CUDA graph after its first, eager, call
   (`runtime.steps`; a replay counts one tick's launches); the same run
   again with the engine built under `steps.eager()` must give the same
   greedy tokens and every logits row bit for bit (each run's ms per tick,
   first, capture and replay ticks, kernel-wrapper launches per replay and
   peak memory are printed); then
   serve the same requests again through the block-sharded tick,
   ``ServingEngine(paged=True, ctx=...)`` over a world of one rank (nccl):
   B4, B5 and B6 replace B1 and B2, and the greedy tokens must equal the
   first run's; then through the contiguous slot pool,
   ``ServingEngine(paged=False, slots=4, max_seq=8192)``: B7, B9 and B8
   run the tick, fed the first run's tokens (teacher forcing), and every
   logits row of every request must stay within CONTIG_LOGIT_ULPS bf16
   ulps of the first run's row for the same history; a step where the two
   greedy picks part is printed with the paged run's top-two gap. Then the
   tiered pool: ``kv_pool_dtype="fp16"`` and ``"int4"``, each unsharded
   (B2's branch) and block-sharded at one rank (B6's branch, tokens equal
   to the unsharded run's), and ``kv_pool_dtype="int4", host_spill=True``
   on SPILL_RUN's 200-block pool, checked by `SpillProbe` (a bit-exact
   block round trip, wave admission, pressure and policy demotion,
   promotion, transfer bytes, a drained pool). Last, prefix sharing with
   copy on write: the model with ``salca_static_channels`` serves a
   SHARED_PREFIX-token prefix with three distinct SHARED_TAIL-token tails
   and a fourth request repeating the first prompt, on SHARED_BLOCKS
   blocks with ``prefix_sharing=True`` (graphed tick), then on the default
   pool without sharing (the twin: greedy tokens identical, every logits
   row bit for bit, the same launches per tick), then shared again over
   the one-rank nccl world (tokens identical); the sharing counts must be
   the ones the lengths give (SHARED_COUNTS), and the one copy on write is
   profiled (launches, ms). Then continuous batching (chunked prefill and
   preemption), the model with ``salca_static_channels``, the main path's
   prompts and SCHED_NEW new tokens: (a) monolithic admission, requests 2
   and 3 submitted after the SCHED_LATE_TICK-th tick, driven by the
   engine's `_admit` / `_tick`; (b) the same arrivals with
   ``prefill_chunk=SCHED_CHUNK`` (B3 at ``q_offset`` > 0); (c)
   ``preempt=True`` on SCHED_PREEMPT_BLOCKS blocks; (d) both on
   SCHED_CHUNK_PREEMPT_BLOCKS blocks (the in-flight prefill is preempted);
   (e) = (d) over the one-rank nccl world. (b), (c) and (d) must give (a)'s
   greedy tokens and every logits row bit for bit (a replayed token's
   rows included), (e) its tokens; (c)-(e) no overflow and preemptions,
   (c) replayed tokens, (d) and (e) chunk stalls, every pool drained. It
   prints the largest gap between fresh tokens of requests 0 and 1 while
   the late prompts prefill, TTFT, ms per tick, peak memory and the
   counts. Last, the request lifecycle and fault tolerance: (f) the main
   path sampled (``greedy=False, seed=0``, requests 0 and 2 at temperature
   0.8, 1 and 3 at 0), graphed and again built under `steps.eager()`:
   tokens identical and every logits row bit for bit, requests 1 and 3
   equal to the greedy run's tokens, the host ms of a sampled token and of
   the logits copy printed; (g) run (b) with ``audit_every=1`` and a seeded
   `FaultPlan` (`sched_faults`: the allocator, the chunk step and one
   poisoned flag of request 1): requests 0, 2 and 3 give (b)'s tokens and
   rows bit for bit, request 1 ends with ``error``, every site fired and
   every tick's audit is clean; (h) the fp16 main path with NaN written into
   request 2's V codes of layer 0 after the 5th tick: the graph's ``finite``
   output drops request 2's flag on one replayed tick, request 2 ends with
   ``error`` and every other row equals the clean fp16 run's bit for bit;
   (i) (b)'s engine with ``max_queue=4``: a fifth request is shed, a sixth
   with ``deadline_ms=1`` expires in the queue, request 3 is cancelled in
   its chunked prefill, requests 0-2 give (b)'s tokens and rows, the pool
   drains and the audit is clean; (j) SPILL_RUN with every promotion
   failing (``spill_max_retries=1``): blocks pin cold, ticks run degraded,
   no promotion lands, the audit stays clean; (k) = (g) at one nccl rank:
   (g)'s tokens, stop reasons and fired faults. Last, the persistent prefix
   cache: the model with ``salca_static_channels`` serves a visit trace,
   two tenants' CACHE_HEADER-token headers with two users' CACHE_TAIL-token
   tails each (2570-token prompts), twice over, tenant-major, each request
   submitted alone once the engine drained (`serve_visits`): (l)
   ``prefix_sharing=True, prefix_cache=True`` on CACHE_BLOCKS blocks against
   a cold twin with ``prefix_sharing`` only (tokens and every logits row bit
   for bit, the counts CACHE_COUNTS["l"], the second pass's median TTFT at
   most CACHE_TTFT_RATIO × the first pass's, the replay median against the
   twin's); (m) the same on CACHE_TIGHT_BLOCKS blocks against its own twin
   (LRU eviction before each wait: CACHE_COUNTS["m"]); (n) = (m) with
   ``host_spill`` (pins demoted to the cold tier and rehydrated on a hit:
   CACHE_COUNTS["n"], every demotion a pin's, ``pcie_bytes`` = moves ×
   block bytes; bit for bit against (m)'s twin); (o) = (l) with
   ``prefill_chunk=SCHED_CHUNK, preempt=True`` against a chunked twin
   (whether it equals (l)'s twin too is printed); (p) the first tenant's
   user 0, user 1 and user 0 again at one nccl rank (B4-B6) against a
   one-rank cold twin, its tokens (l)'s; (q) `api.calibrate` on the card
   over the main path's four prompts cut to 2048 tokens, then (p)'s three
   requests unsharded on the calibrated tree, cache against cold twin, bit
   for bit with one zero-prefill hit; one adoption over every layer is
   profiled (launches, ms). Each pool is flushed and must drain whole.
   Last, the other dense configs, one model on the card at a time, each
   full width with random bf16 weights from seed 0: (r) gemma3-12b
   (48 layers, "LLLLLA": 40 sliding-window layers of 1024 keep a ring per
   slot, 8 global layers run B1 and B2; B3 at HD 256, windowed in the ring
   layers) on the main path's engine and prompts, graphed; (s) = (r) built
   under `steps.eager()`: tokens and every logits row bit for bit; (t) =
   (r) on the contiguous pool (B7, B9, B8 in the global layers), fed (r)'s
   tokens, its largest gap in bf16 ulps of the top logit printed (not a
   gate); (u) qwen3-8b, then phi3-medium-14b, on DENSE_SLOTS slots with
   DENSE_PROMPTS × DENSE_NEW_TOKENS, graphed, each bit for bit against its
   eager twin. Last, the sharded leftovers (`check_flat_and_rings`): (v)
   qwen3-0.6b through ``ServingEngine(paged=False, ctx=...)`` at one nccl
   rank, the sequence-sharded flat tick (B7, B10, B11 and B8's partials
   branch around the all-reduces), fed the paged run's tokens: every logits
   row within CONTIG_LOGIT_ULPS of the contiguous run's, up to a request's
   first tick where a row kept more than k_cap (the flat tick's capacity is
   4·k_cap at one rank; `CapProbe` prints where), with its ms, launches and
   collectives per tick; (w) gemma3-12b paged at one nccl rank (its 8 global
   layers block-sharded, its 40 rings sequence-sharded), fed (r)'s tokens:
   every logits row within CONTIG_LOGIT_ULPS of (r)'s (the rings' merge
   sums in another order, and random weights put picks on 0-1-ulp ties);
   (x) gemma3-12b paged under ``perf_flags(ring_local_cache=False)`` (40
   full-context layers under the window mask; the global layers then take
   k from max_seq, the reference's rule) and (x') its contiguous twin, both
   fed (r)'s first RING_OFF_NEW_TOKENS tokens: every row of (x') within
   CONTIG_LOGIT_ULPS of (x)'s; the gap to (r), peak memory and replay ms
   against (r)'s printed, and one "L" layer's attention timed over the
   full context and over its ring. Then the reference's unfused baselines
   (`check_unfused`): (y) the main path with ``fused_decode=False`` (B7
   over the logical copy of the feature stream, B8 over the gathered rows),
   graphed, fed the paged run's tokens: every logits row within
   CONTIG_LOGIT_ULPS of the paged run's, the ms per tick against it, and
   where the two runs' per-tick `sel_hist` part (reported: B8's roundings
   move the next layer's query); (y'') its eager twin, every row bit for
   bit, with `SameStateProbe` holding each layer's selection to the fused
   route's on the same state; (y') the one-rank engine under
   ``perf_flags(sharded_fused_decode=False)`` (the logical-gather island:
   B7, B8's partials branch), fed the fused one-rank run's tokens, the same
   probe against the fused island and its rows within CONTIG_LOGIT_ULPS;
   and the MoE family (`check_moe`): (z) granite-moe-3b-a800m at full width
   (32 layers, 24 H / 8 KV: G 3, HD 64; 40 experts padded to 48, top-8;
   random bf16 weights from seed 0) on the main path's engine and prompts,
   graphed, with the (token, choice) pairs its capacity drops in each
   prefill (`DropProbe`); (z') its eager twin, bit for bit; (z'') its
   contiguous twin and (z''') it at one nccl rank, both fed (z)'s tokens,
   rows within CONTIG_LOGIT_ULPS; one MoE layer's FFN timed alone. Phase 3
   holds granite's shapes too: B1, B2 and B3 at HD 64 and B4-B6 (records
   tagged `[granite-moe-3b-a800m]`), its contiguous twin's B7, B9 and B8,
   B8's partials branch at G 3, B2/B6's fp16 and int4 branches at G 3
   (printed), B1/B4/B7 at r 32 with ``group_sum_query`` on and off, and the
   paged tick's unfused route against the fused one on one pool
   (`check_group_rows_and_baseline`). Last, the recurrent families
   (`check_recurrent`), each at full width with random bf16 weights from
   seed 0 on the main path's engine and prompts, loaded alone: (aa)
   mamba2-2.7b (64 SSD layers, no attention: no kernel on its path; the
   SSD is torch ops, as the reference's is XLA ops), graphed; (aa') its
   eager twin and (aa'') its contiguous twin, every row bit for bit (with
   no attention cache both engines hold the same state); (ab)
   recurrentgemma-2b (26 layers "RRL": 18 RG-LRU layers, 8 local-attention
   layers keeping rings of 2048 that every prompt wraps, B3 at G 10 / HD
   256 under the window in their prefill), graphed; (ab') eager and (ab'')
   contiguous, bit for bit (the rings are contiguous caches in both
   engines). Each prints its replay ms, a profiled tick's launches and
   device ms, peak memory, each prefill's ms and TTFT, the state bytes per
   slot, and one layer of each kind by `graph_ms`. Phase 3 holds B3 at
   recurrentgemma's shapes (record tagged `[recurrentgemma-2b]`, counted on
   run (ab)), and the small path runs both models reduced (paged). Last,
   the last two families (`check_encdec_and_vlm`), each at full width with
   random bf16 weights from seed 0, through their model API
   (`serve_model_api`: one slot a request in a pooled contiguous state,
   each request prefilled at batch 1 and written into its slot, greedy
   ticks of `runtime.steps.ServeDecodeStep` with an active mask, a slot
   reset when its request ends): (ac) whisper-small, 4 requests of
   ENC_FRAMES random frames (f32, made on the card) with decoder prompts of
   ENC_PROMPTS tokens × ENC_NEW_TOKENS new tokens (12 encoder layers of B3
   without a causal mask over the frames, 12 decoder layers with B3 causal
   over the prompt and B3 without a mask from the prompt over the frames;
   the tick's B7, B9 and B8 over the 32768-row cross caches), graphed; (ac')
   its eager twin, bit for bit; (ac*) the admitted pool's first tick at one
   nccl rank (the step's ``ctx`` branch: B7, B10, B11 and B8's partials
   branch over the cross caches, `CtxTick`), its next tokens equal to
   (ac)'s, its rows within CONTIG_LOGIT_ULPS, and no (slot, head) keeping
   more than k_cap rows; (ad) llava-next-mistral-7b,
   VLM_REQUESTS requests of 2880 patch rows (dim 1024) and VLM_TEXT text
   tokens × VLM_NEW_TOKENS on a contiguous pool of VLM_MAX_SEQ rows,
   graphed; (ad') its eager twin, bit for bit; (ad'') the text-only paged
   engine on VLM_TEXT_PROMPTS. Each prints its encoder and prefill ms per
   request, replay ms, launches per tick, state bytes per slot and peak
   memory. Phase 3 holds B3 without a causal mask at whisper's encoder and
   cross shapes against the plain version over every row (in blocks of
   PLAIN_ROWS query rows), B7, B9 and B8 at its cross stream's shapes
   (records tagged `[whisper-small ...]`, counted on run (ac)) and B10, B11
   and B8's partials branch there at one rank (`check_sp_flat_kernels`,
   counted on run (ac*)), and B7, B9 and B8 at llava's run (ad) (G 4, HD
   128, VLM_MAX_SEQ rows in VLM_REQUESTS slots; tagged
   `[llava-next-mistral-7b]`, counted on run (ad)); the small path runs
   whisper reduced through the same model-API server (card against CPU)
   and llava reduced through the paged engine.

Last, training (`check_train_gradients`, `check_training`): (af)
qwen3-0.6b's widths at GRAD_LAYERS layers (random bf16 weights, seed 0),
one TRAIN_SHAPE batch of `runtime.data.make_batch`: every parameter's
gradient through B3 and B3-bwd against the same through their plain
versions on the card, each leaf within GRAD_CHECK_LIMIT of its largest
magnitude; (ag) full-width qwen3-0.6b (28 layers) trained by
`runtime.Trainer` for TRAIN_STEPS steps of TRAIN_SHAPE (the train_4k cell
at seq 4096 with its global batch cut from 256 to 4 for one card), a
checkpoint every TRAIN_CKPT_EVERY steps into a temporary directory, with
each step's ms, tokens/s, loss, gradient norm, peak memory, B3's and
B3-bwd's launches (2 and 3 per layer and step) and a profiled step's
device time in each; every loss finite and the mean of the last three
below that of the first three; (ag') a fresh `Trainer` on the directory,
its last checkpoint removed, resumes at step TRAIN_CKPT_EVERY and gives
the first run's losses and gradient norms bit for bit. Phase 3 holds
B3-bwd (run (ae), `check_b3_bwd`) against its plain version at the
training shapes: qwen3-0.6b's (4 × 16 H over 8 KV, HD 128, T 4096, causal,
and under a window of 1024), whisper-small's encoder (unmasked, HD 64) and
cross-attention (448 queries over 4096 frames), gemma3-12b's (HD 256,
causal and under the window) and one f32 case, each gradient within
B3_BWD_TOL, timed by `graph_ms` beside the backward of one
`scaled_dot_product_attention` call, whose own gradients' ratio to the
same tolerance is printed as a reading (its record counted on run (ag)).
Then training over the data axis (`check_sharded_training`): (am) the same
model, shape and seed through `Trainer(cfg, shape, MeshPlan(...))` on a
(1, 1) ("data", "model") mesh over the one-rank nccl world
(`runtime.steps.ShardedTrainStep`: FSDP blocks, a gather of the whole
parameters, reduce-scatters and all-reduces over one rank) for
TRAIN_CKPT_EVERY steps: its losses and gradient norms bit for bit with
(ag)'s first TRAIN_CKPT_EVERY (else the first step where they part is
printed), its ms per step, tokens/s, peak memory, collectives per step and
B3 / B3-bwd launches beside (ag)'s, and its step-6 checkpoint's
parameters, restored through `restore(shardings=)`, bit for bit with
(ag)'s step-6 checkpoint's; (am') `distributed.compression.make_compressed_grad_fn` at the
same rank for COMPRESSED_STEPS AdamW steps: every loss finite, within the
CPU check's criterion (``l_c < 1.5·l_e + 1e-3``) of (ag)'s loss at the
same step, and the compressed gradients' largest error at step 0 over
each leaf's largest magnitude within the quantizer's half step (0.5/127).
Phase 3 also runs (an) (`check_cp_shards`): B3's LSE form and B3-bwd at
a context-parallel rank's query offset, at phi3-medium-14b's training
attention (4 × 40 H over 10 KV, HD 128, T 4096, causal) and qwen3-0.6b's
under a window of 1024, split into CP_SHARDS query shards of 1,024 rows at
q_offset 0, 1024, 2048 and 3072 over the keys through each shard's last
row: each shard's out, LSE and gradients against the plain version at its
offset, its out, LSE and dQ bit for bit with the unsharded call's rows, the
shards' summed dK/dV within B3_BWD_TOL of the unsharded call's; each
shard's kernels by `graph_ms` beside their bounds and SDPA with a boolean
mask (records ``flash_prefill[q_offset]`` and
``flash_prefill_bwd[q_offset]``, counted on (an) itself). (ao) holds
granite-moe-3b-a800m's training attention (4 × 24 H over 8 KV: G 3, HD 64,
T 4096, causal) the same way, in the same 4 shards (records
``flash_prefill[q_offset, granite]`` and its B3-bwd twin, counted on (ao)).
(ao') runs one full-width granite MoE layer (bf16, random weights from a
seeded generator, 4 × 4096 tokens) as the 4 ranks of a (1, 4) mesh run it
under ``ep`` (`models.moe`: each rank's routing of its sequence shard, its
queue offsets from every rank's counts, its dispatch buffer, its 12
experts, its combine), in turn on one card with the collectives' results
passed by hand (`check_ep_layer`): every rank's ``topi``, ``pos`` and
``keep`` equal to the unsharded routing's rows, the output, the
load-balancing loss and every gradient within EP_LAYER_TOL of the
unsharded `moe_apply`'s; it prints the share of dropped (token, choice)
pairs. (aq) holds recurrentgemma-2b's "L" training attention (4 × 10 H over
1 KV: G 10, HD 256, T 4096, under its window of 2048) the same way as (an),
in the same 4 shards (records ``flash_prefill[q_offset, recurrentgemma]``
and its B3-bwd twin, counted on (aq)). (ap) runs one full-width SSD layer
of mamba2-2.7b and one "R" block of recurrentgemma-2b (bf16, random
weights from a seeded generator, 4 × 4096 tokens) as the 4 ranks of a
(1, 4) mesh run them (`models.ssm`, `models.rglru`: the sequence gathered,
each rank's heads or channels, the SSD norm's sum of squares and the
RG-LRU's gate partials summed over the ranks, the row-parallel partial
outputs summed), in turn on one card with the collectives' results passed
by hand (`check_tp_recurrent`): the output and every gradient within
TP_LAYER_ROUNDINGS × TP_LAYER_TOL (2^-7 once for each rank's rounded
partial) of each tensor's largest magnitude of the unsharded block's,
each reading printed in units of 2^-7 beside both sides' distances from
an f32 truth of the unsharded block.

Last, the tooling's example entry points (``examples/torch_*.py``):
(ah) ``torch_serve_longcontext --full --paged`` (its `serve`): full-width
qwen3-0.6b, int8 pool, LONG_SLOTS slots at max_seq 32768 (k 1,638, k_cap
2,048), LONG_PROMPTS of 28,000-32,700 tokens × LONG_NEW_TOKENS, graphed,
and (ah') its eager twin: greedy tokens identical (the logits rows bit for
bit are counted); each prints ms per tick, TTFT per request, launches per
tick and peak memory; (ai) the same entry point with one LONGEST_PROMPT
request at max_seq 131072, where k reaches its cap (LONGEST_K): TTFT, peak
memory during prefill, ms per tick and the printed k and k_cap, and on the
first tick's layer-0 state (`LongProbe`, `check_long_state`) B1 bit for bit
with its plain version, the selection bit for bit with the torch chain on
the CPU, B2 within its bound, B3 on layer 0's prefill operands over three
PLAIN_ROWS blocks within its one-ulp bound, and B1's and B2's times beside
`core.performance_model`'s bytes per token at that N over HBM3's rate and a
dense decode by SDPA; (aj) ``torch_quickstart`` on the card, its thresholds
and kept counts equal to the same run with the contiguous tick's kernels
replaced by their plain versions on the card (`run_plain_flat`); (ak)
``torch_ablation_selection``'s nine rows, overlap and coverage equal to the
plain versions'; (al) ``torch_train_small`` for TRAIN_SMALL_STEPS steps:
the loss falls, B3's and B3-bwd's launches printed. Phase 3 holds B1 and B2
at (ah)'s and (ai)'s pool shapes and B3 at their longest prompts (records
tagged ``[qwen3-0.6b 32k]`` / ``[qwen3-0.6b 131k]``, counted on (ah) /
(ai); `check_long_kernels`).

It prints the script's seconds in all, a ``{"kernels": [...]}`` line (each
kernel's launches on the run of its path, and ``launches_per_call`` over
every run; a record at gemma3's, granite's, recurrentgemma's, whisper's,
llava's or the long contexts' shapes counts its run's launches of its
wrapper ((r), (z), (z''), (z'''), (ab), (ac), (ac*), (ad), (ah) or (ai)),
B8's partials branch at gemma3's and granite's shapes run (v)'s) and,
last, the ``{"ok": true, "device": {...}}`` line. Without a CUDA device it exits
with code 1 and prints no result.
"""

from __future__ import annotations

import functools
from collections import Counter
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# the H100 SXM's datasheet peaks (HBM3 bytes/s; dense op/s by type), kept in one place
from repro_torch.analysis.roofline import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.analysis.roofline import PEAK_OPS  # noqa: E402

SERVE = dict(paged=True, slots=4, max_seq=8192, block_size=32)
PROMPTS = (2048, 3072, 4096, 2560)
NEW_TOKENS = 16
B2_ATOL, B2_RTOL = 1e-5, 1e-5          # f32 output (B2, B8, and B6's acc and l)
B3_ATOL, B3_RTOL = 1e-4, 2.0 ** -7     # bf16 output: one ulp of each element
SMALL_PATH_LOGIT_TOL = 3e-4
# gemma3-12b.reduced()'s small path (12 layers, rings): the same bound while
# the card's and the CPU's states hold the same int8 K/V codes; where the two
# round a stored value to adjacent codes (at most one step apart), the bound
# of the CPU parity tests for a code step (tests/_torch_bridge.py:
# CODE_STEP_TOL). The card reads 3.61e-4 paged and contiguous (85 and 65
# codes a step apart), 2.8x below; a ring that holds one wrong token (written
# a slot late, or not written) reads 0.39-0.42 on the first tick
# (scripts/torch_small_path_faults.py; PERF.md)
SMALL_PATH_CODE_STEP_TOL = 1e-3
# contiguous vs paged logits for one history, in bf16 ulps of the top
# logit: the card reads at most 15.75 on every row; faults injected into
# one slot (an append dropped or written a row early, a gather reading the
# neighbouring rows) read 37-106 (PERF.md)
CONTIG_LOGIT_ULPS = 24
# the host tier on the small path: 8 blocks for prompts of 5, 7 and 6 blocks
SMALL_SPILL = dict(kv_pool_dtype="int4", host_spill=True, num_blocks=8, demote_after=1,
                   spill_keep_recent=2)
# the host tier at full width: 200 blocks for the requests' 370, so that the
# 4096-token prompt (128 blocks) admits in waves after pressure demotion
# (SpillProbe; PERF.md)
SPILL_RUN = dict(kv_pool_dtype="int4", host_spill=True, num_blocks=200, demote_after=1,
                 spill_keep_recent=48)
# prefix sharing at full width: a 2048-token prefix (64 blocks) and tails of
# 522, so every prompt is 2570 tokens (cuBLAS sees the same prefill shapes
# in the shared run and its twin) and ends in a partial block (2570 =
# 80·32 + 10): the repeated prompt's first decode write is copied on write.
# 128 blocks; the unshared twin needs 4 × 81 = 324.
SHARED_PREFIX, SHARED_TAIL, SHARED_BLOCKS = 2048, 522, 128
# shared 64 + 64 + 81, one hit per later request, one copy; peak 81 + 17 +
# 17 + 0 + the copy
SHARED_COUNTS = dict(shared_blocks=209, prefix_hits=3, cow_copies=1,
                     effective_blocks_saved=208, peak_blocks_in_use=116)
# continuous batching at full width: the model with salca_static_channels,
# the main path's prompts (64, 96, 128 and 80 blocks of 32) and SCHED_NEW
# new tokens, so that request 0's growth crosses a second block boundary
# (positions 2048 and 2080) mid-run. SCHED_CHUNK is a multiple of B3's
# 64-row query tile; it leaves ragged last chunks on 2048, 4096 and 2560.
SCHED_NEW, SCHED_CHUNK, SCHED_LATE_TICK = 40, 384, 5
# (c) monolithic admission: 64 + 96 + 128 blocks fill the pool, request 3
# waits; the first tick's growth (request 0 at 2048) preempts request 2, an
# active request with one recorded token
SCHED_PREEMPT_BLOCKS = 288
# (d) chunked: requests 0 and 1 active on 65 + 97 blocks, request 2's ten
# chunks take the last 120 and its eleventh stalls; request 0's growth at
# 2080 finds the pool dry and preempts the in-flight prefill
SCHED_CHUNK_PREEMPT_BLOCKS = 282
# the persistent prefix cache at full width: the model with
# salca_static_channels and an int8 pool; two tenants with distinct
# CACHE_HEADER-token headers (64 blocks), each with two users whose distinct
# CACHE_TAIL-token tails make 2570-token prompts (81 blocks, a partial last
# block); CACHE_VISITS goes twice over the four prompts, tenant-major, each
# request submitted alone once the engine drained
CACHE_HEADER, CACHE_TAIL = 2048, 522
CACHE_VISITS = (0, 1, 2, 3, 0, 1, 2, 3)
# the counts the LRU rules give (PERF.md, PR 24): (l) on 256 blocks keeps
# every pin (64 + 17 + 81 + 17 = 196 at the peak), hits the header twice in
# the first pass and each prompt whole in the second (2·64 + 4·81 blocks);
# (m) on 128 blocks evicts 51 or 17 pins before each admission from the
# third on, so the second pass hits 30 or 64 blocks and never a whole
# prompt; (n) = (m) with the host tier demotes those pins instead and
# rehydrates them on the second pass's whole hits
CACHE_COUNTS = {
    "l": dict(cache_hits=6, cache_hit_blocks=452, zero_prefill_hits=4, cache_evictions=0,
              peak_cache_blocks=196, prefix_hits=0, cow_copies=0),
    "m": dict(cache_hits=6, cache_hit_blocks=316, zero_prefill_hits=0, cache_evictions=204,
              peak_cache_blocks=128, prefix_hits=0, cow_copies=0),
    "n": dict(cache_hits=6, cache_hit_blocks=452, zero_prefill_hits=4, cache_evictions=0,
              peak_cache_blocks=128, prefix_hits=0, cow_copies=0, demotions=204,
              promotions=136),
}
CACHE_BLOCKS, CACHE_TIGHT_BLOCKS = 256, 128
# the reference's gate: the second pass's median TTFT over the first's
CACHE_TTFT_RATIO = 0.6
# The other dense configs (phase 4's runs (r)-(u)): gemma3-12b on SERVE with
# the main path's prompts, each longer than its window of 1024 (every ring
# wraps); qwen3-8b and phi3-medium-14b on DENSE_SLOTS slots, DENSE_PROMPTS ×
# DENSE_NEW_TOKENS
GEMMA = "gemma3-12b"
# the MoE family (runs (z) to (z''')): granite-moe-3b-a800m at full width
GRANITE = "granite-moe-3b-a800m"
# the recurrent families: mamba2 (64 SSD layers, no attention) and
# recurrentgemma ("RRL": 18 RG-LRU layers, 8 local-attention layers of 2048)
MAMBA, RGEMMA = "mamba2-2.7b", "recurrentgemma-2b"
WHISPER, LLAVA = "whisper-small", "llava-next-mistral-7b"
# run (ac), whisper-small at full width through its model API: a request
# is ENC_FRAMES random frames (the decode_32k length of the JAX package's
# configs/shapes.py) and a decoder prompt of ENC_PROMPTS tokens, one slot
# each, ENC_NEW_TOKENS new tokens
ENC_FRAMES, ENC_PROMPTS, ENC_NEW_TOKENS = 32768, (4, 8, 12, 16), 32
# run (ad), llava-next-mistral-7b at full width through its model API:
# VLM_REQUESTS requests of the config's 2880 patch rows and VLM_TEXT text
# tokens on a contiguous pool of VLM_MAX_SEQ rows, VLM_NEW_TOKENS new
# tokens; then (ad'') the text-only paged engine on VLM_TEXT_PROMPTS
VLM_REQUESTS, VLM_TEXT, VLM_NEW_TOKENS, VLM_MAX_SEQ = 2, 192, 16, 4096
VLM_TEXT_PROMPTS, VLM_TEXT_NEW_TOKENS = (1024, 2048), 8
# the plain version of B3 over all rows of a 32768-token attention runs in
# blocks of this many query rows (each row depends on its own query only)
PLAIN_ROWS = 1024
# B3's records check every row against the plain version up to this prompt
# length; a longer prompt checks three PLAIN_ROWS blocks (`b3_causal_blocks`)
PLAIN_WHOLE_ROWS = 8192
DENSE_ARCHS = ("qwen3-8b", "phi3-medium-14b")
DENSE_SLOTS, DENSE_PROMPTS, DENSE_NEW_TOKENS = 2, (2048, 3072), 8
# run (x)'s new tokens (gemma3-12b with full-context window layers)
RING_OFF_NEW_TOKENS = 8
# the tick of each of these runs profiled for its device time and kernel
# launches: a replay where the tick is graphed (the third tick on)
PROFILE_TICK = 4


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def events_ms(fn, iters: int) -> float:
    """Mean time of ``fn`` on the device timeline (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Device time per call of ``fn`` without a profiler session: CUDA events
    around one replay of a CUDA graph of ``iters`` calls (no host launch gap
    between the calls; each graph node adds ~1 µs). The capture's wrapper
    launch counts are taken back out of `LAUNCHES`."""
    from collections import Counter

    import torch
    from repro_torch.kernels.common import LAUNCHES
    fn()
    torch.cuda.synchronize()
    before = Counter(LAUNCHES)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    LAUNCHES.clear()
    LAUNCHES.update(before)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# A profiler session whose launches sit at its very edges can lose them from
# the trace (seen after phase 3's checks: ``scripts/torch_profiler_coverage.py``),
# so each session idles this long before its first launch and after its last;
# a trace that still holds too few launches is taken again, at most this often.
PROFILE_IDLE_S = 0.05
PROFILE_ATTEMPTS = 3


def _profiled(fn, kernel_name: str, launches: int, read):
    """``read(prof)`` of a CUDA profiler session over ``launches`` calls of
    ``fn``. A session whose ``read`` gives None (the trace lost launches) is
    taken again, with a line on stdout, at most PROFILE_ATTEMPTS times in
    all; raises when none gave a value."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_IDLE_S)
            for _ in range(launches):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_IDLE_S)
        value = read(prof)
        if value is not None:
            return value
        print(f"profiler: session {attempt + 1} lost launches of {kernel_name}", flush=True)
    raise RuntimeError(f"the profiler's trace held too few launches of {kernel_name} "
                       f"in {PROFILE_ATTEMPTS} sessions")


def kernel_ms(fn, kernel_name: str, iters: int) -> float:
    """Device time per launch of the CUDA kernel named ``kernel_name``, from
    the profiler's trace of ``iters`` calls of ``fn``, which must hold a
    launch with device time for each call."""
    def per_launch(prof):
        total_us, launches = 0.0, 0
        for e in prof.key_averages():
            if kernel_name in e.key:
                total_us += (getattr(e, "device_time_total", 0)
                             or getattr(e, "cuda_time_total", 0))
                launches += e.count
        return total_us / launches / 1e3 if launches >= iters and total_us > 0 else None
    return _profiled(fn, kernel_name, iters, per_launch)


# written between the calls of a cold-L2 timing: more than the H100's 50 MB L2
L2_FLUSH_BYTES = 64 << 20


def cold_kernel_ms(fn, kernel_name: str, iters: int) -> float:
    """`kernel_ms` of ``fn`` with the L2 cache flushed before each call: an
    L2_FLUSH_BYTES buffer is written between the calls (its fill kernel is
    not counted: `kernel_ms` reads ``kernel_name``'s launches only)."""
    import torch
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")

    def cold():
        flush.fill_(1)
        fn()
    return kernel_ms(cold, kernel_name, iters)


def kernel_ctas(fn, kernel_name: str) -> int:
    """CTAs of one launch of the CUDA kernel named ``kernel_name``: the
    product of the grid that the profiler's trace of one call of ``fn``
    records for it."""
    import os
    import tempfile

    def ctas(prof):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        grids = [e["args"]["grid"] for e in events
                 if str(e.get("cat", "")).lower() == "kernel"
                 and kernel_name in e.get("name", "") and "grid" in e.get("args", {})]
        return int(np.prod(grids[0])) if grids else None
    return _profiled(fn, kernel_name, 1, ctas)


def record_timers(tag: str):
    """(time, ctas, cold time) of a phase-3 record: the profiler's for the
    main path's shapes; for another model's shapes (``tag``) `graph_ms`, no
    CTA count and no cold time, because after the main path's ~40 profiler
    sessions later ones lost their launches."""
    if not tag:
        return kernel_ms, kernel_ctas, cold_kernel_ms
    return (lambda fn, name, n: graph_ms(fn, n), lambda fn, name: None,
            lambda fn, name, n: None)


def with_graph_ms(rec: dict, fn, iters: int) -> dict:
    """Gives ``rec`` a `graph_ms` time, so that records timed by the profiler
    and by `graph_ms` compare like for like: a tagged record's ``ms`` is one;
    for the others (``name`` = ``counter``) ``fn`` is kept under ``_graph``
    and timed once every profiler session of phase 3 is over (`main`)."""
    if rec["name"] != rec["counter"]:
        rec["graph_ms"] = rec["ms"]
    else:
        rec["_graph"] = (fn, iters)
    return rec


def b2_yardstick(qr, pool, pblk, counts, bmask, kv, mode, iters) -> dict:
    """B2's yardstick, timed for the table and used nowhere in the port: one
    scaled_dot_product_attention call over each row's listed blocks (the
    lists cut to the longest one), gathered and dequantized beforehand (int4
    unpacked, per-block scales broadcast), with the block masks as
    attn_mask — alone, and with the gather and the dequantization."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.quantization import unpack_int4
    bh, g, hd = qr.shape
    bs, nsb = pool.k_codes.shape[1], int(counts.max())
    pblk, bmask = pblk[:, :nsb], bmask[:, :nsb]
    dev = qr.device
    kvb = (torch.arange(bh, device=dev) % kv)[:, None, None]
    tok = torch.arange(bs, device=dev)[None, None, :]
    stok = tok if mode == "int8" else torch.zeros_like(tok)
    qq = qr.reshape(bh, 1, g, hd)
    am = bmask.reshape(bh, 1, 1, nsb * bs)

    def gather():
        pb = pblk.long()[:, :, None]
        out = []
        for codes, scale in ((pool.k_codes, pool.k_scale), (pool.v_codes, pool.v_scale)):
            c = codes[pb, tok, kvb]
            c = unpack_int4(c) if mode == "int4" else c
            out.append((c.float() * scale[pb, stok, kvb][..., None]).reshape(bh, 1, nsb * bs, hd))
        return out

    kd, vd = gather()
    return dict(
        library_ms=events_ms(lambda: F.scaled_dot_product_attention(qq, kd, vd, attn_mask=am),
                             iters),
        library_call="scaled_dot_product_attention over the listed blocks, gathered and "
                     "dequantized beforehand (not timed)",
        library_with_gather_ms=events_ms(
            lambda: F.scaled_dot_product_attention(qq, *gather(), attn_mask=am), iters))


def sass_tensor_core_count(name: str) -> int:
    """Lines of the SASS of kernel library ``name`` that hold a tensor-core
    instruction (HMMA, HGMMA), from ``cuobjdump -sass``."""
    from repro_torch.kernels import common
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(common.BUILD_DIR / f"lib{name}.so")],
                         capture_output=True, text=True, check=True, timeout=120).stdout
    return sum(1 for line in out.splitlines() if "HMMA" in line or "HGMMA" in line)


def bound(bytes_moved: float, ops: float, kind: str) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def random_pool(dev, gen, cfg, slots, max_seq, block_size, lengths, kv_pool_dtype="int8"):
    """A paged pool at the serving shapes with random contents in storage
    mode ``kv_pool_dtype``: slot s holds ``lengths[s]`` tokens over
    scrambled physical blocks (int4: any byte is a pair of nibbles)."""
    import torch
    from repro_torch.core.cache import empty_paged_cache
    from repro_torch.models.blocks import salca_params_for
    hd, kv = cfg.resolved_head_dim, cfg.num_kv_heads
    r = salca_params_for(cfg, max_seq).r(hd)
    mb = max_seq // block_size
    nb = slots * mb
    pool = empty_paged_cache(nb, block_size, slots, mb, kv, hd, r, kv_pool_dtype=kv_pool_dtype,
                             device=dev)
    d = pool.data
    for f in ("k_codes", "v_codes"):
        if kv_pool_dtype == "fp16":
            d[f].copy_(torch.randn(d[f].shape, generator=gen, device=dev))
        else:
            d[f].copy_(torch.randint(-127, 128, d[f].shape, generator=gen, device=dev,
                                     dtype=torch.int8))
    d["feat_words"].copy_(torch.randint(-2 ** 31, 2 ** 31 - 1, d["feat_words"].shape,
                                        generator=gen, device=dev, dtype=torch.int32))
    for f in ("k_scale", "v_scale", "feat_scale"):
        if kv_pool_dtype != "fp16" or f == "feat_scale":      # fp16: unit scales
            d[f].copy_(torch.rand(d[f].shape, generator=gen, device=dev) * 0.02 + 1e-3)
    d["feat_zero"].copy_(torch.randn(d["feat_zero"].shape, generator=gen, device=dev))
    perm = torch.randperm(nb, generator=gen, device=dev).to(torch.int32)
    for s, n in enumerate(lengths):
        need = -(-n // block_size)
        pool.page_table[s, :need] = perm[s * mb: s * mb + need]
        pool.length[s] = n
    pool.heavy_idx.copy_(torch.sort(torch.rand((slots, kv, hd), generator=gen, device=dev)
                                    .argsort(-1)[..., :r], dim=-1).values.to(torch.int32))
    return pool


def random_cache(dev, gen, cfg, slots, max_seq, lengths):
    """A contiguous slot pool at the serving shapes with random contents:
    slot s holds ``lengths[s]`` tokens."""
    import torch
    from repro_torch.core.cache import empty_cache
    from repro_torch.models.blocks import salca_params_for
    hd, kv = cfg.resolved_head_dim, cfg.num_kv_heads
    r = salca_params_for(cfg, max_seq).r(hd)
    cache = empty_cache(slots, max_seq, kv, hd, r, device=dev)
    for f in ("k_codes", "v_codes"):
        getattr(cache, f).copy_(torch.randint(-127, 128, getattr(cache, f).shape, generator=gen,
                                              device=dev, dtype=torch.int8))
    cache.feat_words.copy_(torch.randint(-2 ** 31, 2 ** 31 - 1, cache.feat_words.shape,
                                         generator=gen, device=dev, dtype=torch.int32))
    for f in ("k_scale", "v_scale", "feat_scale"):
        getattr(cache, f).copy_(torch.rand(getattr(cache, f).shape, generator=gen, device=dev)
                                * 0.02 + 1e-3)
    cache.feat_zero.copy_(torch.randn(cache.feat_zero.shape, generator=gen, device=dev))
    cache.length.copy_(torch.tensor(lengths, dtype=torch.int32, device=dev))
    cache.heavy_idx.copy_(torch.sort(torch.rand((slots, kv, hd), generator=gen, device=dev)
                                     .argsort(-1)[..., :r], dim=-1).values.to(torch.int32))
    return cache


def check_flat_kernels(dev, cfg, lengths, iters=20, tag="", salca=None, run=None, n=None,
                       slots=None):
    """Phase 3a, the contiguous tick's kernels at its shapes on a random
    slot pool: B7 bit-identical in the tick's bf16-pinned chain and in the
    reference op's f32 chain, B9 bit-identical, B8 within
    B2_ATOL + B2_RTOL·|plain| on the selection B9 leads to. Another model's
    shapes: ``tag``, ``salca`` and ``run`` as in `check_kernels`; ``n`` the
    cache's rows and ``slots`` its slots where they are not SERVE's
    (whisper's cross stream: its T_enc; llava's image run: VLM_MAX_SEQ rows
    in VLM_REQUESTS slots)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import quantization as qz
    from repro_torch.core.attention import gather_selected
    from repro_torch.core.histogram_topk import Selection, compact_indices
    from repro_torch.core.selection import _quantized_query_groups, query_heavy_features
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.score_est import ops as se
    from repro_torch.kernels.selection_fused import ops as sf
    from repro_torch.models.blocks import salca_params_for

    timed, ctas_of, cold_of = record_timers(tag)
    gen = torch.Generator(device=dev).manual_seed(2)
    s, n = slots or SERVE["slots"], n or SERVE["max_seq"]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    bh = s * kv
    cache = random_cache(dev, gen, cfg, s, n, lengths)
    q = torch.randn((s, h, hd), generator=gen, device=dev)
    qc, qs, _ = _quantized_query_groups(query_heavy_features(q, cache.heavy_idx, h // kv), kv)
    g, r = qc.shape[2], qc.shape[3]
    recs = []

    # B7 — the tick's form, reading the cache's (B, N, KV, ·) fields in place
    b7_args = (qc, qs, cache.feat_words, cache.feat_scale, cache.feat_zero)
    scores = se.flat_score_estimate(*b7_args, bf16=True)
    _check_exact("B7 (bf16 chain)", (scores,),
                 (se.flat_score_estimate_plain(*b7_args, bf16=True),))
    # … and the reference op's form, over (BH, N, ·) copies
    op_args = (qc.reshape(bh, g, r), qs.reshape(bh, g),
               cache.feat_words.transpose(1, 2).reshape(bh, n, r // 16),
               cache.feat_scale.transpose(1, 2).reshape(bh, n),
               cache.feat_zero.transpose(1, 2).reshape(bh, n))
    _check_exact("B7 (f32 chain)", (se.score_estimate(*op_args),),
                 (se.score_estimate_plain(*op_args),))
    b7_bytes = (s * n * kv * (r // 16 * 4 + 8)                 # words, scale, zero
                + qc.numel() + 4 * qs.numel() + 4 * scores.numel())
    bms, bby = bound(b7_bytes, 2 * bh * g * n * r, "int8")
    recs.append(with_graph_ms(dict(
        name="score_estimate" + tag, counter="score_estimate", route="cuda",
        source="src/repro_torch/csrc/score_est.cu",
        replaces="src/repro/kernels/score_est/kernel.py:54",
        launches=None, max_abs_err=0.0,
        tolerance="bit-identical (bf16 and f32 chains)", err_over_tol=0.0,
        ms=timed(lambda: se.flat_score_estimate(*b7_args), "flat_score_kernel", iters),
        cold_ms=cold_of(lambda: se.flat_score_estimate(*b7_args), "flat_score_kernel", iters),
        f32_chain_ms=timed(lambda: se.score_estimate(*op_args), "flat_score_kernel", iters),
        plain_ms=events_ms(lambda: se.flat_score_estimate_plain(*b7_args), max(2, iters // 10)),
        bound_ms=bms, bound_by=bby, library_ms=None,
        ctas=ctas_of(lambda: se.flat_score_estimate(*b7_args), "flat_score_kernel"),
        **({"run": run} if run else {})), lambda: se.flat_score_estimate(*b7_args), iters))

    # B9 — on the bounds and cleaned offset `fused_select_flat` passes it
    params = salca or salca_params_for(cfg, n)
    w = params.pool_window
    valid = torch.arange(n, device=dev)[None, :] < cache.length[:, None]
    sm = qz.masked_scores(scores, valid[:, None, :])
    lo, hi = qz.score_bounds(sm)
    offset, _ = qz.binning_affine(lo, hi)
    b9_args = (sm.reshape(bh, n), offset.reshape(-1).contiguous(), hi.reshape(-1).contiguous(),
               torch.full((bh,), params.k, dtype=torch.int32, device=dev),
               cache.length.repeat_interleave(kv))
    out9 = sf.fused_bin_pool_threshold(*b9_args, window=w)
    _check_exact("B9", out9, sf.fused_bin_pool_threshold_plain(*b9_args, window=w))
    # what these operands need: the scores below each row's length, the row
    # parameters (lo, hi, k, length), the pooled bins, histogram and threshold
    n_valid = int(b9_args[4].clamp(0, n).sum())
    b9_bytes = 4 * n_valid + 16 * bh + bh * n + 4 * out9[1].numel() + 4 * bh
    bms, bby = bound(b9_bytes, n_valid * (w + 8), "f32")    # bin, pool, count
    recs.append(with_graph_ms(dict(
        name="fused_bin_pool_threshold" + tag, counter="fused_bin_pool_threshold",
        route="cuda", source="src/repro_torch/csrc/selection_fused.cu",
        replaces="src/repro/kernels/selection_fused/kernel.py:90",
        launches=None, max_abs_err=0.0, tolerance="bit-identical", err_over_tol=0.0,
        ms=timed(lambda: sf.fused_bin_pool_threshold(*b9_args, window=w),
                 "fused_bin_pool_threshold_kernel", iters),
        cold_ms=cold_of(lambda: sf.fused_bin_pool_threshold(*b9_args, window=w),
                        "fused_bin_pool_threshold_kernel", iters),
        plain_ms=events_ms(lambda: sf.fused_bin_pool_threshold_plain(*b9_args, window=w),
                           max(2, iters // 10)),
        bound_ms=bms, bound_by=bby, library_ms=None,
        ctas=ctas_of(lambda: sf.fused_bin_pool_threshold(*b9_args, window=w),
                     "fused_bin_pool_threshold_kernel"),
        thresholds=sorted({int(t) for t in out9[2].tolist()}), **({"run": run} if run else {})),
        lambda: sf.fused_bin_pool_threshold(*b9_args, window=w), iters))

    # B8 — over the rows that selection gathers
    keep = out9[0] >= out9[2][:, None].to(torch.uint8)
    sel = Selection(*compact_indices(keep.reshape(s, kv, n), params.k_cap),
                    out9[2].reshape(s, kv))
    kc, ks, vc, vs = gather_selected(cache, sel)
    c = kc.shape[2]
    b8_args = (q.reshape(bh, h // kv, hd).contiguous(), kc.reshape(bh, c, hd),
               ks.reshape(bh, c), vc.reshape(bh, c, hd), vs.reshape(bh, c),
               sel.mask.reshape(bh, c))
    out8 = fd.sparse_flash_decode(*b8_args)
    plain8 = fd.sparse_flash_decode_plain(*b8_args)
    err8 = float((out8 - plain8).abs().max())
    ratio8 = float(((out8 - plain8).abs() / (B2_ATOL + B2_RTOL * plain8.abs())).max())
    if not ratio8 <= 1.0:
        raise AssertionError(f"B8: |kernel - plain| reaches {ratio8:.3g}x its bound "
                             f"{B2_ATOL:g} + {B2_RTOL:g}·|plain| (max abs err {err8})")
    live = int(sel.mask.sum())
    b8_bytes = live * (2 * hd + 8) + bh * c + 2 * 4 * b8_args[0].numel()
    bms, bby = bound(b8_bytes, live * (h // kv) * hd * 4, "f32")
    # the yardsticks: one SDPA call over the gathered rows, dequantized
    # beforehand, and the dequantization and the SDPA call timed together
    qq = b8_args[0].reshape(bh, 1, h // kv, hd)
    am = sel.mask.reshape(bh, 1, 1, c)

    def dequant():
        return ((kc.float() * ks[..., None]).reshape(bh, 1, c, hd),
                (vc.float() * vs[..., None]).reshape(bh, 1, c, hd))

    kd, vd = dequant()
    lib = events_ms(lambda: F.scaled_dot_product_attention(qq, kd, vd, attn_mask=am), iters)
    lib_dq = events_ms(lambda: F.scaled_dot_product_attention(qq, *dequant(), attn_mask=am),
                       iters)
    recs.append(with_graph_ms(dict(
        name="sparse_flash_decode" + tag, counter="sparse_flash_decode", route="cuda",
        source="src/repro_torch/csrc/flash_decode.cu",
        replaces="src/repro/kernels/flash_decode/kernel.py:73",
        launches=None, max_abs_err=err8,
        tolerance=f"{B2_ATOL:g} + {B2_RTOL:g}*|plain|", err_over_tol=ratio8,
        ms=timed(lambda: fd.sparse_flash_decode(*b8_args), "sparse_flash_decode_flat_kernel",
                 iters),
        plain_ms=events_ms(lambda: fd.sparse_flash_decode_plain(*b8_args), max(2, iters // 10)),
        bound_ms=bms, bound_by=bby, library_ms=lib,
        library_call="scaled_dot_product_attention on the gathered rows, "
                     "dequantized beforehand (dequantization not timed)",
        library_with_dequant_ms=lib_dq,
        ctas=ctas_of(lambda: fd.sparse_flash_decode(*b8_args), "sparse_flash_decode_flat_kernel"),
        selected_rows=live, capacity=bh * c, **({"run": run} if run else {})),
        lambda: fd.sparse_flash_decode(*b8_args), iters))

    # the contiguous tick against the paged tick on the same tokens: the
    # reference's contract makes their selections identical (B7 = B1's
    # scores, B9 = the blocked chain's bins and threshold), and their
    # outputs differ only in summation order
    from repro_torch.core.attention import salca_decode_attention, salca_decode_attention_paged
    from repro_torch.core.cache import SalcaCache, empty_paged_cache, prefill_into_pages
    bs = SERVE["block_size"]
    mb = n // bs
    pool = empty_paged_cache(s * mb, bs, s, mb, kv, hd, r, device=dev)
    perm = torch.randperm(s * mb, generator=gen, device=dev).to(torch.int32)
    for i in range(s):
        prefill_into_pages(pool, SalcaCache(*(f[i:i + 1] for f in cache)), i,
                           perm[i * mb:(i + 1) * mb])
    out_c, sel_c = salca_decode_attention(q, cache, params, return_selection=True)
    out_p, sel_p = salca_decode_attention_paged(q, pool, params, return_selection=True)
    _check_exact("contiguous vs paged tick selection", sel_c, sel_p)
    ratio = float(((out_c - out_p).abs() / (B2_ATOL + B2_RTOL * out_p.abs())).max())
    if not ratio <= 1.0:
        raise AssertionError(f"contiguous vs paged tick: outputs reach {ratio:.3g}x "
                             f"{B2_ATOL:g} + {B2_RTOL:g}·|paged|")
    print(f"contiguous vs paged tick at {tag or 'the main path'}'s shapes: selections identical "
          f"({int(sel_c.count.sum())} tokens), outputs within {ratio:.3g} of "
          f"{B2_ATOL:g} + {B2_RTOL:g}·|paged|", flush=True)
    return recs


def check_kernels(dev, cfg, lengths, prompt_len, iters=20, tag="", salca=None, sharded=True,
                  slots=None, run=None, sharded_run=None, max_seq=None):
    """Phase 3a: each kernel against its plain version on the same inputs, at
    the main path's shapes. Returns one record per kernel (launch counts are
    filled in from the main path's run). Another model's shapes: ``tag``
    ends each record's name (its ``counter`` keeps the wrapper's), ``salca``
    the tick's `SalcaParams` where they are not max_seq's (gemma3's come
    from its first layer's ring), ``sharded=False`` leaves B4-B6 out,
    ``slots`` the run's slots (one length each), ``run`` names the phase-4
    run whose launches the records count (``sharded_run`` B4-B6's),
    ``max_seq`` the pool's length where it is not SERVE's; a config with
    sliding-window layers adds B3 under its window to B3's record."""
    import torch
    from repro_torch.core.selection import (
        _quantized_query_groups, query_heavy_features, select_sparse_pattern_blocked)
    from repro_torch.flags import PERF
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.score_est import ops as se
    from repro_torch.models.blocks import salca_params_for

    timed, ctas_of, _ = record_timers(tag)
    gen = torch.Generator(device=dev).manual_seed(1)
    s, mseq, bs = slots or SERVE["slots"], max_seq or SERVE["max_seq"], SERVE["block_size"]
    home = {"run": run} if run else {}
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    pool = random_pool(dev, gen, cfg, s, mseq, bs, lengths)
    q = torch.randn((s, h, hd), generator=gen, device=dev)
    q_feat = query_heavy_features(q, pool.heavy_idx, h // kv)
    qc, qs, qsum = _quantized_query_groups(q_feat, kv)
    pages = pool.clamped_pages()
    b1_args = (qc, qs, qsum, pool.feat_words, pool.feat_scale, pool.feat_zero, pages)
    recs = []

    # B1 — bit-identical
    out = se.paged_score_estimate(*b1_args, bf16=PERF.bf16_collectives)
    plain = se.paged_score_estimate_plain(*b1_args, bf16=PERF.bf16_collectives)
    torch.cuda.synchronize()
    if not torch.equal(out, plain):
        raise AssertionError(f"B1: kernel differs from plain version on "
                             f"{int((out != plain).sum())} of {out.numel()} scores")
    ms = timed(lambda: se.paged_score_estimate(*b1_args), "paged_score_estimate_kernel", iters)
    blocks = int(torch.unique(pages).numel())
    g = qc.shape[2]
    b1_bytes = (blocks * bs * kv * (pool.feat_words.shape[-1] * 4 + 8)   # words, scale, zero
                + qc.numel() + 8 * qs.numel() + 4 * pages.numel() + 4 * out.numel())
    b1_ops = 2 * s * kv * g * pages.shape[1] * bs * qc.shape[-1]
    bms, bby = bound(b1_bytes, b1_ops, "int8")
    recs.append(with_graph_ms(dict(
        name="paged_score_estimate" + tag, counter="paged_score_estimate", route="cuda",
        source="src/repro_torch/csrc/score_est.cu",
        replaces="src/repro/kernels/score_est/kernel.py:219",
        launches=None, max_abs_err=float((out - plain).abs().max()),
        tolerance="bit-identical", err_over_tol=0.0, ms=ms,
        plain_ms=events_ms(lambda: se.paged_score_estimate_plain(*b1_args), max(2, iters // 10)),
        bound_ms=bms, bound_by=bby, library_ms=None,
        ctas=ctas_of(lambda: se.paged_score_estimate(*b1_args), "paged_score_estimate_kernel"),
        **home), lambda: se.paged_score_estimate(*b1_args), iters))

    # B2 — on the selection this query makes over this pool
    params = salca or salca_params_for(cfg, mseq)
    sel = select_sparse_pattern_blocked(out, params, pool.mapped_valid_mask()[:, None, :], bs)
    pblk, counts, bmask = fd._selected_block_plan(pool, sel)
    qr = q.reshape(s * kv, h // kv, hd).contiguous()
    b2_args = (qr, pool.k_codes, pool.k_scale, pool.v_codes, pool.v_scale, pblk, counts,
               bmask, kv)
    out2 = fd.sparse_flash_decode_paged_kernel(*b2_args)
    plain2 = fd.sparse_flash_decode_paged_plain(qr, pool.k_codes, pool.k_scale, pool.v_codes,
                                                pool.v_scale, pblk, bmask, kv)
    err2 = float((out2 - plain2).abs().max())
    # f32 on both sides, summed in other orders; the card read 6.6e-7
    ratio2 = float(((out2 - plain2).abs() / (B2_ATOL + B2_RTOL * plain2.abs())).max())
    if not ratio2 <= 1.0:
        raise AssertionError(f"B2: |kernel - plain| reaches {ratio2:.3g}x its bound "
                             f"{B2_ATOL:g} + {B2_RTOL:g}·|plain| (max abs err {err2})")
    ms = timed(lambda: fd.sparse_flash_decode_paged_kernel(*b2_args),
               "sparse_flash_decode_paged_kernel", iters)
    live = int(counts.sum())
    b2_bytes = (live * bs * (2 * hd + 8) + 2 * qr.numel() * 4 + 4 * counts.numel()
                + live * (4 + bs))
    b2_ops = live * bs * (h // kv) * hd * 4
    bms, bby = bound(b2_bytes, b2_ops, "f32")
    recs.append(with_graph_ms(dict(name="sparse_flash_decode_paged" + tag,
                     counter="sparse_flash_decode_paged", route="cuda",
                     source="src/repro_torch/csrc/flash_decode.cu",
                     replaces="src/repro/kernels/flash_decode/kernel.py:207",
                     launches=None, max_abs_err=err2,
                     tolerance=f"{B2_ATOL:g} + {B2_RTOL:g}*|plain|", err_over_tol=ratio2, ms=ms,
                     plain_ms=events_ms(lambda: fd.sparse_flash_decode_paged_plain(
                         qr, pool.k_codes, pool.k_scale, pool.v_codes, pool.v_scale, pblk,
                         bmask, kv), max(2, iters // 10)),
                     bound_ms=bms, bound_by=bby,
                     **b2_yardstick(qr, pool, pblk, counts, bmask, kv, "int8", iters),
                     ctas=ctas_of(lambda: fd.sparse_flash_decode_paged_kernel(*b2_args),
                                  "sparse_flash_decode_paged_kernel"),
                     selected_blocks=live, rows=int(counts.numel()), **home),
        lambda: fd.sparse_flash_decode_paged_kernel(*b2_args), iters))
    if sharded:
        recs += check_sharded_kernels(dev, pool, q, b1_args, params, iters, tag, sharded_run)
    del pool

    recs.append(b3_record(dev, gen, cfg, prompt_len, iters, tag, home))
    return recs


def b3_record(dev, gen, cfg, prompt_len, iters=20, tag="", home=None) -> dict:
    """Phase 3a's B3 record: one layer's bf16 prefill attention of a
    ``prompt_len``-token prompt at ``cfg``'s heads (H query heads over KV,
    any group count), causal, against its plain version (the one-ulp
    bound), its time, bound, TFLOP/s and SDPA's time; a config with
    sliding-window layers adds B3 under its window (`b3_windowed`).
    ``home`` ({"run": name}) names the phase-4 run that counts its
    launches."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_prefill import ops as fp
    timed, _, _ = record_timers(tag)
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    t = prompt_len
    q3 = torch.randn((h, t, hd), generator=gen, device=dev).to(torch.bfloat16)
    k3 = torch.randn((kv, t, hd), generator=gen, device=dev).to(torch.bfloat16)
    v3 = torch.randn((kv, t, hd), generator=gen, device=dev).to(torch.bfloat16)
    out3 = fp.flash_attention(q3, k3, v3)
    if t <= PLAIN_WHOLE_ROWS:
        plain3 = fp.flash_attention_plain(q3, k3, v3)
        diff3 = (out3.float() - plain3.float()).abs()
        err3 = float(diff3.max())
        # both sides work in f32 and round once to bf16, so an element may
        # differ by one bf16 ulp of itself (<= 2^-7 |x|); a dropped key tile
        # or a wrong rescale moves the late rows (|x| ~ 0.02) by far more
        ratio3 = float((diff3 / (B3_ATOL + B3_RTOL * plain3.float().abs())).max())
        plain_fn, plain_call = (lambda: fp.flash_attention_plain(q3, k3, v3)), {}
        del plain3, diff3
    else:               # the whole score matrix would not fit: three row blocks
        err3, ratio3 = b3_causal_blocks(q3, k3, v3, out3)
        plain_fn = functools.partial(b3_causal_blocks, q3, k3, v3, out3, (0,))
        plain_call = {"plain_call": f"flash_attention_plain over the query rows [0, "
                                    f"{PLAIN_ROWS}), by kv head (three such blocks checked: "
                                    "first, middle, last)"}
    del out3
    if not ratio3 <= 1.0:
        raise AssertionError(f"B3: |kernel - plain| reaches {ratio3:.3g}x its bound "
                             f"{B3_ATOL:g} + 2^-7·|plain| (max abs err {err3})")
    ms = timed(lambda: fp.flash_attention(q3, k3, v3), "flash_prefill_bf16_kernel",
               max(2, iters // 4))
    kr = k3.repeat_interleave(h // kv, 0)[None]
    vr = v3.repeat_interleave(h // kv, 0)[None]
    lib = events_ms(lambda: F.scaled_dot_product_attention(q3[None], kr, vr, is_causal=True),
                    max(2, iters // 4))
    b3_bytes = 2 * (2 * q3.numel() + k3.numel() + v3.numel())
    b3_ops = 4 * hd * h * t * (t + 1) // 2
    bms, bby = bound(b3_bytes, b3_ops, "bf16")
    hmma = sass_tensor_core_count("flash_prefill")
    if hmma < 1:
        raise AssertionError("B3: the SASS of libflash_prefill.so holds no HMMA/HGMMA")
    windowed = {}
    if cfg.local_window:
        windowed = b3_windowed(q3, k3, v3, cfg.local_window, iters)
    return with_graph_ms(dict(name="flash_prefill" + tag, counter="flash_prefill",
                     route="cuda",
                     source="src/repro_torch/csrc/flash_prefill.cu",
                     replaces="src/repro/kernels/flash_prefill/kernel.py:98",
                     launches=None, max_abs_err=err3,
                     tolerance=f"{B3_ATOL:g} + 2^-7*|plain|", err_over_tol=ratio3, ms=ms,
                     plain_ms=events_ms(plain_fn, 2), **plain_call,
                     bound_ms=bms, bound_by=bby, library_ms=lib,
                     tflops=b3_ops / ms / 1e9, ms_over_library=ms / lib,
                     sass_tensor_core_instructions=hmma, groups=h // kv, **windowed,
                     **(home or {})),
        lambda: fp.flash_attention(q3, k3, v3), max(2, iters // 4))


def b3_causal_blocks(q3, k3, v3, out3, starts=None) -> tuple[float, float]:
    """B3's causal rows against the plain version over blocks of PLAIN_ROWS
    query rows — by default the first, a middle and the last block of the
    prompt: the block [a, a + PLAIN_ROWS) over keys [0, a + PLAIN_ROWS) at
    ``q_offset`` a, one kv head's query group at a time (a block's scores
    over 131k keys take 0.5 GB a head). Returns (max abs err, max of |err|
    over B3's one-ulp bound)."""
    from repro_torch.kernels.flash_prefill import ops as fp
    h, t, _ = q3.shape
    kv = k3.shape[0]
    g = h // kv
    if starts is None:
        starts = (0, (t // 2 // PLAIN_ROWS) * PLAIN_ROWS, t - PLAIN_ROWS)
    err = ratio = 0.0
    for a in starts:
        e = a + PLAIN_ROWS
        for j in range(kv):
            ref = fp.flash_attention_plain(q3[j * g:(j + 1) * g, a:e], k3[j:j + 1, :e],
                                           v3[j:j + 1, :e], q_offset=a).float()
            diff = (out3[j * g:(j + 1) * g, a:e].float() - ref).abs()
            err = max(err, float(diff.max()))
            ratio = max(ratio, float((diff / (B3_ATOL + B3_RTOL * ref.abs())).max()))
    return err, ratio


def b3_windowed(q3, k3, v3, window: int, iters: int) -> dict:
    """B3 as a sliding-window layer runs it (keys kpos > qpos - window):
    against its plain version (B3's one-ulp bound), its time, its bound from
    the pairs the window keeps, and SDPA with the same boolean mask (B3 by
    `graph_ms`, SDPA by CUDA events)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_prefill import ops as fp
    h, t, hd = q3.shape
    kv = k3.shape[0]
    out = fp.flash_attention(q3, k3, v3, window=window)
    plain = fp.flash_attention_plain(q3, k3, v3, window=window)
    diff = (out.float() - plain.float()).abs()
    ratio = float((diff / (B3_ATOL + B3_RTOL * plain.float().abs())).max())
    if not ratio <= 1.0:
        raise AssertionError(f"B3 (window {window}): |kernel - plain| reaches {ratio:.3g}x "
                             f"its bound (max abs err {float(diff.max())})")
    ms = graph_ms(lambda: fp.flash_attention(q3, k3, v3, window=window), max(2, iters // 4))
    i = torch.arange(t, device=q3.device)
    mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    kr = k3.repeat_interleave(h // kv, 0)[None]
    vr = v3.repeat_interleave(h // kv, 0)[None]
    lib = events_ms(lambda: F.scaled_dot_product_attention(q3[None], kr, vr, attn_mask=mask),
                    max(2, iters // 4))
    pairs = int(torch.clamp_max(i + 1, window).sum())
    bms, bby = bound(2 * (2 * q3.numel() + k3.numel() + v3.numel()), 4 * hd * h * pairs, "bf16")
    return dict(window=window, window_ms=ms, window_max_abs_err=float(diff.max()),
                window_err_over_tol=ratio, window_bound_ms=bms, window_bound_by=bby,
                window_library_ms=lib, window_tflops=4 * hd * h * pairs / ms / 1e9)


def check_b3_offsets(dev, cfg) -> list:
    """B3 at ``cfg``'s head dim in both branches, each against its plain
    version: f32 causal, under the config's window and at ``q_offset`` > 0
    (the f32 contract: 1e-5 + 1e-5·|plain|), and bf16 chunks at ``q_offset``
    > 0 over a longer key buffer, causal and windowed (the one-ulp bound).
    Returns one line per case."""
    import torch
    from repro_torch.kernels.flash_prefill import ops as fp
    h, kv, hd, w = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.local_window
    gen = torch.Generator(device=dev).manual_seed(11)
    lines = []
    for dtype, t, window, q_offset in ((torch.float32, 1100, 0, 0), (torch.float32, 1100, w, 0),
                                       (torch.float32, 500, 0, 600),
                                       (torch.bfloat16, 1024, 0, 2048),
                                       (torch.bfloat16, 1024, w, 3072)):
        q = torch.randn((h, t, hd), generator=gen, device=dev).to(dtype)
        k, v = (torch.randn((kv, t + q_offset, hd), generator=gen, device=dev).to(dtype)
                for _ in range(2))
        got = fp.flash_attention(q, k, v, window=window, q_offset=q_offset).float()
        want = fp.flash_attention_plain(q, k, v, window=window, q_offset=q_offset).float()
        atol, rtol = (1e-5, 1e-5) if dtype == torch.float32 else (B3_ATOL, B3_RTOL)
        ratio = float(((got - want).abs() / (atol + rtol * want.abs())).max())
        label = (f"B3 HD {hd} {str(dtype).split('.')[-1]} T={t} window={window} "
                 f"q_offset={q_offset}")
        if not ratio <= 1.0:
            raise AssertionError(f"{label}: |kernel - plain| reaches {ratio:.3g}x its bound "
                                 f"{atol:g} + {rtol:g}·|plain|")
        lines.append(f"{label}: max abs err {float((got - want).abs().max()):.3g}, "
                     f"{ratio:.3g} of the bound {atol:g} + {rtol:g}·|plain|")
    return lines


def _check_exact(name, got, want):
    import torch
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, want)):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: output {i} differs on "
                                 f"{int((a != b).sum())} of {a.numel()} elements")


def check_sharded_kernels(dev, pool, q, b1_args, params, iters, tag="", run=None):
    """Phase 3a, the block-sharded tick's kernels at one rank on the main
    path's pool and query: B4 and B5 bit-identical, B6 within
    B2_ATOL + B2_RTOL·scale on acc, m and l. Another model's shapes:
    ``tag`` and ``run`` as in `check_kernels` (timed by `graph_ms`)."""
    import torch
    from repro_torch.core import histogram_topk as ht
    from repro_torch.core import quantization as qz
    from repro_torch.flags import PERF
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.score_est import ops as se
    from repro_torch.kernels.selection_fused import ops as sf
    s, bs = SERVE["slots"], SERVE["block_size"]
    kv, hd, mb = pool.num_kv_heads, pool.head_dim, pool.max_blocks
    n = mb * bs
    recs = []
    kernel_ms, kernel_ctas, cold_kernel_ms = record_timers(tag)
    home = {"run": run} if run else {}

    # B4 — at one rank every mapped, stored position is owned and valid
    pos = torch.arange(n, device=dev).reshape(mb, bs)
    blk_valid = (pool.page_table >= 0)[..., None] & (pos[None] < pool.length[:, None, None])
    b4_args = b1_args + (blk_valid,)
    out4 = se.paged_score_bounds(*b4_args, bf16=PERF.bf16_collectives)
    _check_exact("B4", out4, se.paged_score_bounds_plain(*b4_args, bf16=PERF.bf16_collectives))
    qc, pages = b1_args[0], b1_args[6]
    blocks = int(torch.unique(pages).numel())
    b4_bytes = (blocks * bs * kv * (pool.feat_words.shape[-1] * 4 + 8)
                + qc.numel() + 8 * qc.shape[0] * qc.shape[1] * qc.shape[2]
                + 4 * pages.numel() + blk_valid.numel() + 4 * out4[0].numel() + 8 * s * kv)
    b4_ops = 2 * s * kv * qc.shape[2] * mb * bs * qc.shape[-1]
    bms, bby = bound(b4_bytes, b4_ops, "int8")
    recs.append(dict(name="paged_score_bounds" + tag, counter="paged_score_bounds", route="cuda",
                     source="src/repro_torch/csrc/score_est.cu",
                     replaces="src/repro/kernels/score_est/kernel.py:164",
                     launches=None, max_abs_err=0.0, tolerance="bit-identical",
                     err_over_tol=0.0,
                     ms=kernel_ms(lambda: se.paged_score_bounds(*b4_args),
                                  "paged_score_bounds_kernel", iters),
                     plain_ms=events_ms(lambda: se.paged_score_bounds_plain(*b4_args),
                                        max(2, iters // 10)),
                     bound_ms=bms, bound_by=bby, library_ms=None,
                     ctas=kernel_ctas(lambda: se.paged_score_bounds(*b4_args),
                                      "paged_score_bounds_kernel"), **home))
    # a property of the operands, not a reading of the kernel: B4 reads no
    # feature of a block whose validity row is all zero
    print(f"B4 operands: invalid_block_share="
          f"{float((~blk_valid.any(-1)).float().mean()):.6g} of {blk_valid.shape[0] * mb} "
          f"(slot, block) pairs", flush=True)

    # B5 — halo columns as the one-rank all-reduce leaves them: each block's
    # neighbours' edge bins under the global affine
    sm, lo, hi = out4
    w = params.pool_window
    halo = w // 2
    bins = qz.bins_from_bounds(sm, lo, hi, blk_valid.reshape(s, 1, n)).reshape(s, kv, mb, bs)
    zero = torch.zeros((s, kv, 1, halo), dtype=torch.uint8, device=dev)
    from_left = torch.cat([zero, bins[..., :-1, -halo:]], dim=-2).contiguous()
    from_right = torch.cat([bins[..., 1:, :halo], zero], dim=-2).contiguous()
    force = torch.zeros((s, mb, bs), dtype=torch.bool, device=dev)    # no sink/recent
    b5_args = (sm.reshape(s, kv, mb, bs), lo, hi, from_left, from_right, blk_valid, force)
    out5 = sf.paged_fused_select(*b5_args, window=w)
    _check_exact("B5", out5, sf.paged_fused_select_plain(*b5_args, window=w))
    # what these operands need read: every validity byte; scores and force
    # bytes at valid positions, halo columns of blocks with a valid position
    n_valid, n_live = int(blk_valid.sum()), int(blk_valid.any(-1).sum())
    b5_bytes = (blk_valid.numel() + n_valid * (4 * kv + 1) + 2 * halo * kv * n_live
                + 8 * s * kv + out5[0].numel() + 4 * out5[1].numel())
    b5_ops = n_valid * kv * (w + 8)      # bin (5 f32 ops), pool (w max), force, count
    bms, bby = bound(b5_bytes, b5_ops, "f32")
    recs.append(dict(name="paged_fused_select" + tag, counter="paged_fused_select", route="cuda",
                     source="src/repro_torch/csrc/selection_fused.cu",
                     replaces="src/repro/kernels/selection_fused/kernel.py:188",
                     launches=None, max_abs_err=0.0, tolerance="bit-identical",
                     err_over_tol=0.0,
                     ms=kernel_ms(lambda: sf.paged_fused_select(*b5_args, window=w),
                                  "paged_fused_select_kernel", iters),
                     cold_ms=cold_kernel_ms(lambda: sf.paged_fused_select(*b5_args, window=w),
                                            "paged_fused_select_kernel", iters),
                     plain_ms=events_ms(lambda: sf.paged_fused_select_plain(*b5_args, window=w),
                                        max(2, iters // 10)),
                     bound_ms=bms, bound_by=bby, library_ms=None,
                     ctas=kernel_ctas(lambda: sf.paged_fused_select(*b5_args, window=w),
                                      "paged_fused_select_kernel"), **home))

    # B6 — partials over the rank-local plan of the selection B5 leads to
    t = ht.locate_threshold(out5[1], params.k)
    keep = out5[0].reshape(s, kv, n) >= t[..., None].to(torch.uint8)
    sel = ht.Selection(*ht.compact_indices(keep, params.k_cap), t)
    pblk, counts, bmask = fd._selected_block_plan(pool, sel, (0, pool.num_blocks))
    h = q.shape[1]
    qr = q.reshape(s * kv, h // kv, hd).contiguous()
    kvargs = (qr, pool.k_codes, pool.k_scale, pool.v_codes, pool.v_scale, pblk)
    out6 = fd.sparse_flash_decode_paged_partials_kernel(*kvargs, counts, bmask, kv)
    plain6 = fd.sparse_flash_decode_paged_partials_plain(*kvargs, bmask, kv)
    # acc is an unnormalised sum whose terms cancel, so its rounding error
    # scales with sum(p·|v|) (the plain partials over |v|), not with |acc|;
    # m and l do not cancel and scale with themselves
    mag = fd.sparse_flash_decode_paged_partials_plain(*kvargs[:3], kvargs[3].abs(),
                                                      *kvargs[4:], bmask, kv)[0]
    err6, ratio6 = 0.0, 0.0
    for a, b, scale in zip(out6, plain6, (mag, plain6[1].abs(), plain6[2])):
        err6 = max(err6, float((a - b).abs().max()))
        ratio6 = max(ratio6, float(((a - b).abs() / (B2_ATOL + B2_RTOL * scale)).max()))
    acc_vs_abs = float(((out6[0] - plain6[0]).abs()
                        / (B2_ATOL + B2_RTOL * plain6[0].abs())).max())
    if not ratio6 <= 1.0:
        raise AssertionError(f"B6: |kernel - plain| reaches {ratio6:.3g}x its bound "
                             f"{B2_ATOL:g} + {B2_RTOL:g}·scale (max abs err {err6})")
    live = int(counts.sum())
    b6_bytes = (live * bs * (2 * hd + 8) + 2 * qr.numel() * 4 + 8 * qr.shape[0] * qr.shape[1]
                + 4 * counts.numel() + live * (4 + bs))
    bms, bby = bound(b6_bytes, live * bs * (h // kv) * hd * 4, "f32")
    recs.append(dict(name="sparse_flash_decode_paged_partials" + tag,
                     counter="sparse_flash_decode_paged_partials", route="cuda",
                     source="src/repro_torch/csrc/flash_decode.cu",
                     replaces="src/repro/kernels/flash_decode/kernel.py:276",
                     launches=None, max_abs_err=err6,
                     tolerance=(f"{B2_ATOL:g} + {B2_RTOL:g}*scale; scale = sum(p*|v|) "
                                "for acc, |plain| for m and l"), err_over_tol=ratio6,
                     acc_err_over_abs_plain_tol=acc_vs_abs,
                     ms=kernel_ms(lambda: fd.sparse_flash_decode_paged_partials_kernel(
                         *kvargs, counts, bmask, kv), "sparse_flash_decode_paged_kernel", iters),
                     plain_ms=events_ms(lambda: fd.sparse_flash_decode_paged_partials_plain(
                         *kvargs, bmask, kv), max(2, iters // 10)),
                     bound_ms=bms, bound_by=bby, library_ms=None,
                     ctas=kernel_ctas(lambda: fd.sparse_flash_decode_paged_partials_kernel(
                         *kvargs, counts, bmask, kv), "sparse_flash_decode_paged_kernel"),
                     selected_blocks=live, rows=int(counts.numel()), **home))
    for rec in recs:
        if tag:
            rec["graph_ms"] = rec["ms"]
    return recs


def check_tiered_kernels(dev, cfg, lengths, iters=20, salca=None, timed=True):
    """Phase 3a, B2's and B6's fp16 and int4 branches at the main path's
    shapes, each on a random pool in its mode and the selection the query
    makes over it: B2 within B2_ATOL + B2_RTOL·|plain|, B6 within
    B2_ATOL + B2_RTOL·scale as B6's int8 branch (scale = sum(p·|v|) for acc).
    Another model's shapes: ``salca`` as `check_kernels`'; ``timed=False``
    checks without timing (no profiler session)."""
    import torch
    from repro_torch.core.quantization import pack_int4, unpack_int4
    from repro_torch.core.selection import (
        _quantized_query_groups, query_heavy_features, select_sparse_pattern_blocked)
    from repro_torch.flags import PERF
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.score_est import ops as se
    from repro_torch.models.blocks import salca_params_for

    s, mseq, bs = SERVE["slots"], SERVE["max_seq"], SERVE["block_size"]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    params = salca or salca_params_for(cfg, mseq)
    recs = []
    for mode, elem_bytes in (("fp16", 2.0), ("int4", 0.5)):
        gen = torch.Generator(device=dev).manual_seed(3)
        pool = random_pool(dev, gen, cfg, s, mseq, bs, lengths, kv_pool_dtype=mode)
        q = torch.randn((s, h, hd), generator=gen, device=dev)
        qc, qs, qsum = _quantized_query_groups(query_heavy_features(q, pool.heavy_idx, h // kv),
                                               kv)
        scores = se.paged_score_estimate(qc, qs, qsum, pool.feat_words, pool.feat_scale,
                                         pool.feat_zero, pool.clamped_pages(),
                                         bf16=PERF.bf16_collectives)
        sel = select_sparse_pattern_blocked(scores, params, pool.mapped_valid_mask()[:, None, :],
                                            bs)
        qr = q.reshape(s * kv, h // kv, hd).contiguous()
        live_rows = {}
        for partials in (False, True):
            pblk, counts, bmask = fd._selected_block_plan(
                pool, sel, (0, pool.num_blocks) if partials else None)
            ops = (qr, pool.k_codes, pool.k_scale, pool.v_codes, pool.v_scale, pblk)
            kern = functools.partial(fd.sparse_flash_decode_paged_partials_kernel if partials
                                     else fd.sparse_flash_decode_paged_kernel,
                                     *ops, counts, bmask, kv, mode)
            plain_of = (fd.sparse_flash_decode_paged_partials_plain if partials
                        else fd.sparse_flash_decode_paged_plain)
            plain_fn = functools.partial(plain_of, *ops, bmask, kv, mode)
            got, want = kern(), plain_fn()
            if partials:
                vabs = ops[3].abs() if mode == "fp16" else pack_int4(unpack_int4(ops[3]).abs())
                scales = (plain_of(*ops[:3], vabs, *ops[4:], bmask, kv, mode)[0],
                          want[1].abs(), want[2])
                tol = (f"{B2_ATOL:g} + {B2_RTOL:g}*scale; scale = sum(p*|v|) for acc, "
                       "|plain| for m and l")
            else:
                got, want, scales = (got,), (want,), (want.abs(),)
                tol = f"{B2_ATOL:g} + {B2_RTOL:g}*|plain|"
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            ratio = max(float(((a - b).abs() / (B2_ATOL + B2_RTOL * sc)).max())
                        for a, b, sc in zip(got, want, scales))
            name = ("sparse_flash_decode_paged_partials" if partials
                    else "sparse_flash_decode_paged") + f"[{mode}]"
            if not ratio <= 1.0:
                raise AssertionError(f"{name}: |kernel - plain| reaches {ratio:.3g}x its "
                                     f"bound {tol} (max abs err {err})")
            live = int(counts.sum())
            live_rows[partials] = live
            # K and V rows of the selected blocks at the mode's width, one
            # scale word per block for each; q, the outputs, the plan
            nbytes = (live * (2 * bs * hd * elem_bytes + 8) + 2 * qr.numel() * 4
                      + (8 * qr.shape[0] * qr.shape[1] if partials else 0)
                      + 4 * counts.numel() + live * (4 + bs))
            bms, bby = bound(nbytes, live * bs * (h // kv) * hd * 4, "f32")
            rec = dict(name=name, route="cuda", source="src/repro_torch/csrc/flash_decode.cu",
                       replaces="src/repro/kernels/flash_decode/kernel.py:"
                                + ("276" if partials else "207"),
                       launches=None, max_abs_err=err, tolerance=tol, err_over_tol=ratio,
                       bound_ms=bms, bound_by=bby, selected_blocks=live,
                       rows=int(counts.numel()))
            if timed:
                rec.update(ms=kernel_ms(kern, "sparse_flash_decode_paged_kernel", iters),
                           plain_ms=events_ms(plain_fn, max(2, iters // 10)),
                           **(dict(library_ms=None) if partials else b2_yardstick(
                               qr, pool, pblk, counts, bmask, kv, mode, iters)),
                           ctas=kernel_ctas(kern, "sparse_flash_decode_paged_kernel"))
            recs.append(rec)
        if live_rows[False] != live_rows[True]:
            raise AssertionError(f"{mode}: the one-rank plan lists {live_rows[True]} blocks, "
                                 f"the unsharded plan {live_rows[False]}")
        del pool
    return recs


def check_bin_kernels(dev, iters=50):
    """Phase 3a, B10 (max-pool) and B11 (histogram + threshold), the entry
    points `maxpool_int8` and `hist_threshold` of the reference's public
    kernel API, at (32, 8192) uint8 bins with window 7 and k = 409: each is
    driven once with the launch counts at 0 (``drive_launches`` in its
    record; its ``launches`` are run (v)'s, the flat tick that serves
    them), then held bit for bit against its plain version and timed.
    Library calls: `max_pool1d` on a float copy (the bins are >= 0, so its
    -inf padding pools as the kernel's zero fill) and `bincount` over
    row-offset bins (the histogram only)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.kernels.hist_topk import ops as ht
    from repro_torch.kernels.maxpool import ops as mp
    bh, n, window, k = SERVE["slots"] * 8, SERVE["max_seq"], 7, 409
    bins = torch.randint(0, 256, (bh, n), generator=torch.Generator(device=dev).manual_seed(4),
                         device=dev, dtype=torch.uint8)
    reset_launches()
    pooled = mp.maxpool_int8(bins, window)
    hist, thr = ht.hist_threshold(bins, k)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    _check_exact("B10", (pooled,), (mp.maxpool_int8_plain(bins, window),))
    kk = torch.full((bh,), k, dtype=torch.int32, device=dev)
    _check_exact("B11", (hist, thr), ht.hist_threshold_plain(bins, kk))
    xf = bins.float()[:, None]
    offs = (bins.long() + 256 * torch.arange(bh, device=dev)[:, None]).reshape(-1)
    recs = []
    for name, kname, fn, plain, lib, nbytes, ops, replaces, call in (
            ("maxpool_int8", "maxpool_u8_kernel", lambda: mp.maxpool_int8(bins, window),
             lambda: mp.maxpool_int8_plain(bins, window),
             lambda: F.max_pool1d(xf, window, stride=1, padding=window // 2),
             2 * bh * n, bh * n * (window - 1), "src/repro/kernels/maxpool/kernel.py:55",
             "max_pool1d on a float copy of the bins (copy not timed)"),
            ("hist_threshold", "hist_threshold_kernel", lambda: ht.hist_threshold(bins, k),
             lambda: ht.hist_threshold_plain(bins, kk),
             lambda: torch.bincount(offs, minlength=bh * 256),
             bh * n + 4 * bh + 4 * 256 * bh + 4 * bh, bh * n + bh * 256,
             "src/repro/kernels/hist_topk/kernel.py:57",
             "bincount over row-offset bins: the histogram only, no threshold "
             "(offsets not timed)")):
        bms, bby = bound(nbytes, ops, "f32")
        recs.append(dict(name=name, route="cuda",
                         source="src/repro_torch/csrc/selection_fused.cu", replaces=replaces,
                         launches=launches.get(name, 0), max_abs_err=0.0,
                         tolerance="bit-identical", err_over_tol=0.0,
                         ms=kernel_ms(fn, kname, iters),
                         cold_ms=cold_kernel_ms(fn, kname, iters),
                         plain_ms=events_ms(plain, max(2, iters // 10)),
                         bound_ms=bms, bound_by=bby, library_ms=events_ms(lib, iters),
                         library_call=call, ctas=kernel_ctas(fn, kname)))
    print(f"B10/B11 drive: launches {launches}; thresholds "
          f"{sorted({int(t) for t in thr.tolist()})}", flush=True)
    return recs


def check_sp_flat_kernels(dev, cfg, lengths, iters=20, tag="", salca=None,
                          run="sp contiguous", pooling=True, n=None):
    """Phase 3a, the sequence-sharded flat tick's kernels at one rank on a
    random slot pool at the serving shapes (the tick of run (v)): B7's
    scores, the bins with the (all-reduced, here one rank's) affine, B10
    over the halo-padded rows (zero halos: a world of one) and B11 on the
    pooled rows, both bit-identical; then the rank's selection compacted
    into its capacity, gathered, and B8's partials branch within
    B2_ATOL + B2_RTOL·|plain| on acc, m and l (library: none). Another
    model's shapes: ``tag`` and ``salca`` as in `check_kernels`
    (``pooling=False``: B8's partials only), ``n`` the cache's rows where
    they are not SERVE's max_seq (whisper's cross stream at one rank, run
    (ac*)); every record counts its wrapper's launches on run ``run`` and is
    timed by `graph_ms` (phase 3 holds enough profiler sessions
    already)."""
    import torch
    from repro_torch.core import quantization as qz
    from repro_torch.core.attention import gather_selected
    from repro_torch.core.histogram_topk import Selection, compact_indices, locate_threshold
    from repro_torch.core.selection import _quantized_query_groups, query_heavy_features
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.hist_topk import ops as htk
    from repro_torch.kernels.maxpool import ops as mp
    from repro_torch.kernels.score_est import ops as se
    from repro_torch.models.blocks import salca_params_for

    gen = torch.Generator(device=dev).manual_seed(5)
    s, n = SERVE["slots"], n or SERVE["max_seq"]
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    bh, g = s * kv, h // kv
    params = salca or salca_params_for(cfg, n)
    cap = min(n, max(128, 4 * params.k_cap))                  # one rank's capacity
    cache = random_cache(dev, gen, cfg, s, n, lengths)
    q = torch.randn((s, h, hd), generator=gen, device=dev)
    qc, qs, _ = _quantized_query_groups(query_heavy_features(q, cache.heavy_idx, g), kv)
    scores = se.flat_score_estimate(qc, qs, cache.feat_words, cache.feat_scale,
                                    cache.feat_zero, bf16=True)
    valid = cache.valid_mask()[:, None, :]
    lo = torch.where(valid, scores, torch.full_like(scores, float("inf"))).amin(-1)
    hi = torch.where(valid, scores, torch.full_like(scores, -1e30)).amax(-1)
    bins = qz.bins_from_bounds(scores, lo, hi, valid)
    w, halo = params.pool_window, params.pool_window // 2
    zeros = torch.zeros((s, kv, halo), dtype=torch.uint8, device=dev)
    padded = torch.cat([zeros, bins, zeros], dim=-1).reshape(bh, n + 2 * halo)
    recs, extra = [], {"run": run, "tick": f"sequence-sharded flat (run {run!r})"}
    pooled_p = mp.maxpool_int8(padded, w)
    pooled = torch.where(valid, pooled_p[:, halo:-halo].reshape(s, kv, n),
                         torch.zeros_like(bins)).reshape(bh, n).contiguous()
    hist, _ = htk.hist_threshold(pooled, params.k)
    if pooling:
        import torch.nn.functional as F
        _check_exact("B10 (halo-padded rows)", (pooled_p,), (mp.maxpool_int8_plain(padded, w),))
        kk = torch.full((bh,), params.k, dtype=torch.int32, device=dev)
        _check_exact("B11 (pooled rows)", (hist,), (htk.hist_threshold_plain(pooled, kk)[0],))
        np_ = bh * (n + 2 * halo)
        # library calls as `check_bin_kernels` times them (copies not timed)
        xf = padded.float()[:, None]
        offs = (pooled.long() + 256 * torch.arange(bh, device=dev)[:, None]).reshape(-1)
        for name, fn, plain, lib, nbytes, ops, replaces, call in (
                ("maxpool_int8", lambda: mp.maxpool_int8(padded, w),
                 lambda: mp.maxpool_int8_plain(padded, w),
                 lambda: F.max_pool1d(xf, w, stride=1, padding=w // 2), 2 * np_, np_ * (w - 1),
                 "src/repro/kernels/maxpool/kernel.py:55",
                 "max_pool1d on a float copy of the halo-padded bins (copy not timed)"),
                ("hist_threshold", lambda: htk.hist_threshold(pooled, params.k),
                 lambda: htk.hist_threshold_plain(pooled, kk),
                 lambda: torch.bincount(offs, minlength=bh * 256),
                 bh * n + 4 * 256 * bh + 4 * bh, bh * n + bh * 256,
                 "src/repro/kernels/hist_topk/kernel.py:57",
                 "bincount over row-offset pooled bins: the histogram only, no threshold "
                 "(offsets not timed)")):
            bms, bby = bound(nbytes, ops, "f32")
            rec = dict(name=f"{name}[sp_flat]{tag}", counter=name, route="cuda",
                       source="src/repro_torch/csrc/selection_fused.cu", replaces=replaces,
                       launches=None, max_abs_err=0.0, tolerance="bit-identical",
                       err_over_tol=0.0, ms=graph_ms(fn, iters),
                       plain_ms=events_ms(plain, max(2, iters // 10)), bound_ms=bms,
                       bound_by=bby, library_ms=events_ms(lib, iters), library_call=call,
                       shape=[bh, n + 2 * halo if name == "maxpool_int8" else n], **extra)
            rec["graph_ms"] = rec["ms"]
            recs.append(rec)

    # B8's partials branch over the rank's selection
    t = locate_threshold(hist.reshape(s, kv, 256), params.k)
    keep = pooled.reshape(s, kv, n) >= t[..., None].to(torch.uint8)
    sel = Selection(*compact_indices(keep, cap), t)
    kc, ks, vc, vs = gather_selected(cache, sel)
    c = kc.shape[2]
    args = (q.reshape(bh, g, hd).contiguous(), kc.reshape(bh, c, hd), ks.reshape(bh, c),
            vc.reshape(bh, c, hd), vs.reshape(bh, c), sel.mask.reshape(bh, c))
    got = fd.sparse_flash_decode_partials(*args)
    want = fd.sparse_flash_decode_partials_plain(*args)
    torch.cuda.synchronize()
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    ratio = max(float(((a - b).abs() / (B2_ATOL + B2_RTOL * b.abs())).max())
                for a, b in zip(got, want))
    if not ratio <= 1.0:
        raise AssertionError(f"B8 partials{tag}: |kernel - plain| reaches {ratio:.3g}x its "
                             f"bound {B2_ATOL:g} + {B2_RTOL:g}·|plain| (max abs err {err})")
    live = int(sel.mask.sum())
    nbytes = live * (2 * hd + 8) + bh * c + 2 * 4 * args[0].numel() + 2 * 4 * bh * g
    bms, bby = bound(nbytes, live * g * hd * 4, "f32")
    fn = lambda: fd.sparse_flash_decode_partials(*args)         # noqa: E731
    rec = dict(name="sparse_flash_decode_partials" + tag, counter="sparse_flash_decode_partials",
               route="cuda", source="src/repro_torch/csrc/flash_decode.cu",
               replaces="src/repro/kernels/flash_decode/kernel.py:73", launches=None,
               max_abs_err=err, tolerance=f"{B2_ATOL:g} + {B2_RTOL:g}*|plain| (acc, m, l)",
               err_over_tol=ratio, ms=graph_ms(fn, iters),
               plain_ms=events_ms(lambda: fd.sparse_flash_decode_partials_plain(*args),
                                  max(2, iters // 10)),
               bound_ms=bms, bound_by=bby, library_ms=None,
               library_call="none: no library call returns the unnormalised (acc, m, l)",
               selected_rows=live,
               capacity=bh * c, thresholds=sorted({int(x) for x in t.flatten().tolist()}),
               **extra)
    rec["graph_ms"] = rec["ms"]
    if tag and run == "sp contiguous":
        rec["note"] = ("no run serves this model through the flat tick: its launches are "
                       "the wrapper's on run (v)")
    recs.append(rec)
    return recs


def small_path_model(arch="qwen3-0.6b"):
    """The small path's model and prompts: reduced ``arch`` at f32 with
    random weights from seed 0 on the CPU, three prompts from seed 0."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.weights import init_lm_params
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    params = init_lm_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (150, 200, 170)]
    return cfg, params, prompts


def small_path_run(d, cfg, params, prompts, paged: bool, **engine_kw):
    """One small-path engine run on device ``d``: greedy tokens, each
    tick's (active mask, logits), the engine's stats, and the stored int8
    K/V codes of every cache (None for a fp16 pool, compared by the logits
    alone)."""
    import torch
    from repro_torch.runtime.serve import Request, ServingEngine
    eng = ServingEngine(cfg, _to(params, d), max_seq=256, slots=2, paged=paged, block_size=32,
                        device=d, **engine_kw)
    reqs = [Request(rid=i, prompt=pr, max_new_tokens=5) for i, pr in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    logits = []
    orig = eng._decode

    def rec(*a):
        out = orig(*a)
        logits.append((a[1].copy(), out[1].float().cpu().numpy()))
        return out

    eng._decode = rec
    stats = eng.run()
    attn = [c for c in eng._state.caches if hasattr(c, "k_codes")]
    codes = (torch.cat([getattr(c, f).reshape(-1).cpu().to(torch.int16)
                        for f in ("k_codes", "v_codes") for c in attn])
             if attn and attn[0].k_codes.dtype == torch.int8 else None)
    return [r.output for r in reqs], logits, stats, codes


def logit_gaps(lg_a, lg_b) -> list:
    """Per tick, the largest |a - b| over the rows of the active slots."""
    return [float(np.abs(a[1][a[0]] - b[1][b[0]]).max()) for a, b in zip(lg_a, lg_b)]


def check_small_path(dev, paged: bool, arch="qwen3-0.6b", **engine_kw):
    """Phase 3b: the whole serving path on a small input — the port on the
    card against the port's plain versions on the CPU (which the CPU tests
    hold against the JAX reference), through the paged or the contiguous
    engine, with ``engine_kw`` (a pool mode, the host tier). Reduced
    ``arch`` (qwen3-0.6b; gemma3-12b: rings of 64 slots that every prompt
    wraps) at f32, a sparse selection (k = 128 of 256 positions)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, params, prompts = small_path_model(arch)
    (tok_c, lg_c, st_c, codes_c), (tok_g, lg_g, st_g, codes_g) = (
        small_path_run(d, cfg, params, prompts, paged, **engine_kw) for d in ("cpu", dev))
    label = (f"{arch}, " if arch != "qwen3-0.6b" else "") + f"paged={paged}" + "".join(
        f", {k}={v}" for k, v in engine_kw.items())
    if tok_c != tok_g:
        raise AssertionError(f"small path ({label}): greedy tokens differ: "
                             f"cpu {tok_c} vs card {tok_g}")
    spill = {}
    if engine_kw.get("host_spill"):
        spill = {k: getattr(st_g, k) for k in ("demotions", "promotions", "pcie_bytes")}
        if not (st_g.demotions > 0 and st_g.promotions > 0) or spill != {
                k: getattr(st_c, k) for k in spill}:
            raise AssertionError(f"small path ({label}): the host tier must demote and "
                                 f"promote, alike on both: card {spill} vs cpu "
                                 f"{ {k: getattr(st_c, k) for k in spill} }")
    gap = max(logit_gaps(lg_c, lg_g))
    # cuBLAS and the CPU sum in other orders; over ~500 stored tokens a
    # last-ulp difference in K/V can move one int8 / 2-bit code by one step
    # (the CPU tests see 3.3e-5 against JAX for the same reason). The card
    # read 1.28e-4 in every run; the limit leaves 2.3x of headroom.
    code_steps = None if codes_c is None else int((codes_c != codes_g).sum())
    tol = SMALL_PATH_LOGIT_TOL
    if arch != "qwen3-0.6b" and code_steps:
        step = int((codes_c.int() - codes_g.int()).abs().max())
        if step > 1:
            raise AssertionError(f"small path ({label}): stored codes {step} steps apart")
        tol = SMALL_PATH_CODE_STEP_TOL
    if not gap <= tol:
        raise AssertionError(f"small path ({label}): max logits gap {gap} > {tol:g} "
                             f"({code_steps} stored K/V codes differ)")
    return {**({"arch": arch} if arch != "qwen3-0.6b" else {}), "paged": paged, **engine_kw,
            "tokens_identical": True, "max_logit_gap": gap, "ticks": len(lg_g),
            "codes_differing": code_steps, **spill}


def _to(tree, dev):
    """A parameter tree (dicts and lists of tensors) on ``dev``."""
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def main_path_model(dev):
    """The main path's model: full-width qwen3-0.6b, random bf16 weights
    from seed 0."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.weights import init_lm_params
    cfg = get_config("qwen3-0.6b")
    return cfg, init_lm_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)


def config_model(dev, arch: str):
    """Full-width ``arch`` with random bf16 weights from seed 0."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.weights import init_lm_params
    cfg = get_config(arch)
    return cfg, init_lm_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)


def main_path_requests(vocab_size: int, prompts=PROMPTS, new_tokens=NEW_TOKENS):
    """The main path's requests: prompts of PROMPTS tokens drawn from seed
    0, NEW_TOKENS new tokens each (another run's lengths where given)."""
    from repro_torch.runtime.serve import Request
    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(0, vocab_size, n).astype(np.int32),
                    max_new_tokens=new_tokens) for i, n in enumerate(prompts)]


def shared_prefix_requests(vocab_size: int):
    """The prefix-sharing run's requests: a SHARED_PREFIX-token prefix drawn
    from seed 0, three distinct SHARED_TAIL-token tails after it, and a
    fourth request with the first one's prompt; NEW_TOKENS new tokens each."""
    from repro_torch.runtime.serve import Request
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, vocab_size, SHARED_PREFIX).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, vocab_size, SHARED_TAIL).astype(np.int32)])
               for _ in range(3)]
    prompts.append(prompts[0].copy())
    return [Request(rid=i, prompt=p, max_new_tokens=NEW_TOKENS) for i, p in enumerate(prompts)]


def warm_up(cfg, params, dev, ctx, serve: dict) -> None:
    """Serve one short request on a separate engine built like the measured
    one: module loading, cuBLAS handles, the first all-reduce's communicator."""
    import torch
    from repro_torch.runtime.serve import Request, ServingEngine
    # a fault plan counts its opportunities: it stays the measured engine's
    warm = ServingEngine(cfg, params, device=dev, ctx=ctx,
                         **{k: v for k, v in serve.items() if k != "faults"})
    warm.submit(Request(rid=-1, prompt=np.random.default_rng(1).integers(
        0, cfg.vocab_size, 64).astype(np.int32), max_new_tokens=2))
    warm.run()
    del warm
    torch.cuda.synchronize()


def serve_main_path(dev, ctx=None, paged=True, force=None, probe=None, eager_run=False,
                    shared_prefix=False, temperatures=None, hook=None, stops=None,
                    model=None, prompts=PROMPTS, new_tokens=NEW_TOKENS, profile_tick=None,
                    hists=None, **engine_kw):
    """Phase 4: full-width qwen3-0.6b through the port's engine — the paged
    unsharded tick, with ``ctx`` the block-sharded tick, with ``paged=False``
    the contiguous tick, with both the sequence-sharded flat tick;
    ``engine_kw`` adds the tiered pool's knobs
    (``kv_pool_dtype``, ``host_spill``, ...). Without ``ctx`` the tick is a
    CUDA graph after its first call (`runtime.steps`); ``eager_run`` builds
    the engines under `steps.eager()` instead. ``force`` ({rid: tokens})
    feeds the engine those tokens in place of its own picks (teacher
    forcing); ``probe`` (a `SpillProbe`) is installed on the engine before
    the run and checks it after. ``shared_prefix`` serves the model with
    static heavy channels on `shared_prefix_requests` (the engine's
    ``prefix_sharing`` comes in ``engine_kw``); a copy on write is then
    profiled (``cow_service`` in the summary: its launches on the device and
    its ms, host clock between two synchronizations, under the profiler).
    ``temperatures`` sets the requests' (with ``greedy=False`` in
    ``engine_kw``: sampled runs); ``hook(engine)`` runs on the built engine
    just before the run; ``stops`` ({rid: reason}, default "length") the
    stop reasons the run must give. ``model`` ((cfg, params)) serves another
    model than qwen3-0.6b, on ``prompts`` × ``new_tokens``: its tick kernels
    launch once per global ("A") layer, B3 once per layer; ``profile_tick``
    (an index) runs that tick under the profiler, whose device ms and
    kernel launches the summary gives (``profiled_tick``). ``hists`` (a
    list) receives, after every tick, every paged layer's selection
    histogram (`sel_hist`, stacked; a copy). ``fused_decode`` in
    ``engine_kw``, or ``sharded_fused_decode`` off under ``ctx``, runs the
    reference's unfused baseline: B7 and B8 (its partials branch under
    ``ctx``) in place of B1 and B2 (B4-B6). Returns the
    launch counts of the run, its
    summary (with each tick's wall ms: the first eager, the second the
    capture where the step is graphed; each tick's finite flags; with
    sampling the host ms of each sampled token), the engine's own picks per
    request (greedy or sampled, before any forcing) and, for every
    generated token (request, index), the logits row it was drawn from, on
    the host (index 0: the prefill's row)."""
    import contextlib
    import dataclasses
    import gc

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.distributed.sharding import COLLECTIVES
    from repro_torch.flags import PERF
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.runtime.serve import Request, ServingEngine
    from repro_torch.runtime.steps import eager
    gc.collect()              # an earlier run's engine (its hooks form a cycle)
    torch.cuda.empty_cache()
    cfg, params = model if model is not None else main_path_model(dev)
    if shared_prefix:
        cfg = dataclasses.replace(cfg, salca_static_channels=True)
    serve = dict(SERVE, paged=paged, **engine_kw)
    building = eager if eager_run else contextlib.nullcontext

    with building():
        warm_up(cfg, params, dev, ctx, serve)

    with building():
        engine = ServingEngine(cfg, params, device=dev, ctx=ctx, **serve)
    reqs = (shared_prefix_requests(cfg.vocab_size) if shared_prefix
            else main_path_requests(cfg.vocab_size, prompts, new_tokens))
    for r, t in zip(reqs, temperatures or ()):
        r.temperature = t
    for r in reqs:
        engine.submit(r)
    ticks, rows, own, tick_ms, flags, sample_ms = [], {}, {}, [], [], []
    orig_decode, orig_prefill, orig_next = engine._decode, engine._prefill, engine._next_token
    orig_sample = engine._sample

    profiled = {}

    def decode(*a):
        who = [(slot, req.rid, len(req.output)) for slot, req in engine._active.items()]
        t0 = time.perf_counter()
        if len(ticks) == profile_tick:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                time.sleep(PROFILE_IDLE_S)
                nxt, logits, finite = orig_decode(*a)
                torch.cuda.synchronize()
                time.sleep(PROFILE_IDLE_S)
            kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            # a session can lose its launches (`_profiled`): then nothing is read
            profiled.update(tick=profile_tick, launches=len(kernels) or None,
                            device_ms=(sum(e.time_range.elapsed_us() for e in kernels) / 1e3
                                       if kernels else None))
        else:
            nxt, logits, finite = orig_decode(*a)
        # to pinned host memory, ready when the engine reads ``nxt``
        ticks.append((who, logits.to("cpu", non_blocking=True)))
        flags.append(finite.to("cpu", non_blocking=True))
        torch.cuda.synchronize()
        tick_ms.append(1e3 * (time.perf_counter() - t0))
        if hists is not None:
            hists.append(torch.stack([c.sel_hist for c in engine._state.caches
                                      if hasattr(c, "sel_hist")]).clone())
        return nxt, logits, finite

    prefill_ms = []

    def prefill(req):
        t0 = time.perf_counter()
        row, st = orig_prefill(req)          # its row is on the host: the prefill is done
        prefill_ms.append(1e3 * (time.perf_counter() - t0))
        rows[(req.rid, 0)] = torch.from_numpy(row)
        return row, st

    def next_token(req, logits_row, greedy_tok=None):
        idx = len(req.output)
        if force is not None:
            own[(req.rid, idx)] = greedy_tok if logits_row is None else int(np.argmax(logits_row))
            return orig_next(req, None, greedy_tok=force[req.rid][idx])
        own[(req.rid, idx)] = tok = orig_next(req, logits_row, greedy_tok)
        return tok

    def sample(req, logits_row):
        t0 = time.perf_counter()
        tok = orig_sample(req, logits_row)
        if not engine.greedy and req.temperature > 0:
            sample_ms.append(1e3 * (time.perf_counter() - t0))
        return tok

    cow = []

    def cow_block(*a, real=engine.api.cow_block):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = real(*a)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
        cow.append({"ms": ms, "launches": sum(e.device_type == DeviceType.CUDA
                                              for e in prof.events())})
        return out

    engine._decode, engine._prefill, engine._next_token = decode, prefill, next_token
    engine._sample = sample
    engine.api = engine.api._replace(cow_block=cow_block)
    if probe is not None:
        probe.install(engine)
    if hook is not None:
        hook(engine)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    COLLECTIVES.clear()
    t0 = time.time()
    stats = engine.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(LAUNCHES)
    collectives = dict(COLLECTIVES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    assert stats.completed == len(reqs), stats.summary()
    want_stops = [(stops or {}).get(r.rid, "length") for r in reqs]
    if [r.stop_reason for r in reqs] != want_stops:
        raise AssertionError(f"stop reasons {[r.stop_reason for r in reqs]} != {want_stops}")
    assert all(len(r.output) == new_tokens for r in reqs if r.stop_reason == "length")
    assert stats.decode_calls == stats.ticks > 0, stats.summary()
    for who, logits in ticks:
        for slot, rid, j in who:
            rows[(rid, j)] = logits[slot]
    # a quarantined request's last row (the one its flag dropped on) is the
    # only row that may be non-finite
    bad = {k for k, r in rows.items() if not bool(torch.isfinite(r).all())}
    if bad - {(r.rid, len(r.output)) for r in reqs if r.stop_reason == "error"}:
        raise AssertionError(f"non-finite logits on the main path at {sorted(bad)}")
    # B3 runs in every attention layer's prefill, the tick kernels in every
    # "A" layer ("S" and "R" layers run none: their mixers are torch ops)
    nl = sum(kind in "AL" for kind in cfg.block_kinds())
    na = cfg.block_kinds().count("A")
    mode = engine_kw.get("kv_pool_dtype", "int8")
    branch = {"int8": ""}.get(mode, f"[{mode}]")
    # the unfused baselines (at one rank the engine's knob steers the
    # unsharded flag, as in the reference; the island follows its own flag)
    knob = engine_kw.get("fused_decode")
    unfused = paged and not (PERF.sharded_fused_decode if ctx is not None else
                             PERF.paged_fused_decode if knob is None else knob)
    if not paged and ctx is None:
        tick_kernels = ("score_estimate", "fused_bin_pool_threshold", "sparse_flash_decode")
    elif not paged:
        tick_kernels = ("score_estimate", "maxpool_int8", "hist_threshold",
                        "sparse_flash_decode_partials")
    elif unfused:
        tick_kernels = ("score_estimate",) + (
            () if mode != "int8" else ("sparse_flash_decode",) if ctx is None
            else ("sparse_flash_decode_partials",))
    elif ctx is None:
        tick_kernels = ("paged_score_estimate", "sparse_flash_decode_paged" + branch)
    else:
        tick_kernels = ("paged_score_bounds", "paged_fused_select",
                        "sparse_flash_decode_paged_partials" + branch)
    tick_kernels = tick_kernels if na else ()
    want = {k: na * stats.ticks for k in tick_kernels}
    if nl:
        want["flash_prefill"] = nl * stats.admissions
    if launches != want:
        raise AssertionError(f"launch counts {launches} != expected {want}")
    vocab_ok = all(0 <= t < cfg.vocab_size for r in reqs for t in r.output)
    assert vocab_ok, "sampled a token outside the vocabulary"
    summary = stats.summary()
    if probe is not None:
        summary.update(probe.finish(engine))
    step = engine._step
    if step.graphed != (ctx is None and not eager_run) or (step.graphed and step._graph is None):
        raise AssertionError(f"tick graphed={step.graphed}, captured="
                             f"{step._graph is not None}: every unsharded tick after the "
                             f"first must replay a CUDA graph, every other run stay eager")
    summary.update(wall_s=wall, peak_mem_gb=peak, prefill_ms=prefill_ms,
                   state_bytes_per_slot=state_bytes_per_slot(engine._state, SERVE["slots"]),
                   ttft_s=[r.ttft_s for r in reqs], prompts=[len(r.prompt) for r in reqs],
                   cow_service=cow, profiled_tick=profiled,
                   launches_per_tick={k: launches[k] / stats.ticks for k in tick_kernels},
                   collectives_per_tick={k: v / stats.ticks for k, v in collectives.items()},
                   graphed=step.graphed, tick_ms=tick_ms,
                   finite=[{rid: bool(fl[slot]) for slot, rid, _ in who}
                           for (who, _), fl in zip(ticks, flags)], sample_ms=sample_ms,
                   nonfinite_rows=sorted(bad),
                   replay_ms_median=float(np.median(tick_ms[2:])) if step.graphed else None,
                   launches_per_replay=(sum(step.launches_per_tick.values())
                                        if step.launches_per_tick else None))
    picks = [[own[(r.rid, j)] for j in range(len(r.output))] for r in reqs]
    return launches, summary, picks, rows


def state_bytes_per_slot(state, slots: int) -> dict:
    """The bytes one slot holds in a decode state, by kind: the recurrent
    states of "S" and "R" layers, the rings and contiguous caches, and a
    paged pool's share (its data over the slots)."""
    from repro_torch.core.cache import PagedSalcaCache
    from repro_torch.models.blocks import RECURRENT
    out = {"recurrent": 0, "contiguous": 0, "paged": 0}
    for c in state.caches:
        if isinstance(c, RECURRENT):
            out["recurrent"] += sum(t.numel() * t.element_size() for t in c) // slots
        elif isinstance(c, PagedSalcaCache):
            out["paged"] += sum(t.numel() * t.element_size() for t in c.data.values()) // slots
        else:
            out["contiguous"] += sum(t.numel() * t.element_size()
                                     for t in (c.k_codes, c.k_scale, c.v_codes, c.v_scale,
                                               c.feat_words, c.feat_scale, c.feat_zero)) // slots
    return out


class SpillProbe:
    """Instruments the int4 + host-spill run of phase 4 and checks it.

    * Round trip: before the first tick, the oldest block of the longest
      resident request is read (every layer's rows, on the card), demoted,
      promoted back into a fresh block and read again: the two reads must
      be equal bit for bit.
    * Histogram: with random weights every tick selects tokens in every
      block (28 layers × 8 kv heads per slot), so no block goes cold by
      itself. As in the reference's spill test, the reader reports the
      first ``COLD`` logical blocks of every slot unselected (the real
      reader still runs and syncs); the policy then demotes those of them
      that are resident, and the promotion pass brings back the spilled
      blocks with the highest counts.
    * After the run: wave admission happened, demotions by pressure and by
      policy and at least one promotion happened, ``pcie_bytes`` equals
      (demotions + promotions) × the block bytes, every request ended with
      ``length`` and no overflow, and the pool drained (all blocks free,
      refcounts 0, no spilled payload left, every layer's invariants and the
      engine's audit clean).
    * ``faulted``: the engine fails every promotion (a ``spill_transfer``
      fault plan): no round trip is made; instead of a promotion, a block
      must be pinned cold while its request runs, with retries and degraded
      ticks counted, and no promotion may land.
    """
    COLD = 8

    def __init__(self, faulted: bool = False):
        self.faulted = faulted

    def install(self, eng) -> None:
        import torch
        # demotions by cause; wave admissions
        self.events = {"pressure": 0, "policy": 0, "wave": 0, "wave_admissions": 0}
        self.hist_s, self.hist_calls = 0.0, 0
        self.roundtrip = None
        self.peak_pinned_cold = 0
        real_hist, real_policy = eng._sel_hist_fn, eng._spill_policy
        real_demote, real_install, real_tick = eng.demote_block, eng._install_prompt, eng._tick
        real_streaks = eng._update_cold_streaks
        phase = {"now": "pressure"}

        def hist(state):
            h = real_hist(state).clone()
            h[:, :self.COLD] = 0
            return h

        def streaks():      # the policy's per-tick histogram read and sync
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            real_streaks()
            self.hist_s += time.perf_counter() - t0
            self.hist_calls += 1

        def demote(slot, logical, _inject=True):
            done = real_demote(slot, logical, _inject)
            self.events[phase["now"]] += done
            return done

        def policy():
            phase["now"] = "policy"
            real_policy()
            phase["now"] = "pressure"

        def install(slot, shared, need, state1, fresh):
            if fresh is None:                 # the prompt admits in waves
                self.events["wave_admissions"] += 1
                phase["now"] = "wave"
            real_install(slot, shared, need, state1, fresh)
            phase["now"] = "pressure"

        def tick():
            if self.roundtrip is None and not self.faulted:
                self.roundtrip = self._roundtrip(eng, real_demote)
            real_tick()
            self.peak_pinned_cold = max(self.peak_pinned_cold, len(eng._pinned_cold))

        eng._sel_hist_fn, eng._spill_policy, eng.demote_block = hist, policy, demote
        eng._install_prompt, eng._tick, eng._update_cold_streaks = install, tick, streaks

    @staticmethod
    def _roundtrip(eng, demote) -> dict:
        import torch
        slot = max(eng._active, key=lambda s: eng._slot_pos[s])
        logical = next(j for j, b in enumerate(eng._slot_blocks[slot]) if b >= 0)
        before = [[t.clone() for t in rows]
                  for rows in eng.api.read_block(eng._state, eng._slot_blocks[slot][logical])]
        demote(slot, logical)
        if not eng.promote_block(slot, logical):
            raise AssertionError("round trip: no block free to promote into")
        after = eng.api.read_block(eng._state, eng._slot_blocks[slot][logical])
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for ra, rb in zip(before, after) for a, b in zip(ra, rb))
        if not same:
            raise AssertionError(f"round trip of block ({slot}, {logical}) is not bit-exact")
        return {"slot": slot, "logical": logical, "bit_exact": True,
                "bytes": eng._block_bytes}

    def finish(self, eng) -> dict:
        st = eng.stats
        ev = self.events
        if not (ev["wave_admissions"] >= 1 and ev["pressure"] >= 1 and ev["policy"] >= 1):
            raise AssertionError(f"host tier: wave admission, pressure and policy demotion "
                                 f"must all happen; got {ev}")
        if not self.faulted and st.promotions < 1:
            raise AssertionError("host tier: no promotion happened")
        if self.faulted and not (st.promotions == 0 and self.peak_pinned_cold >= 1
                                 and st.retries > 0 and st.degraded_ticks > 0):
            raise AssertionError(f"host tier under promote faults: promotions {st.promotions} "
                                 f"(needs 0), peak pinned cold {self.peak_pinned_cold}, "
                                 f"retries {st.retries}, degraded ticks {st.degraded_ticks} "
                                 f"(need > 0)")
        if st.pcie_bytes != (st.demotions + st.promotions) * eng._block_bytes:
            raise AssertionError(f"pcie_bytes {st.pcie_bytes} != (demotions + promotions) "
                                 f"× {eng._block_bytes}")
        if st.overflows:
            raise AssertionError(f"{st.overflows} overflow stops with the host tier on")
        free = sorted(eng._free_blocks)
        if free != list(range(eng.num_blocks)) or eng._refcount.sum() or eng._spilled:
            raise AssertionError("the pool did not drain: leaked blocks or spilled payloads")
        for pool in eng._state.caches:
            rep = pool.check_invariants(free_blocks=free, host_refcount=eng._refcount)
            if not rep.ok:
                raise AssertionError(f"pool invariants after the run: {rep.violations}")
        rep = eng.check_invariants()
        if not rep.ok:
            raise AssertionError(f"the engine's audit after the run: {rep}")
        return {"spill_events": dict(ev), "roundtrip": self.roundtrip,
                "block_bytes": eng._block_bytes, "peak_pinned_cold": self.peak_pinned_cold,
                "cold_streak_update_ms_per_tick": 1e3 * self.hist_s / max(self.hist_calls, 1)}


def first_divergence(a: list, b: list):
    """(request, step) of the first token where two runs' outputs differ."""
    for i, (x, y) in enumerate(zip(a, b)):
        for j, (u, v) in enumerate(zip(x, y)):
            if u != v:
                return i, j
        if len(x) != len(y):
            return i, min(len(x), len(y))
    return None


def bf16_ulp(row) -> float:
    """One bf16 ulp of a logits row's top logit, 2^(floor(log2|top|) - 7):
    the unit of the gaps that decide the greedy token."""
    import torch
    return 2.0 ** (torch.frexp(row.float().max()).exponent.item() - 8)


def check_contiguous_logits(tokens, trace, picks_c, trace_c, limit=CONTIG_LOGIT_ULPS,
                            label="contiguous vs paged", skip=frozenset()) -> dict:
    """The contiguous run, fed the paged run's tokens, against the paged
    run. Both ticks select the same tokens and their attention differs only
    in summation order, so for every request and every step (the same
    history on both) the two logits rows must agree within
    ``limit`` (CONTIG_LOGIT_ULPS) bf16 ulps of the paged row's top logit;
    ``limit=None`` only reports. Where the two
    greedy picks part, the paged run's top-two gap is printed; it is at
    most twice the rows' difference, so the check holds it to a near-tie.
    Rows in ``skip`` ((request, token) keys) are reported, not gated.
    Returns the largest difference per request, in ulps (gated rows)."""
    worst = {}
    for i, x in enumerate(tokens):
        most, parts = 0.0, []
        for j in range(len(x)):
            a, b = trace[(i, j)].float(), trace_c[(i, j)].float()
            ulp = bf16_ulp(a)
            d = float((a - b).abs().max()) / ulp
            if (i, j) in skip:
                continue
            if limit is not None and not d <= limit:
                raise AssertionError(
                    f"{label}: request {i}, generated token {j}: logits differ "
                    f"by {d:.3g} bf16 ulps of the top logit > {limit}")
            most = max(most, d)
            if picks_c[i][j] != x[j]:
                top2 = a.topk(2).values
                parts.append(f"token {j} ({x[j]} vs {picks_c[i][j]}; paged top-two gap "
                             f"{float(top2[0] - top2[1]) / ulp:.3g} ulps)")
        worst[i] = most
        print(f"{label}, request {i}: logits within {most:.3g} bf16 ulps over "
              f"{len(x)} steps; greedy picks part at "
              f"{', '.join(parts) if parts else 'no step'}", flush=True)
    return worst


def check_bitwise(label: str, tokens, trace, tokens_e, trace_e) -> int:
    """Two runs of the same requests that must agree exactly (the graphed
    paged run and the same built under `steps.eager()`; the shared run and
    its unshared twin): the greedy tokens must be equal and every logits
    row (prefill rows included) bit for bit. Returns the rows compared."""
    import torch
    where = first_divergence(tokens, tokens_e)
    if where is not None:
        raise AssertionError(f"{label}: greedy tokens part at (request, token) {where}")
    if trace.keys() != trace_e.keys():
        raise AssertionError(f"{label}: the runs drew different tokens' rows")
    differ = [k for k in trace if not torch.equal(trace[k], trace_e[k])]
    if differ:
        raise AssertionError(f"{label}: {len(differ)} of {len(trace)} logits rows differ, "
                             f"first at (request, token) {min(differ)}")
    return len(trace)


def check_prefix_sharing(dev, ctx, runs: dict) -> None:
    """Phase 4's prefix-sharing runs (module docstring); adds their launch
    counts to ``runs``."""
    runs["int8 shared"], shared, tokens, trace = serve_main_path(
        dev, shared_prefix=True, prefix_sharing=True, num_blocks=SHARED_BLOCKS)
    print_serve(f"paged int8 + prefix sharing on {SHARED_BLOCKS} blocks", shared)
    runs["int8 shared twin"], twin, tokens_t, trace_t = serve_main_path(dev, shared_prefix=True)
    print_serve("paged int8, the same requests unshared on the default pool", twin)
    runs["int8 shared sharded"], sharded, tokens_s, _ = serve_main_path(
        dev, ctx, shared_prefix=True, prefix_sharing=True, num_blocks=SHARED_BLOCKS)
    print_serve("paged int8 + prefix sharing, sharded (one rank, nccl)", sharded)
    counts = {k: shared[k] for k in SHARED_COUNTS}
    print(f"prefix sharing: {json.dumps(counts)} (predicted {json.dumps(SHARED_COUNTS)}); "
          f"memory_saved_tokens {shared['memory_saved_tokens']}; peak blocks "
          f"{shared['peak_blocks_in_use']} of {SHARED_BLOCKS}, unshared twin "
          f"{twin['peak_blocks_in_use']} of {twin['block_pool_size']}; peak memory GB "
          f"{shared['peak_mem_gb']:.3f} / twin {twin['peak_mem_gb']:.3f}", flush=True)
    if counts != SHARED_COUNTS:
        raise AssertionError(f"prefix sharing: counts {counts} != {SHARED_COUNTS}")
    if (sharded["shared_blocks"], sharded["cow_copies"]) != (counts["shared_blocks"],
                                                             counts["cow_copies"]):
        raise AssertionError(f"prefix sharing, sharded: {sharded}")
    rows = check_bitwise("shared vs unshared twin", tokens, trace, tokens_t, trace_t)
    if (shared["launches_per_tick"], shared["launches_per_replay"]) != (
            twin["launches_per_tick"], twin["launches_per_replay"]):
        raise AssertionError(f"prefix sharing changed the tick: launches per tick "
                             f"{shared['launches_per_tick']} / replay "
                             f"{shared['launches_per_replay']} vs the twin's "
                             f"{twin['launches_per_tick']} / {twin['launches_per_replay']}")
    if first_divergence(tokens, tokens_s) is not None:
        raise AssertionError(f"prefix sharing: the sharded run's tokens differ at (request, "
                             f"token) {first_divergence(tokens, tokens_s)}")
    cow = shared["cow_service"]
    print(f"shared vs unshared twin: greedy tokens identical, {rows} logits rows bit for bit; "
          f"sharded shared tokens identical; TTFT s {shared['mean_ttft_s']:.3f} / twin "
          f"{twin['mean_ttft_s']:.3f}; replay ms (median) {shared['replay_ms_median']:.2f} / twin "
          f"{twin['replay_ms_median']:.2f}; wrapper launches per replay "
          f"{shared['launches_per_replay']} / twin {twin['launches_per_replay']}; copy on "
          f"write: {json.dumps(cow)} unsharded, {json.dumps(sharded['cow_service'])} sharded",
          flush=True)


def serve_scheduler(dev, ctx=None, late=False, hook=None, stops=None, **engine_kw) -> dict:
    """Phase 4's continuous-batching runs: full-width qwen3-0.6b with
    ``salca_static_channels``, the main path's prompts, SCHED_NEW new tokens,
    ``engine_kw`` (``prefill_chunk``, ``preempt``, ``num_blocks``). ``late``:
    requests 0 and 1 are submitted at the start and requests 2 and 3 after
    the SCHED_LATE_TICK-th tick, the engine driven by its own `_admit` and
    `_tick` (the reference battery's way); otherwise all four at the start
    and the same loop. ``hook(engine, reqs, n)`` runs before the first pass
    (n = 0) and after every pass n (the lifecycle run submits and cancels
    there); ``stops`` ({rid: reason}, default "length") the stop reasons the
    run must give. Every kernel's launch counter is set to 0 just before the
    run and read just after. Returns the launches, the summary (with per
    request TTFT and the largest gap between consecutive fresh tokens after
    the capture tick — with ``late``, while the late prompts prefill — ms
    per tick, peak memory, B3's launches at ``q_offset`` > 0), the tokens,
    and every logits row each token was drawn from, per (request, index),
    in the order drawn (a replay draws a row again), with the stop
    reasons, the fault plan's fired log and the audits' results."""
    import dataclasses
    import gc

    import torch
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.models import attention
    from repro_torch.runtime.serve import Request, ServingEngine
    gc.collect()
    torch.cuda.empty_cache()
    cfg, params = main_path_model(dev)
    cfg = dataclasses.replace(cfg, salca_static_channels=True)
    serve = dict(SERVE, **engine_kw)
    warm_up(cfg, params, dev, ctx, serve)

    engine = ServingEngine(cfg, params, device=dev, ctx=ctx, **serve)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in PROMPTS]
    rows: dict = {}
    tick_ms, tick_end = [], []
    orig_decode, orig_activate = engine._decode, engine._activate

    def decode(*a):
        who = [(slot, req.rid, len(req.output)) for slot, req in engine._active.items()
               if engine._mask[slot]]
        t0 = time.perf_counter()
        nxt, logits, finite = orig_decode(*a)
        host = logits.to("cpu", non_blocking=True)
        torch.cuda.synchronize()
        tick_ms.append(1e3 * (time.perf_counter() - t0))
        tick_end.append(time.time())
        for slot, rid, j in who:
            rows.setdefault((rid, j), []).append(host[slot])
        return nxt, logits, finite

    def activate(req, slot, logits_row):
        rows.setdefault((req.rid, len(req.output)), []).append(torch.from_numpy(logits_row))
        return orig_activate(req, slot, logits_row)

    offsets = []
    real_attn = attention.flash_attention_chunked

    def chunked_attn(q, k, v, *, q_offset, **kw):
        offsets.append(q_offset)
        return real_attn(q, k, v, q_offset=q_offset, **kw)

    audit_ms = []

    def audit(real=engine.check_invariants):
        t0 = time.perf_counter()
        rep = real()
        audit_ms.append(1e3 * (time.perf_counter() - t0))
        return rep

    engine._decode, engine._activate, engine.check_invariants = decode, activate, audit
    attention.flash_attention_chunked = chunked_attn
    reqs = [Request(rid=i, prompt=p, max_new_tokens=SCHED_NEW) for i, p in enumerate(prompts)]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t_start = time.time()
    try:
        t_late = None
        for r in reqs[:2] if late else reqs:
            r.submitted = time.time()
            engine.submit(r)
        passes = 0
        if hook is not None:
            hook(engine, reqs, passes)
        while engine._queue or engine._active or engine._inflight is not None:
            engine._admit()
            if engine._active:
                engine._tick()
            passes += 1
            if late and t_late is None and engine.stats.ticks >= SCHED_LATE_TICK:
                t_late = time.time()
                for r in reqs[2:]:
                    r.submitted = t_late
                    engine.submit(r)
            if hook is not None:
                hook(engine, reqs, passes)
    finally:
        attention.flash_attention_chunked = real_attn
    torch.cuda.synchronize()
    wall = time.time() - t_start
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    stats = engine.stats
    summary = stats.summary()
    want_stops = [(stops or {}).get(r.rid, "length") for r in reqs]
    if [r.stop_reason for r in reqs] != want_stops:
        raise AssertionError(f"stop reasons {[r.stop_reason for r in reqs]} != {want_stops}")
    assert stats.completed == sum(r.admitted is not None for r in reqs), summary
    assert stats.admissions == stats.completed + stats.preemptions, summary
    assert all(len(r.output) == SCHED_NEW for r in reqs if r.stop_reason == "length"), summary
    assert all(bool(torch.isfinite(x).all()) for rs in rows.values() for x in rs), \
        "non-finite logits on the continuous-batching path"
    assert sorted(engine._free_blocks) == list(range(engine.num_blocks)) and \
        not engine._refcount.any(), "the pool did not drain"
    if stats.audit_failures or not engine.check_invariants().ok:
        raise AssertionError(f"the audit failed: {engine.last_audit}")
    nl = cfg.num_layers
    tick_kernels = (("paged_score_estimate", "sparse_flash_decode_paged") if ctx is None else
                    ("paged_score_bounds", "paged_fused_select",
                     "sparse_flash_decode_paged_partials"))
    want = {k: nl * stats.ticks for k in tick_kernels}
    want["flash_prefill"] = nl * (stats.prefill_chunks if engine.prefill_chunk else
                                  stats.admissions)
    if launches != want:
        raise AssertionError(f"launch counts {launches} != expected {want}")
    if len(offsets) != want["flash_prefill"]:
        raise AssertionError(f"B3 calls {len(offsets)} != its launches {want['flash_prefill']}")
    if engine._step.graphed != (ctx is None):
        raise AssertionError("every unsharded tick after the first must replay a CUDA graph")
    # gaps between fresh tokens after the capture tick; with late arrivals,
    # those that overlap the late prompts' prefills
    lo = tick_end[1] if late is False else t_late
    hi = max(r.first_token_time for r in reqs[2:]) if late else float("inf")
    gaps = []
    for r in reqs:
        t = r.token_times
        gaps.append(max((1e3 * (b - a) for a, b in zip(t, t[1:]) if b > lo and a < hi),
                        default=0.0))
    summary.update(wall_s=wall, peak_mem_gb=peak, ttft_s=[r.ttft_s for r in reqs],
                   max_gap_ms=gaps, b3_q_offset_launches=sum(o > 0 for o in offsets),
                   graphed=engine._step.graphed, tick_ms=tick_ms,
                   tick_ms_median=float(np.median(tick_ms[2:] if engine._step.graphed
                                                  else tick_ms)),
                   preempted=[r.preemptions for r in reqs],
                   audit_ms_median=float(np.median(audit_ms)) if audit_ms else None,
                   faults=engine._faults.counts() if engine._faults is not None else {})
    return dict(launches=launches, summary=summary, tokens=[r.output for r in reqs], rows=rows,
                stops=[r.stop_reason for r in reqs],
                fired=engine._faults.fired_log if engine._faults is not None else [])


def compare_scheduled(label: str, base: dict, other: dict, whole=None) -> int:
    """A continuous-batching run against run (a), the monolithic twin (or
    another base run): the same greedy tokens, and every logits row the run
    drew (a replayed token's twice) bit for bit equal to the base's row for
    the same request and index. ``whole``: the requests whose tokens must
    be the base's whole (default all of the base's); any other request's
    tokens must be a prefix of the base's (one ended early). Returns the
    rows compared."""
    import torch
    whole = range(len(base["tokens"])) if whole is None else whole
    where = first_divergence([base["tokens"][i] for i in whole],
                             [other["tokens"][i] for i in whole])
    if where is not None:
        raise AssertionError(f"{label}: greedy tokens part from the base's at (request, "
                             f"token) {where}")
    for i, (x, y) in enumerate(zip(base["tokens"], other["tokens"])):
        if y != x[:len(y)]:
            raise AssertionError(f"{label}: request {i}'s tokens are not a prefix of the base's")
    n, differ, worst = 0, [], 0.0
    for key, rs in other["rows"].items():
        want = base["rows"][key][0]
        for r in rs:
            n += 1
            if not torch.equal(r, want):
                differ.append(key)
                worst = max(worst, float((r.float() - want.float()).abs().max())
                            / bf16_ulp(want))
    if differ:
        raise AssertionError(f"{label}: {len(differ)} of {n} logits rows differ from (a)'s, "
                             f"first at (request, token) {min(differ)}, up to {worst:.3g} "
                             f"bf16 ulps")
    return n


def check_scheduler(dev, ctx, runs: dict) -> dict:
    """Phase 4's continuous-batching runs (module docstring); adds their
    launch counts to ``runs``; returns run (b)."""
    a = serve_scheduler(dev, late=True)
    b = serve_scheduler(dev, late=True, prefill_chunk=SCHED_CHUNK)
    c = serve_scheduler(dev, preempt=True, num_blocks=SCHED_PREEMPT_BLOCKS)
    d = serve_scheduler(dev, prefill_chunk=SCHED_CHUNK, preempt=True,
                        num_blocks=SCHED_CHUNK_PREEMPT_BLOCKS)
    e = serve_scheduler(dev, ctx, prefill_chunk=SCHED_CHUNK, preempt=True,
                        num_blocks=SCHED_CHUNK_PREEMPT_BLOCKS)
    labels = {"a": "(a) monolithic, late arrivals, 1,024 blocks",
              "b": f"(b) prefill_chunk={SCHED_CHUNK}, late arrivals, 1,024 blocks",
              "c": f"(c) preempt, {SCHED_PREEMPT_BLOCKS} blocks",
              "d": f"(d) prefill_chunk={SCHED_CHUNK} + preempt, "
                   f"{SCHED_CHUNK_PREEMPT_BLOCKS} blocks",
              "e": "(e) = (d), sharded (one rank, nccl)"}
    keys = ("prefill_chunks", "chunk_stalls", "preemptions", "replayed_tokens", "overflows",
            "admissions", "ticks", "peak_blocks_in_use", "preempted", "b3_q_offset_launches",
            "max_gap_ms", "ttft_s", "tick_ms_median", "decode_ms_per_tick", "peak_mem_gb",
            "wall_s")
    for name, res in zip("abcde", (a, b, c, d, e)):
        sm = res["summary"]
        runs[f"sched {name}"] = res["launches"]
        print(f"scheduler {labels[name]}: {json.dumps({k: sm[k] for k in keys})}", flush=True)
        print(f"serve stats scheduler {name}: {json.dumps(sm)}", flush=True)
    for name, res, gate in (("c", c, ("preemptions", "replayed_tokens")),
                            ("d", d, ("preemptions", "chunk_stalls")),
                            ("e", e, ("preemptions", "chunk_stalls"))):
        sm = res["summary"]
        if sm["overflows"] or not all(sm[k] > 0 for k in gate):
            raise AssertionError(f"scheduler ({name}): overflows {sm['overflows']}, "
                                 f"{ {k: sm[k] for k in gate} }: needs 0 and > 0")
    if not (b["summary"]["prefill_chunks"] > len(PROMPTS)
            and b["summary"]["b3_q_offset_launches"] > 0):
        raise AssertionError("scheduler (b): the prompts were not chunked")
    compared = {name: compare_scheduled(labels[name], a, res)
                for name, res in (("b", b), ("c", c), ("d", d))}
    if first_divergence(a["tokens"], e["tokens"]) is not None:
        raise AssertionError(f"scheduler (e): tokens part from (a)'s at (request, token) "
                             f"{first_divergence(a['tokens'], e['tokens'])}")
    sa, sb = a["summary"], b["summary"]
    print(f"scheduler: (b), (c), (d) against (a): greedy tokens identical, logits rows bit "
          f"for bit {json.dumps(compared)}; (e) tokens identical. Largest gap between fresh "
          f"tokens of requests 0 and 1 while requests 2 and 3 prefill: (a) "
          f"{sa['max_gap_ms'][0]:.1f} / {sa['max_gap_ms'][1]:.1f} ms, (b) "
          f"{sb['max_gap_ms'][0]:.1f} / {sb['max_gap_ms'][1]:.1f} ms; TTFT of requests 2 and 3: "
          f"(a) {sa['ttft_s'][2]:.3f} / {sa['ttft_s'][3]:.3f} s, (b) {sb['ttft_s'][2]:.3f} / "
          f"{sb['ttft_s'][3]:.3f} s; replay ms (median) (a) {sa['tick_ms_median']:.2f}, (b) "
          f"{sb['tick_ms_median']:.2f}; peak memory GB (a) {sa['peak_mem_gb']:.3f}, (b) "
          f"{sb['peak_mem_gb']:.3f}", flush=True)
    return b


def sched_faults():
    """Run (g)'s fault plan, built anew for each engine that takes it: the
    allocator reports an empty pool (p 0.3, at most 4 times), a chunk step
    fails (p 0.3, at most 3), and request 1's logits row is poisoned once,
    after its 5th opportunity."""
    from repro_torch.runtime.faults import FaultPlan, FaultSpec
    return FaultPlan(seed=0, specs=(
        FaultSpec("alloc_exhausted", p=0.3, max_fires=4),
        FaultSpec("prefill_chunk", p=0.3, max_fires=3),
        FaultSpec("decode_logits", p=1.0, rids=(1,), after=5, max_fires=1)))


def poison_after(after: int, rid: int):
    """A hook of `serve_main_path`: after the engine's ``after``-th decode,
    write NaN into every V code of request ``rid``'s blocks in layer 0 of
    an fp16 pool, in place (the graph reads them at its captured
    addresses)."""
    def hook(engine):
        real = engine._tick

        def tick():
            real()
            if engine.stats.ticks == after and not engine._poisoned:
                slot = next(s for s, r in engine._active.items() if r.rid == rid)
                blocks = [b for b in engine._slot_blocks[slot] if b >= 0]
                engine._state.caches[0].data["v_codes"][blocks] = float("nan")
                engine._poisoned = blocks

        engine._poisoned = None
        engine._tick = tick
    return hook


def lifecycle_hook(prompt_len: int):
    """Run (i)'s hook of `serve_scheduler`: before the first pass the queue
    holds the four prompts, so a fifth request (rid 4) is shed by
    ``max_queue=4``; after the first pass (request 0 in flight) a sixth
    (rid 5) with ``deadline_ms=1`` joins the queue behind three prompts and
    expires there; request 3 is cancelled once its chunked prefill has run
    a chunk."""
    from repro_torch.runtime.serve import Request
    prompts = np.random.default_rng(2).integers(0, 1000, (2, prompt_len)).astype(np.int32)

    def hook(engine, reqs, n):
        if n == 0:
            reqs.append(Request(rid=4, prompt=prompts[0], max_new_tokens=SCHED_NEW))
            if engine.submit(reqs[-1]):
                raise AssertionError("lifecycle: a fifth request was not shed")
        elif n == 1:
            reqs.append(Request(rid=5, prompt=prompts[1], max_new_tokens=SCHED_NEW,
                                deadline_ms=1.0))
            if not engine.submit(reqs[-1]):
                raise AssertionError("lifecycle: the sixth request was shed")
        inf = engine._inflight
        if inf is not None and inf.req.rid == 3 and inf.consumed > 0:
            engine.cancel(3)
    return hook


def check_lifecycle(dev, ctx, runs: dict, main_tokens, fp16, b: dict) -> None:
    """Phase 4's lifecycle and fault runs (f)-(k) (module docstring); adds
    their launch counts to ``runs``. ``main_tokens``: the greedy main run's
    tokens; ``fp16``: the clean fp16 run's (tokens, rows); ``b``: run (b)."""
    import torch
    from repro_torch.runtime.faults import FaultPlan, FaultSpec
    # (f) sampling, graphed and eager
    temps = (0.8, 0.0, 0.8, 0.0)
    runs["f sampled"], f, tok_f, rows_f = serve_main_path(dev, greedy=False, seed=0,
                                                          temperatures=temps)
    print_serve("(f) sampled, temperatures 0.8 / 0 / 0.8 / 0, seed 0", f)
    runs["f sampled eager"], f_e, tok_fe, rows_fe = serve_main_path(
        dev, eager_run=True, greedy=False, seed=0, temperatures=temps)
    print_serve("(f) sampled, eager (built under steps.eager())", f_e)
    n_f = check_bitwise("(f) sampled graphed vs eager", tok_f, rows_f, tok_fe, rows_fe)
    if [tok_f[1], tok_f[3]] != [main_tokens[1], main_tokens[3]]:
        raise AssertionError("(f): the temperature-0 requests part from the greedy run: "
                             f"{first_divergence([main_tokens[1], main_tokens[3]], [tok_f[1], tok_f[3]])}")
    row = torch.stack([rows_f[(0, 1)]] * 4).to(dev)
    copy_ms = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        row.float().cpu().numpy()
        copy_ms.append(1e3 * (time.perf_counter() - t0))
    print(f"(f) sampled: graphed vs eager tokens identical, {n_f} logits rows bit for bit; "
          f"requests 1 and 3 (temperature 0) equal the greedy run's tokens; requests 0 and 2 "
          f"part from it at {first_divergence(main_tokens, tok_f)}; host ms per sampled token "
          f"(float64 gumbel over {rows_f[(0, 0)].numel()} columns + argmax) median "
          f"{np.median(f['sample_ms']):.3f} over {len(f['sample_ms'])}; logits copy (4 rows, "
          f"bf16 → f32 → host) median {np.median(copy_ms):.3f} ms; replay ms (median) "
          f"{f['replay_ms_median']:.2f} against the greedy run's", flush=True)
    # (g) faults on (b)'s engine, audited every tick
    g = serve_scheduler(dev, late=True, prefill_chunk=SCHED_CHUNK, audit_every=1,
                        faults=sched_faults(), stops={1: "error"})
    runs["g faults"] = g["launches"]
    n_g = compare_scheduled("(g) faults vs (b)", b, g, whole=(0, 2, 3))
    sg, sb = g["summary"], b["summary"]
    keys = ("faults", "faults_injected", "errors", "retries", "degraded_ticks", "chunk_stalls",
            "audits", "audit_failures", "audit_ms_median", "ticks", "prefill_chunks",
            "max_gap_ms", "ttft_s", "tick_ms_median", "wall_s")
    print(f"(g) faults on (b)'s engine: {json.dumps({k: sg.get(k) for k in keys})}; stops "
          f"{g['stops']}; requests 0, 2, 3 give (b)'s tokens, {n_g} logits rows bit for bit; "
          f"(b): largest gap {sb['max_gap_ms']}, TTFT {sb['ttft_s']}, wall {sb['wall_s']:.3f} s",
          flush=True)
    print(f"serve stats (g): {json.dumps(sg)}", flush=True)
    if not (sg["faults"].get("alloc_exhausted") and sg["faults"].get("prefill_chunk")
            and sg["errors"] == 1 and sg["audits"] == sg["ticks"]):
        raise AssertionError(f"(g): every site must fire, one error, an audit per tick: {sg}")
    # (h) a real NaN through the graph's finite output
    runs["h nan"], h, tok_h, rows_h = serve_main_path(
        dev, kv_pool_dtype="fp16", hook=poison_after(5, 2), stops={2: "error"})
    print_serve("(h) fp16, NaN in request 2's V codes of layer 0 after the 5th tick", h)
    dropped = [t for t, fl in enumerate(h["finite"]) if not all(fl.values())]
    if not (h["errors"] == 1 and "faults_injected" not in h and len(dropped) == 1
            and dropped[0] >= 2 and h["nonfinite_rows"] == [(2, len(tok_h[2]))]):
        raise AssertionError(f"(h): the NaN must drop one flag of request 2 on a replayed "
                             f"tick and end it with an error: ticks {dropped}, "
                             f"{h['nonfinite_rows']}, {h['errors']} errors")
    tok_c, rows_c = fp16
    others = {k: r for k, r in rows_h.items() if k not in h["nonfinite_rows"]}
    n_h = check_bitwise("(h) vs the clean fp16 run",
                        [tok_h[i] for i in (0, 1, 3)], others,
                        [tok_c[i] for i in (0, 1, 3)], {k: rows_c[k] for k in others})
    if tok_h[2] != tok_c[2][:len(tok_h[2])]:
        raise AssertionError("(h): request 2's tokens before the NaN part from the clean run")
    print(f"(h) real NaN: request 2 stopped 'error' on tick {dropped[0]} (a graph replay; "
          f"finite {h['finite'][dropped[0]]}); requests 0, 1, 3 and request 2 before the "
          f"NaN: {n_h} logits rows bit for bit with the clean fp16 run", flush=True)
    # (i) the lifecycle on (b)'s engine
    i_run = serve_scheduler(dev, prefill_chunk=SCHED_CHUNK, max_queue=4, audit_every=1,
                            hook=lifecycle_hook(PROMPTS[0]),
                            stops={3: "cancelled", 4: "rejected", 5: "deadline"})
    runs["i lifecycle"] = i_run["launches"]
    si = i_run["summary"]
    n_i = compare_scheduled("(i) lifecycle vs (b)", b, dict(i_run, tokens=i_run["tokens"][:4]),
                            whole=(0, 1, 2))
    if (si["cancellations"], si["rejections"], si["deadline_stops"]) != (1, 1, 1):
        raise AssertionError(f"(i): one cancel, one shed, one deadline expected: {si}")
    print(f"(i) lifecycle: stops {i_run['stops']}; cancellations / rejections / deadline "
          f"stops {si['cancellations']} / {si['rejections']} / {si['deadline_stops']}; "
          f"admissions {si['admissions']} = completed {si['completed']}; audits "
          f"{si['audits']} clean; requests 0-2 give (b)'s tokens, {n_i} rows bit for bit; "
          f"the pool drained", flush=True)
    # (j) host-tier transfer retries: every promotion fails
    plan_j = FaultPlan(seed=0, specs=(FaultSpec("spill_transfer", p=1.0, direction="promote"),))
    runs["j spill faults"], j, _, _ = serve_main_path(
        dev, probe=SpillProbe(faulted=True), faults=plan_j, spill_max_retries=1,
        audit_every=1, **SPILL_RUN)
    print_serve(f"(j) int4 + host spill, every promotion failing, spill_max_retries=1", j)
    print(f"(j) spill retries: {json.dumps({k: j.get(k) for k in ('retries', 'degraded_ticks', 'demotions', 'promotions', 'faults_injected', 'audits', 'audit_failures', 'peak_pinned_cold', 'spill_events')})}",
          flush=True)
    # (k) = (g) at one nccl rank
    k = serve_scheduler(dev, ctx, late=True, prefill_chunk=SCHED_CHUNK, audit_every=1,
                        faults=sched_faults(), stops={1: "error"})
    runs["k faults sharded"] = k["launches"]
    if (k["tokens"], k["stops"], k["fired"]) != (g["tokens"], g["stops"], g["fired"]):
        raise AssertionError(f"(k): tokens, stops or faults part from (g)'s: {k['stops']}, "
                             f"{first_divergence(g['tokens'], k['tokens'])}")
    print(f"(k) = (g) sharded (one rank, nccl): tokens, stop reasons and the {len(k['fired'])} "
          f"fired faults equal (g)'s; ms per tick (median) {k['summary']['tick_ms_median']:.2f}",
          flush=True)


def cache_prompts(vocab_size: int) -> list:
    """The visit trace's four prompts from seed 0, tenant-major: per tenant
    a CACHE_HEADER-token header and two users' CACHE_TAIL-token tails."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(2):
        header = rng.integers(0, vocab_size, CACHE_HEADER).astype(np.int32)
        out += [np.concatenate([header, rng.integers(0, vocab_size, CACHE_TAIL).astype(np.int32)])
                for _ in range(2)]
    return out


def serve_visits(dev, visits, ctx=None, params=None, **engine_kw) -> dict:
    """Phase 4's persistent-prefix-cache runs: full-width qwen3-0.6b with
    ``salca_static_channels`` (``params``: another tree, e.g. a calibrated
    one) serves `cache_prompts` in the order ``visits``, each request
    submitted alone once the engine drained, NEW_TOKENS new tokens each;
    ``engine_kw`` adds ``prefix_sharing``, ``prefix_cache``, ``num_blocks``,
    ``host_spill``, ``prefill_chunk``, ``preempt``. Every kernel's launch
    counter is set to 0 just before and read just after. Each adoption is
    timed between two synchronizations, and so is each demotion and
    rehydration of the cold tier. The engine's cache is then flushed: the
    pool must drain whole and audit clean. Returns the launches, the
    summary (with per-visit TTFT, each tick's ms, the replay median, the
    adoption, demotion and rehydration ms), the tokens, and every logits
    row each token was drawn from per (visit, index) (index 0: the
    prefill's or the kept row)."""
    import dataclasses
    import gc

    import torch
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.runtime.serve import Request, ServingEngine
    gc.collect()
    torch.cuda.empty_cache()
    cfg, base = main_path_model(dev)
    cfg = dataclasses.replace(cfg, salca_static_channels=True)
    params = base if params is None else params
    serve = dict(SERVE, **engine_kw)
    warm_up(cfg, params, dev, ctx, serve)
    engine = ServingEngine(cfg, params, device=dev, ctx=ctx, **serve)
    prompts = cache_prompts(cfg.vocab_size)
    rows, tick_ms, prefills, timed = {}, [], [0], {"adopt": [], "demote": [], "promote": []}
    orig_decode, orig_activate, orig_prefill = engine._decode, engine._activate, engine._prefill

    def decode(*a):
        who = [(slot, req.rid, len(req.output)) for slot, req in engine._active.items()
               if engine._mask[slot]]
        t0 = time.perf_counter()
        nxt, logits, finite = orig_decode(*a)
        host = logits.to("cpu", non_blocking=True)
        torch.cuda.synchronize()
        tick_ms.append(1e3 * (time.perf_counter() - t0))
        for slot, rid, j in who:
            rows[(rid, j)] = host[slot]
        return nxt, logits, finite

    def activate(req, slot, logits_row):
        rows[(req.rid, len(req.output))] = torch.from_numpy(np.array(logits_row))
        return orig_activate(req, slot, logits_row)

    def prefill(req):
        prefills[0] += 1
        return orig_prefill(req)

    def synced(name, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            timed[name].append(1e3 * (time.perf_counter() - t0))
            return out
        return call

    engine._decode, engine._activate, engine._prefill = decode, activate, prefill
    if engine._adopt is not None:
        engine._adopt = synced("adopt", engine._adopt)
    engine._demote_cache_block = synced("demote", engine._demote_cache_block)
    # a rehydration's transfer (its demotion to make room, if any, is timed apart)
    engine.api = engine.api._replace(write_block=synced("promote", engine.api.write_block))
    policy, real_demote = [], engine.demote_block

    def demote_block(*a, **kw):            # a policy or pressure demotion of a slot's block
        policy.append(a)
        return real_demote(*a, **kw)

    engine.demote_block = demote_block
    reqs = []
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t_start = time.time()
    for rid, v in enumerate(visits):
        reqs.append(Request(rid=rid, prompt=prompts[v].copy(), max_new_tokens=NEW_TOKENS))
        engine.submit(reqs[-1])
        engine.run()
    torch.cuda.synchronize()
    wall = time.time() - t_start
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    stats = engine.stats
    summary = stats.summary()
    if [r.stop_reason for r in reqs] != ["length"] * len(reqs) or \
            not all(len(r.output) == NEW_TOKENS for r in reqs):
        raise AssertionError(f"visits: stop reasons {[r.stop_reason for r in reqs]}")
    if not all(bool(torch.isfinite(x).all()) for x in rows.values()):
        raise AssertionError("non-finite logits on the prefix-cache path")
    if stats.overflows or stats.preemptions or policy:
        raise AssertionError(f"visits: overflows {stats.overflows}, preemptions "
                             f"{stats.preemptions}, policy demotions {len(policy)}: need 0")
    rep = engine.check_invariants()
    flushed = engine.flush_prefix_cache()
    if not (rep.ok and engine.check_invariants().ok
            and sorted(engine._free_blocks) == list(range(engine.num_blocks))
            and not engine._refcount.any() and not engine._prefix_nodes):
        raise AssertionError(f"visits: the audit or the flushed pool is not clean: {rep}")
    nl = cfg.num_layers
    tick_kernels = (("paged_score_estimate", "sparse_flash_decode_paged") if ctx is None else
                    ("paged_score_bounds", "paged_fused_select",
                     "sparse_flash_decode_paged_partials"))
    want = {k: nl * stats.ticks for k in tick_kernels}
    want["flash_prefill"] = nl * (prefills[0] + stats.prefill_chunks)
    if launches != want:
        raise AssertionError(f"launch counts {launches} != expected {want}")
    if engine._step.graphed != (ctx is None):
        raise AssertionError("every unsharded tick after the first must replay a CUDA graph")
    summary.update(wall_s=wall, peak_mem_gb=peak, ttft_s=[r.ttft_s for r in reqs],
                   prefills=prefills[0], flushed=flushed, tick_ms=tick_ms,
                   graphed=engine._step.graphed,
                   tick_ms_median=float(np.median(tick_ms[2:] if engine._step.graphed
                                                  else tick_ms)),
                   adopt_ms=timed["adopt"], demote_ms=timed["demote"],
                   promote_ms=timed["promote"],
                   block_bytes=getattr(engine, "_block_bytes", None),
                   launches_per_replay=(sum(engine._step.launches_per_tick.values())
                                        if engine._step.launches_per_tick else None))
    return dict(launches=launches, summary=summary, tokens=[r.output for r in reqs], rows=rows)


def check_visit_counts(label: str, sm: dict, want: dict) -> None:
    got = {k: sm.get(k, 0) for k in want}
    print(f"{label}: counts {json.dumps(got)} (predicted {json.dumps(want)})", flush=True)
    if got != want:
        raise AssertionError(f"{label}: counts {got} != predicted {want}")


def ttft_medians(sm: dict) -> tuple:
    """The first and second passes' median TTFT (s) and their ratio."""
    n = len(sm["ttft_s"]) // 2
    cold, warm = float(np.median(sm["ttft_s"][:n])), float(np.median(sm["ttft_s"][n:]))
    return cold, warm, warm / cold


def profile_adoption(dev, cfg, params) -> dict:
    """One zero-prefill adoption over every layer, eager, under the
    profiler: its launches on the device and its host ms between two
    synchronizations (the first tenant's user 0 served, then adopted)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.serve import Request, ServingEngine
    engine = ServingEngine(cfg, params, device=dev, prefix_sharing=True, prefix_cache=True,
                           num_blocks=CACHE_BLOCKS, **SERVE)
    prompt = cache_prompts(cfg.vocab_size)[0]
    engine.submit(Request(rid=0, prompt=prompt.copy(), max_new_tokens=2))
    engine.run()
    out, real = {}, engine._adopt

    def adopt(*a):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = real(*a)
            torch.cuda.synchronize()
            out["ms"] = 1e3 * (time.perf_counter() - t0)
        out["launches"] = sum(e.device_type == DeviceType.CUDA for e in prof.events())
        return res

    engine._adopt = adopt
    engine.submit(Request(rid=1, prompt=prompt.copy(), max_new_tokens=2))
    engine.run()
    if engine.stats.zero_prefill_hits != 1 or "ms" not in out:
        raise AssertionError(f"adoption profile: no zero-prefill hit ({engine.stats})")
    engine.flush_prefix_cache()
    return out


def check_prefix_cache(dev, ctx, runs: dict) -> None:
    """Phase 4's persistent-prefix-cache runs (l)-(q) (module docstring);
    adds their launch counts to ``runs``."""
    import dataclasses

    import torch
    from repro_torch.models.registry import get_model
    cache = dict(prefix_sharing=True, prefix_cache=True)
    keys = ("cache_hits", "cache_hit_blocks", "zero_prefill_hits", "cache_evictions",
            "peak_cache_blocks", "prefills", "prefill_chunks", "ticks", "tick_ms_median",
            "adopt_ms", "ttft_s", "peak_mem_gb", "wall_s")
    out = {}
    for name, label, visits, kw in (
            ("l", f"(l) prefix cache, {CACHE_BLOCKS} blocks", CACHE_VISITS,
             dict(cache, num_blocks=CACHE_BLOCKS)),
            ("l twin", f"(l)'s cold twin, prefix sharing only, {CACHE_BLOCKS} blocks",
             CACHE_VISITS, dict(prefix_sharing=True, num_blocks=CACHE_BLOCKS)),
            ("m", f"(m) prefix cache, {CACHE_TIGHT_BLOCKS} blocks", CACHE_VISITS,
             dict(cache, num_blocks=CACHE_TIGHT_BLOCKS)),
            ("m twin", f"(m)'s cold twin, {CACHE_TIGHT_BLOCKS} blocks", CACHE_VISITS,
             dict(prefix_sharing=True, num_blocks=CACHE_TIGHT_BLOCKS)),
            ("n", f"(n) prefix cache + host spill, {CACHE_TIGHT_BLOCKS} blocks", CACHE_VISITS,
             dict(cache, num_blocks=CACHE_TIGHT_BLOCKS, host_spill=True)),
            ("o", f"(o) = (l) with prefill_chunk={SCHED_CHUNK}, preempt", CACHE_VISITS,
             dict(cache, num_blocks=CACHE_BLOCKS, prefill_chunk=SCHED_CHUNK, preempt=True)),
            ("o twin", "(o)'s chunked cold twin", CACHE_VISITS,
             dict(prefix_sharing=True, num_blocks=CACHE_BLOCKS, prefill_chunk=SCHED_CHUNK,
                  preempt=True))):
        out[name] = res = serve_visits(dev, visits, **kw)
        runs[f"cache {name}"] = res["launches"]
        sm = res["summary"]
        print(f"{label}: {json.dumps({k: sm.get(k) for k in keys})}", flush=True)
        print(f"serve stats {name}: {json.dumps(sm)}", flush=True)
    l, lt, m, mt, n, o, ot = (out[k] for k in ("l", "l twin", "m", "m twin", "n", "o",
                                               "o twin"))
    # (l): bit for bit, the counts, the TTFT gate, the replay against the twin's
    check_visit_counts("(l)", l["summary"], CACHE_COUNTS["l"])
    n_l = check_bitwise("(l) cache vs cold twin", l["tokens"], l["rows"], lt["tokens"],
                        lt["rows"])
    cold, warm, ratio = ttft_medians(l["summary"])
    cold_t, warm_t, ratio_t = ttft_medians(lt["summary"])
    sl, slt = l["summary"], lt["summary"]
    print(f"(l) cache vs cold twin: tokens identical, {n_l} logits rows bit for bit; median "
          f"TTFT first pass {cold * 1e3:.2f} ms, second pass {warm * 1e3:.2f} ms, ratio "
          f"{ratio:.4f} (gate {CACHE_TTFT_RATIO}); twin {cold_t * 1e3:.2f} / "
          f"{warm_t * 1e3:.2f} ms ({ratio_t:.4f}); adoption ms {sl['adopt_ms']}; replay ms "
          f"(median) {sl['tick_ms_median']:.3f} / twin {slt['tick_ms_median']:.3f}; wrapper "
          f"launches per replay {sl['launches_per_replay']} / twin "
          f"{slt['launches_per_replay']}; prefills {sl['prefills']} / twin {slt['prefills']}; "
          f"prefill_s {sl['prefill_s']:.3f} / twin {slt['prefill_s']:.3f}", flush=True)
    if ratio > CACHE_TTFT_RATIO:
        raise AssertionError(f"(l): second-pass median TTFT {ratio:.3f}× the first pass's "
                             f"> {CACHE_TTFT_RATIO}")
    # (m), (n): bit for bit against (m)'s twin, evictions / demotions as predicted
    check_visit_counts("(m)", m["summary"], CACHE_COUNTS["m"])
    n_m = check_bitwise("(m) cache vs cold twin", m["tokens"], m["rows"], mt["tokens"],
                        mt["rows"])
    check_visit_counts("(n)", n["summary"], CACHE_COUNTS["n"])
    n_n = check_bitwise("(n) cache + host spill vs (m)'s twin", n["tokens"], n["rows"],
                        mt["tokens"], mt["rows"])
    sn = n["summary"]
    moves = sn["demotions"] + sn["promotions"]
    if sn["pcie_bytes"] != moves * sn["block_bytes"] or sn["promotions"] < 1 \
            or len(sn["demote_ms"]) != sn["demotions"]:
        raise AssertionError(f"(n): pcie_bytes {sn['pcie_bytes']} != {moves} moves × "
                             f"{sn['block_bytes']} B, or no promotion")
    cold_n, warm_n, ratio_n = ttft_medians(sn)
    cold_m, warm_m, ratio_m = ttft_medians(m["summary"])
    print(f"(m) cache vs cold twin: tokens identical, {n_m} logits rows bit for bit; median "
          f"TTFT {cold_m * 1e3:.2f} / {warm_m * 1e3:.2f} ms ({ratio_m:.4f}). (n) host spill "
          f"vs (m)'s twin: tokens identical, {n_n} rows bit for bit; median TTFT "
          f"{cold_n * 1e3:.2f} / {warm_n * 1e3:.2f} ms ({ratio_n:.4f}); block bytes "
          f"{sn['block_bytes']}; demotions {sn['demotions']} (every one a pin's), promotions "
          f"{sn['promotions']}, pcie_bytes {sn['pcie_bytes']}; ms per demotion median "
          f"{np.median(sn['demote_ms']):.3f} (max {max(sn['demote_ms']):.3f}), per "
          f"rehydration median {np.median(sn['promote_ms']):.3f} (max "
          f"{max(sn['promote_ms']):.3f}), both between two synchronizations", flush=True)
    # (o): chunked, bit for bit against its chunked twin; against (l)'s twin printed
    check_visit_counts("(o)", o["summary"], CACHE_COUNTS["l"])
    n_o = check_bitwise("(o) chunked cache vs chunked twin", o["tokens"], o["rows"],
                        ot["tokens"], ot["rows"])
    same = (o["tokens"] == lt["tokens"]
            and all(torch.equal(o["rows"][k], lt["rows"][k]) for k in lt["rows"]))
    print(f"(o) chunked cache vs its chunked twin: tokens identical, {n_o} rows bit for bit; "
          f"equal to (l)'s monolithic twin: {same}; median TTFT "
          f"{ttft_medians(o['summary'])[0] * 1e3:.2f} / "
          f"{ttft_medians(o['summary'])[1] * 1e3:.2f} ms", flush=True)
    # (p): the first tenant at one nccl rank: user 0, user 1, user 0 again
    p = serve_visits(dev, (0, 1, 0), ctx, **cache, num_blocks=CACHE_BLOCKS)
    pt = serve_visits(dev, (0, 1, 0), ctx, prefix_sharing=True, num_blocks=CACHE_BLOCKS)
    runs["cache p sharded"], runs["cache p twin"] = p["launches"], pt["launches"]
    sp = p["summary"]
    print(f"serve stats p: {json.dumps(sp)}", flush=True)
    n_p = check_bitwise("(p) sharded cache vs sharded cold twin", p["tokens"], p["rows"],
                        pt["tokens"], pt["rows"])
    if p["tokens"] != [l["tokens"][i] for i in (0, 1, 4)] or sp["zero_prefill_hits"] != 1:
        raise AssertionError(f"(p): tokens part from (l)'s or no zero-prefill hit: {sp}")
    print(f"(p) sharded (one rank, nccl) cache vs its cold twin: {n_p} logits rows bit for "
          f"bit; tokens equal (l)'s; zero-prefill hits {sp['zero_prefill_hits']}; TTFT s "
          f"{sp['ttft_s']}; ms per tick (median) {sp['tick_ms_median']:.2f}", flush=True)
    # (q): calibrated static sets on the card, then (p)'s visits unsharded
    cfg, params = main_path_model(dev)
    cfg = dataclasses.replace(cfg, salca_static_channels=True)
    api = get_model(cfg)
    tokens = torch.from_numpy(np.stack([r.prompt[:2048] for r in
                                        main_path_requests(cfg.vocab_size)])).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calibrated = api.calibrate(params, tokens)
    torch.cuda.synchronize()
    calib_ms = 1e3 * (time.perf_counter() - t0)
    base = api.static_heavy(params, SERVE["max_seq"])
    sets = api.static_heavy(calibrated, SERVE["max_seq"])
    r = base[0].shape[-1]
    moved = [int(r * base[0].shape[1] - sum(
        len(set(a.tolist()) & set(b.tolist())) for a, b in zip(x[0], y[0])))
        for x, y in zip(base, sets)]
    q = serve_visits(dev, (0, 1, 0), params=calibrated, **cache, num_blocks=CACHE_BLOCKS)
    qt = serve_visits(dev, (0, 1, 0), params=calibrated, prefix_sharing=True,
                      num_blocks=CACHE_BLOCKS)
    runs["cache q"], runs["cache q twin"] = q["launches"], qt["launches"]
    n_q = check_bitwise("(q) calibrated cache vs cold twin", q["tokens"], q["rows"],
                        qt["tokens"], qt["rows"])
    if q["summary"]["zero_prefill_hits"] != 1:
        raise AssertionError(f"(q): zero-prefill hits {q['summary']['zero_prefill_hits']} != 1")
    prof = profile_adoption(dev, cfg, params)
    print(f"(q) calibrate over (4, 2048) on the card: {calib_ms:.1f} ms; channels of the "
          f"{base[0].shape[1]}×{r} per layer that differ from the weight-mass sets: {moved}; "
          f"calibrated cache vs cold twin: {n_q} logits rows bit for bit, zero-prefill hits 1; "
          f"one adoption over {cfg.num_layers} layers, eager, profiled: "
          f"{prof['launches']} launches, {prof['ms']:.3f} ms", flush=True)


def check_dense_configs(dev, runs: dict) -> tuple:
    """Phase 4's other dense configs (module docstring, runs (r)-(u)), one
    model on the card at a time; adds their launch counts to ``runs``.
    Returns run (r)'s (tokens, rows, summary)."""
    import gc

    import torch
    from repro_torch.models.blocks import ring_size
    model = config_model(dev, GEMMA)
    cfg = model[0]
    rings = sum(ring_size(cfg, kind, SERVE["max_seq"]) < SERVE["max_seq"]
                for kind in cfg.block_kinds())
    kw = dict(model=model, prompts=PROMPTS, new_tokens=NEW_TOKENS, profile_tick=PROFILE_TICK)
    runs["gemma3"], sum_r, tok_r, tr_r = serve_main_path(dev, **kw)
    print_serve(f"(r) paged int8, {rings} ring layers of {cfg.local_window}", sum_r, GEMMA)
    runs["gemma3 eager"], sum_s, tok_s, tr_s = serve_main_path(dev, eager_run=True, **kw)
    print_serve("(s) paged int8, eager (built under steps.eager())", sum_s, GEMMA)
    rows = check_bitwise(f"{GEMMA} graphed vs eager", tok_r, tr_r, tok_s, tr_s)
    print(f"{GEMMA} (s) = (r): greedy tokens identical, {rows} logits rows bit for bit; ms "
          f"per tick eager {np.median(sum_s['tick_ms']):.2f}, graphed replay "
          f"{sum_r['replay_ms_median']:.2f} (median); wrapper launches per replay "
          f"{sum_r['launches_per_replay']}", flush=True)
    runs["gemma3 contiguous"], sum_t, picks_t, tr_t = serve_main_path(
        dev, paged=False, force=dict(enumerate(tok_r)), **kw)
    print_serve("(t) contiguous (teacher-forced on (r)'s tokens)", sum_t, GEMMA)
    worst = check_contiguous_logits(tok_r, tr_r, picks_t, tr_t, limit=None,
                                    label=f"{GEMMA} (t) contiguous vs (r) paged")
    finite = all(bool(torch.isfinite(r).all()) for r in (*tr_r.values(), *tr_t.values()))
    if not finite:
        raise AssertionError(f"{GEMMA}: non-finite logits")
    print(f"{GEMMA} (t) vs (r): every logits row within {max(worst.values()):.3g} bf16 ulps "
          f"of the top logit (reported, not a gate); every row finite", flush=True)
    del model
    for arch in DENSE_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        model = config_model(dev, arch)
        kw = dict(model=model, prompts=DENSE_PROMPTS, new_tokens=DENSE_NEW_TOKENS,
                  slots=DENSE_SLOTS, profile_tick=PROFILE_TICK)
        runs[arch], sum_u, tok_u, tr_u = serve_main_path(dev, **kw)
        print_serve(f"(u) paged int8, {DENSE_SLOTS} slots", sum_u, arch)
        runs[f"{arch} eager"], sum_ue, tok_ue, tr_ue = serve_main_path(dev, eager_run=True,
                                                                       **kw)
        print_serve("(u) paged int8, eager (built under steps.eager())", sum_ue, arch)
        rows = check_bitwise(f"{arch} graphed vs eager", tok_u, tr_u, tok_ue, tr_ue)
        print(f"{arch} (u): graphed = eager, greedy tokens identical, {rows} logits rows bit "
              f"for bit; ms per tick eager {np.median(sum_ue['tick_ms']):.2f}, graphed replay "
              f"{sum_u['replay_ms_median']:.2f} (median); wrapper launches per replay "
              f"{sum_u['launches_per_replay']}", flush=True)
        del model
    gc.collect()
    torch.cuda.empty_cache()
    return tok_r, tr_r, sum_r


class CapProbe:
    """Run (v)'s record of where the flat tick keeps more than the unsharded
    tick can: a ``with`` block routes `models.blocks.sp_salca_decode`
    through a wrapper that keeps each call's Selection counts (on the card,
    read after the run), and `install` (a `serve_main_path` hook) opens one
    record per tick of the measured engine with its slots' (slot, request,
    tokens so far). A row whose count passed ``k_cap`` kept tokens that the
    unsharded tick's capacity cuts (one rank's capacity is 4·k_cap)."""

    def __init__(self, k_cap: int):
        self.k_cap, self.ticks = k_cap, []

    def __enter__(self):
        from repro_torch.models import blocks
        self._real = blocks.sp_salca_decode

        def counting(*a, **kw):
            out, sel = self._real(*a, return_selection=True, **kw)
            if self.ticks:
                self.ticks[-1][1].append(sel.count.amax(-1))
            return out

        blocks.sp_salca_decode = counting
        return self

    def __exit__(self, *exc):
        from repro_torch.models import blocks
        blocks.sp_salca_decode = self._real

    def install(self, engine) -> None:
        inner = engine._decode

        def decode(tokens, mask):
            who = [(slot, req.rid, len(req.output)) for slot, req in engine._active.items()
                   if mask[slot]]
            self.ticks.append((who, []))
            return inner(tokens, mask)

        engine._decode = decode

    def over(self) -> tuple[set, list]:
        """(the (request, token) rows from each request's first tick over
        k_cap on, whose histories part from the unsharded run's; the (tick,
        request, token, kept) of every tick over it)."""
        import torch
        first, events = {}, []
        for t, (who, counts) in enumerate(self.ticks):
            kept = torch.stack(counts).amax(0).cpu()                  # (slots,)
            for slot, rid, j in who:
                if int(kept[slot]) > self.k_cap:
                    first.setdefault(rid, j)
                    events.append((t, rid, j, int(kept[slot])))
        rows = {(rid, j) for rid, j0 in first.items() for j in range(j0, j0 + 10 ** 4)}
        return rows, events


def ring_layer_ms(dev, model, iters=20) -> dict:
    """The attention of gemma3-12b's first "L" layer on the main path's
    slots and lengths, on random contents, by `graph_ms` (its eager calls
    are host-bound): over its ring of W rows (`attn_decode_contiguous`), and
    with ``ring_local_cache=False`` over a full-context paged pool under the
    window mask (`attn_decode_paged`)."""
    import torch
    from repro_torch.flags import perf_flags
    from repro_torch.models.blocks import attn_decode_contiguous, attn_decode_paged
    from repro_torch.models.common import cdtype
    cfg, params = model
    layer = params["layers"][cfg.block_kinds().index("L")]["attn"]
    gen = torch.Generator(device=dev).manual_seed(6)
    s, n, w = SERVE["slots"], SERVE["max_seq"], cfg.local_window
    lengths = [p + NEW_TOKENS for p in PROMPTS]
    pos = torch.tensor(lengths, dtype=torch.int32, device=dev)
    active = torch.ones(s, dtype=torch.bool, device=dev)
    x = torch.randn((s, cfg.d_model), generator=gen, device=dev).to(cdtype(cfg))
    ring = random_cache(dev, gen, cfg, s, w, [w] * s)
    full = random_pool(dev, gen, cfg, s, n, SERVE["block_size"], lengths)
    salca = None                                       # an "L" layer selects nothing
    out = {"ring_ms": graph_ms(lambda: attn_decode_contiguous(layer, x, ring, cfg, pos, salca,
                                                              active, "L"), iters)}
    with perf_flags(ring_local_cache=False):
        out["full_context_ms"] = graph_ms(lambda: attn_decode_paged(
            layer, x, full, cfg, pos, salca, active, None, "L"), iters)
    return out


def check_flat_and_rings(dev, ctx, runs: dict, tokens, trace_c, gemma_r) -> None:
    """Phase 4's runs (v)-(x) (module docstring); adds their launch counts
    to ``runs``. ``tokens``/``trace_c``: the paged run's tokens and the
    contiguous run's rows; ``gemma_r``: run (r)'s (tokens, rows, summary)."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.flags import perf_flags
    from repro_torch.models.blocks import ring_size, salca_params_for
    k_cap = salca_params_for(get_config("qwen3-0.6b"), SERVE["max_seq"]).k_cap
    with CapProbe(k_cap) as probe:
        runs["sp contiguous"], sum_v, picks_v, tr_v = serve_main_path(
            dev, ctx, paged=False, force=dict(enumerate(tokens)), hook=probe.install)
    print_serve("(v) contiguous, sequence-sharded flat tick (one rank, nccl; teacher-forced)",
                sum_v)
    skip, events = probe.over()
    worst = check_contiguous_logits(tokens, trace_c, picks_v, tr_v, skip=skip,
                                    label="(v) flat sequence-sharded vs contiguous")
    gated = len(set(tr_v) - skip)
    print(f"(v): {len(events)} (tick, request) steps kept more than k_cap {k_cap} in some "
          f"row (one rank's capacity {min(SERVE['max_seq'], 4 * k_cap)}), the first "
          f"{events[:6]}; {gated} of {len(tr_v)} logits rows gated, each within "
          f"{max(worst.values()):.3g} bf16 ulps (limit {CONTIG_LOGIT_ULPS}); ms per tick "
          f"{np.median(sum_v['tick_ms']):.2f} (median); launches per tick "
          f"{json.dumps(sum_v['launches_per_tick'])}; collectives per tick "
          f"{json.dumps(sum_v['collectives_per_tick'])}", flush=True)

    tok_r, tr_r, sum_r = gemma_r
    gc.collect()
    torch.cuda.empty_cache()
    model = config_model(dev, GEMMA)
    cfg = model[0]
    rings = sum(ring_size(cfg, kind, SERVE["max_seq"]) < SERVE["max_seq"]
                for kind in cfg.block_kinds())
    kw = dict(model=model, prompts=PROMPTS)
    # fed (r)'s tokens: the rings' merge sums in another order than (r)'s
    # softmax, and random weights put many picks on 0-1-ulp ties
    runs["gemma3 sharded"], sum_w, picks_w, tr_w = serve_main_path(
        dev, ctx, force=dict(enumerate(tok_r)), **kw)
    print_serve(f"(w) paged int8 at one nccl rank: block-sharded global layers, {rings} "
                "sequence-sharded rings (teacher-forced on (r)'s tokens)", sum_w, GEMMA)
    worst = check_contiguous_logits(tok_r, tr_r, picks_w, tr_w,
                                    label=f"{GEMMA} (w) sharded vs (r)")
    print(f"{GEMMA} (w) vs (r): every logits row within {max(worst.values()):.3g} bf16 ulps "
          f"(limit {CONTIG_LOGIT_ULPS}); own picks equal (r)'s tokens: "
          f"{first_divergence(tok_r, picks_w) is None}; ms per tick "
          f"{np.median(sum_w['tick_ms']):.2f} (median, eager); collectives per tick "
          f"{json.dumps(sum_w['collectives_per_tick'])}", flush=True)

    # ring_local_cache=False: every "L" layer keeps the full context, and the
    # first cache is no longer a ring, so the global layers select with k and
    # k_cap from max_seq (the reference's rule): the paged run is held to its
    # contiguous twin under the same flag, both fed (r)'s tokens
    want = [t[:RING_OFF_NEW_TOKENS] for t in tok_r]
    off = dict(force=dict(enumerate(want)), new_tokens=RING_OFF_NEW_TOKENS, **kw)
    with perf_flags(ring_local_cache=False):
        runs["gemma3 no ring"], sum_x, picks_x, tr_x = serve_main_path(dev, **off)
        print_serve(f"(x) paged int8, ring_local_cache=False ({rings} full-context window "
                    "layers; teacher-forced on (r)'s tokens)", sum_x, GEMMA)
        runs["gemma3 no ring contiguous"], sum_xc, picks_xc, tr_xc = serve_main_path(
            dev, paged=False, **off)
        print_serve("(x') its contiguous twin, ring_local_cache=False", sum_xc, GEMMA)
    worst_x = check_contiguous_logits(want, tr_x, picks_xc, tr_xc,
                                      label=f"{GEMMA} (x') contiguous vs (x) paged, no rings")
    worst = check_contiguous_logits(want, tr_r, picks_x, tr_x, limit=None,
                                    label=f"{GEMMA} (x) no ring vs (r)")
    layer = ring_layer_ms(dev, model)
    print(f"{GEMMA} (x), {RING_OFF_NEW_TOKENS} tokens: every logits row of (x') within "
          f"{max(worst_x.values()):.3g} bf16 ulps of (x)'s (limit {CONTIG_LOGIT_ULPS}); (x) "
          f"against (r) (global layers at k {salca_params_for(cfg, SERVE['max_seq']).k}, not "
          f"{salca_params_for(cfg, cfg.local_window).k}): logits within "
          f"{max(worst.values()):.3g} bf16 ulps, own picks equal (r)'s tokens: "
          f"{first_divergence(want, picks_x) is None} (reported, not gates); peak memory GB "
          f"{sum_x['peak_mem_gb']:.3f} vs (r) {sum_r['peak_mem_gb']:.3f}; graphed replay ms per "
          f"tick {sum_x['replay_ms_median']:.2f} vs (r) {sum_r['replay_ms_median']:.2f}; one "
          f"\"L\" layer's attention {layer['full_context_ms']:.4f} ms over the full context "
          f"vs {layer['ring_ms']:.4f} ms over its ring (x {rings} layers: "
          f"{rings * layer['full_context_ms']:.2f} vs {rings * layer['ring_ms']:.2f} ms per "
          f"tick)", flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the unfused baselines and the MoE family (runs (y)-(z''')), and phase 3's
# checks at granite-moe-3b-a800m's shapes
# ---------------------------------------------------------------------------

def check_group_rows_and_baseline(dev, cfg, mcfg, lengths, iters=20) -> list:
    """Phase 3, printed: B1, B4 and B7 at ``mcfg``'s r (granite: r 32, two
    words, the wide layout) with ``group_sum_query`` on (one query row per
    kv head) and off (G rows), each bit for bit against its plain version;
    then the paged tick's two routes at the main path's shapes on one
    random pool (``cfg``): the unfused baseline (B7 over the logical copy
    of the feature stream, B8 over the gathered rows) against the fused
    tick (B1, B2) — selections bit for bit, outputs within
    B2_ATOL + B2_RTOL·|fused| — and both timed by `graph_ms`."""
    import torch
    from repro_torch.core.attention import salca_decode_attention_paged
    from repro_torch.core.selection import _quantized_query_groups, query_heavy_features
    from repro_torch.flags import PERF, perf_flags
    from repro_torch.kernels.score_est import ops as se
    from repro_torch.models.blocks import salca_params_for
    lines = []
    gen = torch.Generator(device=dev).manual_seed(7)
    s, mseq, bs = SERVE["slots"], SERVE["max_seq"], SERVE["block_size"]
    h, kv, hd = mcfg.num_heads, mcfg.num_kv_heads, mcfg.resolved_head_dim
    pool = random_pool(dev, gen, mcfg, s, mseq, bs, lengths)
    cache = random_cache(dev, gen, mcfg, s, mseq, lengths)
    q = torch.randn((s, h, hd), generator=gen, device=dev)
    mb = pool.max_blocks
    pos = torch.arange(mseq, device=dev).reshape(mb, bs)
    blk_valid = (pool.page_table >= 0)[..., None] & (pos[None] < pool.length[:, None, None])
    for fold in (True, False):
        with perf_flags(group_sum_query=fold):
            qc, qs, qsum = _quantized_query_groups(
                query_heavy_features(q, pool.heavy_idx, h // kv), kv)
            b1 = (qc, qs, qsum, pool.feat_words, pool.feat_scale, pool.feat_zero,
                  pool.clamped_pages())
            what = f"at r {qc.shape[-1]}, G' {qc.shape[2]}"
            _check_exact(f"B1 {what}", (se.paged_score_estimate(*b1, bf16=PERF.bf16_collectives),),
                         (se.paged_score_estimate_plain(*b1, bf16=PERF.bf16_collectives),))
            _check_exact(f"B4 {what}",
                         se.paged_score_bounds(*b1, blk_valid, bf16=PERF.bf16_collectives),
                         se.paged_score_bounds_plain(*b1, blk_valid,
                                                     bf16=PERF.bf16_collectives))
            fc, fs, _ = _quantized_query_groups(
                query_heavy_features(q, cache.heavy_idx, h // kv), kv)
            b7 = (fc, fs, cache.feat_words, cache.feat_scale, cache.feat_zero)
            _check_exact(f"B7 {what}", (se.flat_score_estimate(*b7, bf16=True),),
                         (se.flat_score_estimate_plain(*b7, bf16=True),))
            lines.append(f"{mcfg.name}: B1, B4 and B7 {what} ({qc.shape[-1] // 16} words, "
                         f"group_sum_query={fold}) bit for bit against their plain versions")
    del pool, cache

    pool = random_pool(dev, gen, cfg, s, mseq, bs, lengths)
    q = torch.randn((s, cfg.num_heads, cfg.resolved_head_dim), generator=gen, device=dev)
    params = salca_params_for(cfg, mseq)
    fo, fsel = salca_decode_attention_paged(q, pool, params, True, fused=True)
    uo, usel = salca_decode_attention_paged(q, pool, params, True, fused=False)
    for a, b in zip(fsel, usel):
        if not torch.equal(a, b):
            raise AssertionError("the unfused paged tick's selection differs from the fused "
                                 "tick's on the same pool")
    ratio = float(((uo - fo).abs() / (B2_ATOL + B2_RTOL * fo.abs())).max())
    if not ratio <= 1.0:
        raise AssertionError(f"unfused vs fused paged attention: {ratio:.3g}x the bound")
    f_ms = graph_ms(lambda: salca_decode_attention_paged(q, pool, params, fused=True), iters)
    u_ms = graph_ms(lambda: salca_decode_attention_paged(q, pool, params, fused=False), iters)
    lines.append(f"paged attention of one layer at the main path's shapes: the unfused "
                 f"baseline (B7 over the logical copy, B8 over the gathered rows) selects the "
                 f"fused tick's tokens bit for bit, outputs within {ratio:.3g} of "
                 f"{B2_ATOL:g} + {B2_RTOL:g}*|fused|; graph_ms fused {f_ms:.4f}, unfused "
                 f"{u_ms:.4f} ({u_ms / f_ms:.2f}x)")
    return lines


class SameStateProbe:
    """Holds every selection an attention entry of `models.blocks`
    (``name``) makes on the unfused route to the fused route's on the same
    state: a ``with`` block routes the entry through a wrapper that also
    runs it with ``fused=True`` on the same operands (its launches and
    collectives taken back out of the counts: it compares, it does not
    serve) and counts on the device the Selection entries that differ.
    Eager runs only (a replay reruns no Python)."""

    def __init__(self, name: str):
        self.name, self.calls, self.differ = name, 0, None

    def __enter__(self):
        from collections import Counter

        from repro_torch.distributed.sharding import COLLECTIVES
        from repro_torch.kernels.common import LAUNCHES
        from repro_torch.models import blocks
        self._real = real = getattr(blocks, self.name)

        def probing(*a, return_selection=False, **kw):
            out, sel = real(*a, return_selection=True, **kw)
            launches, collectives = Counter(LAUNCHES), Counter(COLLECTIVES)
            _, ref = real(*a, return_selection=True, **dict(kw, fused=True))
            LAUNCHES.clear()
            LAUNCHES.update(launches)
            COLLECTIVES.clear()
            COLLECTIVES.update(collectives)
            n = sum((x != y).sum() for x, y in zip(sel, ref))
            self.differ = n if self.differ is None else self.differ + n
            self.calls += 1
            return (out, sel) if return_selection else out

        setattr(blocks, self.name, probing)
        return self

    def __exit__(self, *exc):
        from repro_torch.models import blocks
        setattr(blocks, self.name, self._real)

    def check(self, label: str) -> None:
        differ = int(self.differ) if self.calls else 0
        if not self.calls or differ:
            raise AssertionError(f"{label}: {differ} Selection entries over {self.calls} "
                                 "calls differ from the fused route's on the same state")


def hist_parting(a: list, b: list):
    """Where two runs' per-tick `sel_hist` stacks (layers, slots, blocks)
    first part: (tick, first layer) or None; and the share of equal
    entries over all ticks."""
    import torch
    first, equal, total = None, 0, 0
    for t, (x, y) in enumerate(zip(a, b)):
        same = x == y
        equal, total = equal + int(same.sum()), total + same.numel()
        if first is None and not bool(same.all()):
            first = (t, int((~same).flatten(1).any(1).nonzero()[0]))
    return first, equal / max(total, 1)


def check_unfused(dev, ctx, runs: dict, main: tuple, sharded: tuple) -> None:
    """Phase 4's runs (y), (y'') and (y'): the reference's unfused baselines
    on the main path (module docstring). ``main``/``sharded``: the fused
    paged run's (tokens, rows, summary, per-tick `sel_hist` stacks) and the
    fused one-rank run's (tokens, rows, summary)."""
    from repro_torch.flags import perf_flags
    tokens, trace, summary, hists = main
    force = dict(enumerate(tokens))
    hists_y = []
    runs["int8 unfused"], sum_y, picks_y, tr_y = serve_main_path(
        dev, force=force, fused_decode=False, hists=hists_y)
    print_serve("(y) paged int8, fused_decode=False (teacher-forced on the paged run's "
                "tokens)", sum_y)
    worst = check_contiguous_logits(tokens, trace, picks_y, tr_y,
                                    label="(y) unfused vs fused paged")
    parting, share = hist_parting(hists, hists_y)
    with SameStateProbe("salca_decode_attention_paged") as probe:
        runs["int8 unfused eager"], sum_ye, picks_ye, tr_ye = serve_main_path(
            dev, force=force, fused_decode=False, eager_run=True)
    probe.check("(y'') unfused eager")
    rows = check_bitwise("(y) graphed vs (y'') eager, unfused", picks_y, tr_y, picks_ye, tr_ye)
    print(f"(y) unfused vs fused: every logits row within {max(worst.values()):.3g} bf16 ulps "
          f"(limit {CONTIG_LOGIT_ULPS}); (y'') its eager twin: {rows} rows bit for bit, and "
          f"in each of its {probe.calls} calls the unfused selection equals the fused "
          f"route's on the same state; the runs' sel_hist part first at (tick, layer) "
          f"{parting} ({share:.4f} of the entries equal: the layers pass B8's and B2's "
          f"roundings on to the next layer's query); graphed replay ms per tick unfused "
          f"{sum_y['replay_ms_median']:.2f} vs fused {summary['replay_ms_median']:.2f} "
          f"({sum_y['replay_ms_median'] / summary['replay_ms_median']:.2f}x); wrapper "
          f"launches per replay {sum_y['launches_per_replay']} vs "
          f"{summary['launches_per_replay']}; peak memory GB {sum_y['peak_mem_gb']:.3f} vs "
          f"{summary['peak_mem_gb']:.3f}", flush=True)

    tokens_sh, trace_sh, summary_sh = sharded
    with perf_flags(sharded_fused_decode=False), \
            SameStateProbe("sp_salca_decode_paged") as probe:
        runs["int8 sharded gather"], sum_g, picks_g, tr_g = serve_main_path(
            dev, ctx, force=dict(enumerate(tokens_sh)))
    print_serve("(y') paged int8 at one nccl rank, sharded_fused_decode=False (the "
                "logical-gather island; teacher-forced on the fused one-rank run's tokens)",
                sum_g)
    probe.check("(y') gather island")
    worst = check_contiguous_logits(tokens_sh, trace_sh, picks_g, tr_g,
                                    label="(y') gather island vs fused island")
    print(f"(y') gather vs fused island: in each of {probe.calls} calls the selection equals "
          f"the fused island's on the same state; every logits row within "
          f"{max(worst.values()):.3g} bf16 ulps of the fused one-rank run's (limit "
          f"{CONTIG_LOGIT_ULPS}); ms per tick {np.median(sum_g['tick_ms']):.2f} vs "
          f"{np.median(summary_sh['tick_ms']):.2f} (medians, eager); collectives per tick "
          f"{json.dumps(sum_g['collectives_per_tick'])} vs "
          f"{json.dumps(summary_sh['collectives_per_tick'])}", flush=True)


class DropProbe:
    """Run (z)'s count of the (token, choice) pairs the MoE capacity drops
    in each prefill: a ``with`` block routes `models.moe.route` through a
    wrapper that keeps, while the engine prefills (`install` marks it),
    each call's dropped pairs and tokens with a dropped choice, on the
    device; `per_prefill` reads them after the run."""

    def __init__(self):
        self.prefills, self._on = [], False

    def __enter__(self):
        from repro_torch.models import moe
        self._real = moe.route

        def counting(*a, **kw):
            r = self._real(*a, **kw)
            if self._on:
                self.prefills[-1].append(((~r.keep).sum(), (~r.keep).any(-1).sum(),
                                          r.keep.numel(), r.cap))
            return r

        moe.route = counting
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self._real

    def install(self, engine) -> None:
        inner = engine._prefill

        def prefill(req):
            self.prefills.append([])
            self._on = True
            try:
                return inner(req)
            finally:
                self._on = False

        engine._prefill = prefill

    def per_prefill(self) -> list:
        """Per prefill: (dropped pairs, tokens with a dropped choice, both
        summed over layers; pairs routed; the capacity)."""
        return [(sum(int(d) for d, _, _, _ in calls), sum(int(t) for _, t, _, _ in calls),
                 sum(n for _, _, n, _ in calls), calls[0][3] if calls else None)
                for calls in self.prefills]


def moe_layer_ms(dev, model, iters=20) -> dict:
    """One MoE layer's FFN (`blocks.ffn_apply` on layer 0's weights) at the
    decode tick's shape (the main path's slots, one token each, routed as
    one flat row) and at the shortest prompt's prefill shape, by
    `graph_ms`."""
    import torch
    from repro_torch.models.blocks import ffn_apply
    from repro_torch.models.common import cdtype
    cfg, params = model
    ffn = params["layers"][0]["ffn"]
    gen = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn((SERVE["slots"], cfg.d_model), generator=gen, device=dev).to(cdtype(cfg))
    xp = torch.randn((1, min(PROMPTS), cfg.d_model), generator=gen,
                     device=dev).to(cdtype(cfg))
    return {"decode_ms": graph_ms(lambda: ffn_apply(ffn, x, cfg), iters),
            "prefill_ms": graph_ms(lambda: ffn_apply(ffn, xp, cfg), max(2, iters // 4))}


def check_moe(dev, ctx, runs: dict) -> None:
    """Phase 4's runs (z)-(z''') (module docstring): granite-moe-3b-a800m at
    full width on the main path's engine and prompts."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    model = config_model(dev, GRANITE)
    cfg = model[0]
    kw = dict(model=model, prompts=PROMPTS, new_tokens=NEW_TOKENS, profile_tick=PROFILE_TICK)
    with DropProbe() as drops:
        runs["granite"], sum_z, tok_z, tr_z = serve_main_path(dev, hook=drops.install, **kw)
    print_serve(f"(z) paged int8, {cfg.num_experts} experts (padded to "
                f"{cfg.padded_experts}), top-{cfg.experts_per_token}", sum_z, GRANITE)
    print(f"{GRANITE} (z): per prefill (dropped (token, choice) pairs, tokens with a "
          f"dropped choice, pairs routed, capacity), summed over {cfg.num_layers} layers: "
          f"{drops.per_prefill()}; prefill s {sum_z['prefill_s']:.3f}, TTFT s "
          f"{[round(t, 4) for t in sum_z['ttft_s']]}", flush=True)
    runs["granite eager"], sum_ze, tok_ze, tr_ze = serve_main_path(dev, eager_run=True, **kw)
    print_serve("(z') paged int8, eager (built under steps.eager())", sum_ze, GRANITE)
    rows = check_bitwise(f"{GRANITE} graphed vs eager", tok_z, tr_z, tok_ze, tr_ze)
    print(f"{GRANITE} (z') = (z): greedy tokens identical, {rows} logits rows bit for bit; ms "
          f"per tick eager {np.median(sum_ze['tick_ms']):.2f}, graphed replay "
          f"{sum_z['replay_ms_median']:.2f} (median); wrapper launches per replay "
          f"{sum_z['launches_per_replay']}; peak memory GB {sum_z['peak_mem_gb']:.3f}",
          flush=True)
    force = dict(enumerate(tok_z))
    runs["granite contiguous"], sum_zc, picks_zc, tr_zc = serve_main_path(
        dev, paged=False, force=force, **kw)
    print_serve("(z'') contiguous (teacher-forced on (z)'s tokens)", sum_zc, GRANITE)
    worst_c = check_contiguous_logits(tok_z, tr_z, picks_zc, tr_zc,
                                      label=f"{GRANITE} (z'') contiguous vs (z) paged")
    runs["granite sharded"], sum_zs, picks_zs, tr_zs = serve_main_path(
        dev, ctx, force=force, **kw)
    print_serve("(z''') paged int8 at one nccl rank (teacher-forced on (z)'s tokens)", sum_zs,
                GRANITE)
    worst_s = check_contiguous_logits(tok_z, tr_z, picks_zs, tr_zs,
                                      label=f"{GRANITE} (z''') sharded vs (z) paged")
    finite = all(bool(torch.isfinite(r).all()) for r in (*tr_z.values(), *tr_zc.values(),
                                                          *tr_zs.values()))
    if not finite:
        raise AssertionError(f"{GRANITE}: non-finite logits")
    layer = moe_layer_ms(dev, model)
    print(f"{GRANITE}: (z'') every logits row within {max(worst_c.values()):.3g} bf16 ulps "
          f"of (z)'s, (z''') within {max(worst_s.values()):.3g} (limit {CONTIG_LOGIT_ULPS}); "
          f"ms per tick (z) replay {sum_z['replay_ms_median']:.2f}, (z'') replay "
          f"{sum_zc['replay_ms_median']:.2f}, (z''') eager {np.median(sum_zs['tick_ms']):.2f} "
          f"(medians); collectives per tick (z''') "
          f"{json.dumps(sum_zs['collectives_per_tick'])}; one MoE layer's FFN by graph_ms: "
          f"decode ({SERVE['slots']} tokens) {layer['decode_ms']:.4f} ms, prefill "
          f"({min(PROMPTS)} tokens) {layer['prefill_ms']:.4f} ms", flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()


def recurrent_layer_ms(dev, model, iters=20) -> dict:
    """One layer of each kind of a recurrent model's tick, by `graph_ms`, on
    the main path's slots: the whole block (`blocks.block_decode`: norms,
    mixer, FFN) over a zeroed recurrent state for "S" and "R", over a ring
    of random contents, every slot holding W tokens, for "L"; and the "R"
    and "S" mixers alone (`rglru_decode`, `ssd_decode` with the state's
    write-back)."""
    import torch
    from repro_torch.models import blocks as B
    from repro_torch.models import rglru, ssm
    from repro_torch.models.common import cdtype, rmsnorm
    cfg, params = model
    kinds = cfg.block_kinds()
    gen = torch.Generator(device=dev).manual_seed(9)
    s = SERVE["slots"]
    pos = torch.tensor([p + NEW_TOKENS for p in PROMPTS], dtype=torch.int32, device=dev)
    active = torch.ones(s, dtype=torch.bool, device=dev)
    x = torch.randn((s, cfg.d_model), generator=gen, device=dev).to(cdtype(cfg))
    out = {}
    for kind in sorted(set(kinds)):
        layer = params["layers"][kinds.index(kind)]
        if kind == "L":
            w = cfg.local_window
            state = random_cache(dev, gen, cfg, s, w, [w] * s)
        else:
            state = B.block_init_state(kind, s, cfg, dev)
        out[f"{kind}_block_ms"] = graph_ms(
            lambda layer=layer, state=state, kind=kind: B.block_decode(
                layer, x, state, cfg, pos, None, active, None, kind), iters)
        if kind in "SR":
            mixer, p = ((ssm.ssd_decode, layer["ssd"]) if kind == "S"
                        else (rglru.rglru_decode, layer["rglru"]))

            def mix(mixer=mixer, p=p, state=state, layer=layer):
                _, new = mixer(p, rmsnorm(layer["ln1"], x, cfg.norm_eps), state, cfg)
                B.merge_masked_state(new, state, active)
            out[f"{kind}_mixer_ms"] = graph_ms(mix, iters)
    return out


def check_recurrent(dev, runs: dict) -> None:
    """Phase 4's runs (aa)-(ab'') (module docstring): mamba2-2.7b and
    recurrentgemma-2b at full width on the main path's engine and prompts,
    each model loaded alone; adds their launch counts to ``runs``."""
    import gc

    import torch
    for arch, key, run in ((MAMBA, "mamba2", "aa"), (RGEMMA, "recurrentgemma", "ab")):
        gc.collect()
        torch.cuda.empty_cache()
        model = config_model(dev, arch)
        cfg = model[0]
        kw = dict(model=model, prompts=PROMPTS, new_tokens=NEW_TOKENS, profile_tick=PROFILE_TICK)
        runs[key], sum_g, tok_g, tr_g = serve_main_path(dev, **kw)
        print_serve(f"({run}) paged int8, graphed", sum_g, arch)
        runs[f"{key} eager"], sum_e, tok_e, tr_e = serve_main_path(dev, eager_run=True, **kw)
        print_serve(f"({run}') paged int8, eager (built under steps.eager())", sum_e, arch)
        rows_e = check_bitwise(f"{arch} graphed vs eager", tok_g, tr_g, tok_e, tr_e)
        # no paged layer: the contiguous engine holds the same states (rings
        # and recurrent states) and runs the same tick, so every row is bit
        # for bit with the paged engine's
        runs[f"{key} contiguous"], sum_c, tok_c, tr_c = serve_main_path(dev, paged=False, **kw)
        print_serve(f"({run}'') contiguous, graphed", sum_c, arch)
        rows_c = check_bitwise(f"{arch} paged vs contiguous", tok_g, tr_g, tok_c, tr_c)
        if not all(bool(torch.isfinite(r).all()) for r in tr_g.values()):
            raise AssertionError(f"{arch}: non-finite logits")
        layers = recurrent_layer_ms(dev, model)
        p = sum_g["profiled_tick"]
        print(f"{arch} ({run}): graphed = eager ({rows_e} rows) = contiguous ({rows_c} rows), "
              f"bit for bit, greedy tokens identical; replay median "
              f"{sum_g['replay_ms_median']:.2f} ms (contiguous "
              f"{sum_c['replay_ms_median']:.2f}, eager {np.median(sum_e['tick_ms']):.2f}); "
              f"profiled tick: {p.get('launches')} launches, {p.get('device_ms')} device ms; "
              f"peak memory GB {sum_g['peak_mem_gb']:.3f}; prefill ms "
              f"{[round(t, 2) for t in sum_g['prefill_ms']]}, TTFT s "
              f"{[round(t, 4) for t in sum_g['ttft_s']]}; state bytes per slot "
              f"{json.dumps(sum_g['state_bytes_per_slot'])}; one layer by graph_ms "
              f"{json.dumps({k: round(v, 5) for k, v in layers.items()})}", flush=True)
        del model
    gc.collect()
    torch.cuda.empty_cache()


def b3_bidirectional_record(dev, gen, cfg, tq: int, s_len: int, tag: str, run: str,
                            iters=5) -> dict:
    """Phase 3a's record of B3 without a causal mask at ``cfg``'s heads:
    ``tq`` query rows over ``s_len`` keys in bf16 (whisper's encoder: tq =
    s_len; its cross-attention prefill: a decoder prompt over T_enc frames),
    every row against the plain version, which runs over blocks of PLAIN_ROWS
    query rows (a row of an unmasked attention depends on its own query
    only; the whole score matrix at 32768² would take 51 GB), with B3's
    one-ulp bound; its time by `graph_ms`, the blocked plain version's and
    SDPA's (no mask) by CUDA events, and the bound from every (query, key)
    pair. ``run`` names the phase-4 run that counts its launches."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_prefill import ops as fp
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q3 = torch.randn((h, tq, hd), generator=gen, device=dev).to(torch.bfloat16)
    k3, v3 = (torch.randn((kv, s_len, hd), generator=gen, device=dev).to(torch.bfloat16)
              for _ in range(2))

    def plain():
        return torch.cat([fp.flash_attention_plain(q3[:, i:i + PLAIN_ROWS], k3, v3,
                                                   causal=False)
                          for i in range(0, tq, PLAIN_ROWS)], dim=1)

    out3 = fp.flash_attention(q3, k3, v3, causal=False)
    ref = plain()
    diff = (out3.float() - ref.float()).abs()
    err = float(diff.max())
    ratio = float((diff / (B3_ATOL + B3_RTOL * ref.float().abs())).max())
    del ref, diff
    if not ratio <= 1.0:
        raise AssertionError(f"B3{tag} (causal=False): |kernel - plain| reaches {ratio:.3g}x "
                             f"its bound {B3_ATOL:g} + 2^-7·|plain| (max abs err {err})")
    ms = graph_ms(lambda: fp.flash_attention(q3, k3, v3, causal=False), iters)
    kr = k3.repeat_interleave(h // kv, 0)[None]
    vr = v3.repeat_interleave(h // kv, 0)[None]
    lib = events_ms(lambda: F.scaled_dot_product_attention(q3[None], kr, vr), iters)
    ops = 4 * hd * h * tq * s_len
    bms, bby = bound(2 * (2 * q3.numel() + k3.numel() + v3.numel()), ops, "bf16")
    return dict(name="flash_prefill" + tag, counter="flash_prefill", route="cuda",
                source="src/repro_torch/csrc/flash_prefill.cu",
                replaces="src/repro/kernels/flash_prefill/kernel.py:98",
                launches=None, max_abs_err=err, tolerance=f"{B3_ATOL:g} + 2^-7*|plain|",
                err_over_tol=ratio, ms=ms, graph_ms=ms, plain_ms=events_ms(plain, 1),
                plain_call=f"flash_attention_plain over blocks of {PLAIN_ROWS} query rows",
                bound_ms=bms, bound_by=bby, library_ms=lib,
                library_call="scaled_dot_product_attention, no mask",
                tflops=ops / ms / 1e9, ms_over_library=ms / lib, causal=False,
                query_rows=tq, keys=s_len, groups=h // kv, run=run)


def encdec_requests(dev, cfg, frames=ENC_FRAMES, prompts=ENC_PROMPTS, seed=0) -> list:
    """Run (ac)'s requests: per request a decoder prompt (1, Td) drawn from
    ``seed`` and ``frames`` random frame embeddings (1, T_enc, D), f32 made
    on ``dev`` from ``seed``."""
    import torch
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [(rng.integers(0, cfg.vocab_size, (1, n)).astype(np.int32),
             {"frames": torch.randn((1, frames, cfg.d_model), generator=gen, device=dev)})
            for n in prompts]


def vlm_requests(dev, cfg, n=VLM_REQUESTS, text=VLM_TEXT, seed=0) -> list:
    """Run (ad)'s requests: per request ``text`` text tokens drawn from
    ``seed`` and the config's ``num_image_tokens`` random patch embeddings
    (1, P, F), f32 made on ``dev`` from ``seed``."""
    import torch
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [(rng.integers(0, cfg.vocab_size, (1, text)).astype(np.int32),
             {"patches": torch.randn((1, cfg.num_image_tokens, cfg.frontend_dim),
                                     generator=gen, device=dev)})
            for _ in range(n)]


def serve_model_api(dev, model, reqs, max_seq: int, new_tokens: int, eager_run=False,
                    before_ticks=None, profile_tick=None) -> tuple:
    """Serve ``reqs`` ((tokens (1, T), prefill keywords: ``frames`` or
    ``patches``)) through the model API with `runtime.steps.PooledServer`,
    the way the reference serves an enc-dec model (its `ModelAPI` and the
    mesh step builder): one slot per request in a pooled contiguous state
    (the enc-dec family's max_seq is T_enc), greedy ticks of
    `ServeDecodeStep` with an active mask (a CUDA graph after its first
    call on the card; eager when ``eager_run`` builds it under
    `steps.eager()`), a slot reset after its request's ``new_tokens``-th
    token. ``before_ticks(api, pool, tokens, active)`` runs after the
    admissions; ``profile_tick`` (an index, on the card) runs that tick
    under the profiler (its device ms and kernel launches in the summary's
    ``profiled_tick``). Each prefill (admission) and tick is timed between
    two synchronizations. Checks the kernels' launches (B3 once per
    attention of a prefill, the contiguous tick's B7, B9 and B8 once per
    decoder layer and tick) and that every row is finite. Returns
    (launches, summary, tokens per request, {(request, token): logits row
    on the host})."""
    import contextlib
    import gc

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.models import encdec, get_model
    from repro_torch.runtime.steps import PooledServer, eager
    cfg, params = model
    on_card = torch.device(dev).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def timed(fn, into):
        def run(*a):
            sync()
            t0 = time.perf_counter()
            out = fn(*a)
            sync()
            into.append(1e3 * (time.perf_counter() - t0))
            return out
        return run

    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    slots = len(reqs)
    enc_ms, prefill_ms, tick_ms, profiled, rows = [], [], [], {}, {}

    class Server(PooledServer):
        admit = timed(PooledServer.admit, prefill_ms)

        def tick(self, tokens, active):
            if self.ticks == 0 and before_ticks is not None:
                before_ticks(self.api, self.pool, tokens.copy(), active.copy())
            if not (on_card and len(tick_ms) == profile_tick):
                return timed(super().tick, tick_ms)(tokens, active)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                time.sleep(PROFILE_IDLE_S)
                out = timed(super().tick, tick_ms)(tokens, active)
                time.sleep(PROFILE_IDLE_S)
            kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
            profiled.update(tick=profile_tick, launches=len(kernels) or None,
                            device_ms=(sum(e.time_range.elapsed_us() for e in kernels) / 1e3
                                       if kernels else None))
            return out

    def keep(i, j, row):
        rows[(i, j)] = row.float().cpu()

    reset_launches()
    t_run = time.time()
    real_encode = encdec.encode
    encdec.encode = timed(real_encode, enc_ms)
    try:
        with eager() if eager_run else contextlib.nullcontext():
            server = Server(get_model(cfg), params, slots, max_seq, dev)
        out = server.serve([(torch.from_numpy(t), x) for t, x in reqs], new_tokens,
                           on_logits=keep)
    finally:
        encdec.encode = real_encode
    sync()
    wall = time.time() - t_run
    if server.nonfinite:
        raise AssertionError(f"{cfg.name}: requests {server.nonfinite} met a logits row "
                             "that is not finite")
    launches = dict(LAUNCHES)
    n_att = (cfg.encoder_layers + 2 * cfg.num_layers) if cfg.encdec else sum(
        kind in "AL" for kind in cfg.block_kinds())
    ticks, step, pool = server.ticks, server.step, server.pool
    want = {"flash_prefill": n_att * slots}
    if cfg.salca:
        want.update({k: cfg.num_layers * ticks for k in
                     ("score_estimate", "fused_bin_pool_threshold", "sparse_flash_decode")})
    if on_card and launches != want:        # the CPU's plain versions count no launch
        raise AssertionError(f"{cfg.name}: launch counts {launches} != expected {want}")
    if int(pool.pos.abs().sum()) != 0:
        raise AssertionError(f"{cfg.name}: a slot's cursor was not reset")
    if on_card and step.graphed == eager_run:
        raise AssertionError(f"{cfg.name}: tick graphed={step.graphed} with eager_run="
                             f"{eager_run}")
    per_slot = {}
    for name in ("self_caches", "cross_caches", "caches"):
        caches = getattr(pool, name, None)
        if caches:
            per_slot[name] = sum(t.numel() * t.element_size() for c in caches
                                 for t in (c.k_codes, c.k_scale, c.v_codes, c.v_scale,
                                           c.feat_words, c.feat_scale, c.feat_zero)) // slots
    summary = dict(
        wall_s=wall, prefill_ms=prefill_ms, encoder_ms=enc_ms, tick_ms=tick_ms, ticks=ticks,
        graphed=step.graphed,
        replay_ms_median=float(np.median(tick_ms[2:])) if step.graphed else None,
        launches_per_replay=(sum(step.launches_per_tick.values())
                             if step.launches_per_tick else None),
        launches_per_tick={k: v / ticks for k, v in launches.items() if k != "flash_prefill"},
        profiled_tick=profiled,
        state_bytes_per_slot=per_slot,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else None)
    return launches, summary, out, rows


def print_model_api(label: str, name: str, summary: dict) -> None:
    ticks = summary["tick_ms"]
    graph = (f"first tick (eager) {ticks[0]:.2f} ms, capture tick {ticks[1]:.2f} ms, replays "
             f"median {summary['replay_ms_median']:.2f} ms, wrapper launches per replay "
             f"{summary['launches_per_replay']}" if summary["graphed"]
             else f"eager, ticks median {np.median(ticks):.2f} ms")
    if summary["profiled_tick"]:
        p = summary["profiled_tick"]
        graph += (f"; profiled tick {p['tick']}: device ms {p['device_ms']}, kernel launches "
                  f"{p['launches']}")
    enc = (f"encoder ms per request {[round(t, 2) for t in summary['encoder_ms']]}, "
           if summary["encoder_ms"] else "")
    print(f"serve {name} {label}: {summary['ticks']} ticks; {graph}; {enc}prefill ms per "
          f"request {[round(t, 2) for t in summary['prefill_ms']]}; launches per tick "
          f"{json.dumps(summary['launches_per_tick'])}; state bytes per slot "
          f"{json.dumps(summary['state_bytes_per_slot'])}; peak memory GB "
          f"{summary['peak_mem_gb']}", flush=True)
    print(f"serve stats {name} {label}: {json.dumps(summary)}", flush=True)


class CtxTick:
    """Run (ac)'s tick at one nccl rank (the enc-dec step's ``ctx`` branch:
    the flat sequence-sharded tick over the self and the cross caches), as
    a `serve_model_api` ``before_ticks`` hook: on a copy of the admitted
    pool's self caches and cursors (the cross caches are only read), one
    eager tick of the graphed run's first tokens. It keeps that tick's next
    tokens, its logits rows, its kernel launches (taken back out of
    `LAUNCHES`, so the run's own counts stay its own) and the largest
    Selection count of a (slot, kv head) in any layer (`sp_salca_decode`
    keeps up to 4·k_cap at one rank where the unsharded tick keeps k_cap)."""

    def __init__(self, params, ctx):
        self.params, self.ctx = params, ctx
        self.tokens = self.rows = self.launches = None
        self.max_count = 0

    def __call__(self, api, pool, tok, active):
        from collections import Counter

        import torch
        from repro_torch.core.cache import SalcaCache
        from repro_torch.kernels.common import LAUNCHES
        from repro_torch.models import encdec
        real = encdec.sp_salca_decode
        counts = []

        def counting(*a, **k):
            o, sel = real(*a, return_selection=True, **k)
            counts.append(sel.count.max())
            return o

        copy = encdec.EncDecState([SalcaCache(*(t.clone() for t in c)) for c in pool.self_caches],
                                  pool.cross_caches, pool.pos.clone())
        before = Counter(LAUNCHES)
        encdec.sp_salca_decode = counting
        try:
            dev = pool.pos.device
            logits, _ = api.decode_step(self.params, copy, torch.from_numpy(tok).to(dev),
                                        torch.from_numpy(active).to(dev), self.ctx)
        finally:
            encdec.sp_salca_decode = real
        self.rows = logits.float().cpu()
        self.tokens = self.rows.argmax(-1).numpy()
        self.launches = {k: n - before[k] for k, n in LAUNCHES.items() if n > before[k]}
        LAUNCHES.clear()
        LAUNCHES.update(before)
        self.max_count = int(torch.stack(counts).max()) if counts else 0
        del copy


def check_small_encdec(dev) -> dict:
    """Phase 3b's small enc-dec path: whisper-small.reduced() at f32 with
    random weights from seed 0, two requests of 256 frames and decoder
    prompts of 5 and 9 tokens from seed 0, 5 new tokens, through
    `serve_model_api` on the card against the same on the CPU (the plain
    versions, which the CPU tests hold against the JAX reference): greedy
    tokens identical, logits within SMALL_PATH_LOGIT_TOL while both pools
    hold the same int8 codes, SMALL_PATH_CODE_STEP_TOL where a stored code
    is one step apart."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.weights import init_lm_params
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(WHISPER).reduced(), dtype="float32")
    params = init_lm_params(cfg, torch.Generator().manual_seed(0), "cpu")
    reqs = encdec_requests("cpu", cfg, frames=256, prompts=(5, 9))
    codes, res = [], []
    for d in ("cpu", dev):
        hold = []

        def keep(api, pool, tok, active, hold=hold):
            hold.append(pool)
        r = [(t, {"frames": e["frames"].to(d)}) for t, e in reqs]
        res.append(serve_model_api(d, (cfg, _to(params, d)), r, 256, 5, before_ticks=keep))
        pool = hold[0]
        codes.append(torch.cat([getattr(c, f).reshape(-1).cpu().to(torch.int16)
                                for c in pool.self_caches + pool.cross_caches
                                for f in ("k_codes", "v_codes")]))
    (_, _, tok_c, rows_c), (_, _, tok_g, rows_g) = res
    if tok_c != tok_g:
        raise AssertionError(f"small path ({WHISPER}): greedy tokens differ: cpu {tok_c} vs "
                             f"card {tok_g}")
    step = int((codes[0].int() - codes[1].int()).abs().max())
    if step > 1:
        raise AssertionError(f"small path ({WHISPER}): stored codes {step} steps apart")
    differ = int((codes[0] != codes[1]).sum())
    tol = SMALL_PATH_CODE_STEP_TOL if differ else SMALL_PATH_LOGIT_TOL
    gap = max(float((rows_c[k] - rows_g[k]).abs().max()) for k in rows_c)
    if not gap <= tol:
        raise AssertionError(f"small path ({WHISPER}): max logits gap {gap} > {tol:g} "
                             f"({differ} stored K/V codes differ)")
    return {"arch": WHISPER, "model_api": True, "tokens_identical": True,
            "max_logit_gap": gap, "rows": len(rows_g), "codes_differing": differ}


def check_encdec_and_vlm(dev, ctx, runs: dict) -> None:
    """Phase 4's runs (ac)-(ad'') (module docstring): whisper-small and
    llava-next-mistral-7b at full width, each model loaded alone; adds their
    launch counts to ``runs``."""
    import gc

    import torch
    from repro_torch.models.blocks import salca_params_for
    model = config_model(dev, WHISPER)
    cfg = model[0]
    reqs = encdec_requests(dev, cfg)
    probe = CtxTick(model[1], ctx)
    runs["whisper"], sum_g, tok_g, tr_g = serve_model_api(
        dev, model, reqs, ENC_FRAMES, ENC_NEW_TOKENS, before_ticks=probe,
        profile_tick=PROFILE_TICK)
    print_model_api("(ac) pooled EncDecState, graphed", WHISPER, sum_g)
    runs["whisper eager"], sum_e, tok_e, tr_e = serve_model_api(
        dev, model, reqs, ENC_FRAMES, ENC_NEW_TOKENS, eager_run=True)
    print_model_api("(ac') eager (built under steps.eager())", WHISPER, sum_e)
    rows = check_bitwise(f"{WHISPER} graphed vs eager", tok_g, tr_g, tok_e, tr_e)
    runs["whisper sharded"] = probe.launches
    k_cap = salca_params_for(cfg, ENC_FRAMES).k_cap
    first = np.array([t[1] for t in tok_g])
    ulps = max(float((probe.rows[s] - tr_g[(s, 1)]).abs().max()) / bf16_ulp(tr_g[(s, 1)])
               for s in range(len(reqs)))
    same = bool((probe.tokens == first).all())
    # at one rank the ctx branch keeps up to 4·k_cap rows of a (slot, head)
    # where the unsharded tick keeps k_cap: the two compute the same
    # selection only while none goes over k_cap, which these seeds give
    if not (same and ulps <= CONTIG_LOGIT_ULPS and probe.max_count <= k_cap):
        raise AssertionError(f"{WHISPER} (ac*) one nccl rank: tokens {probe.tokens} vs (ac)'s "
                             f"{first}, rows within {ulps:.3g} bf16 ulps (limit "
                             f"{CONTIG_LOGIT_ULPS}), largest Selection count "
                             f"{probe.max_count} (limit k_cap {k_cap})")
    print(f"{WHISPER} (ac*) one tick at one nccl rank (the ctx branch): next tokens equal to "
          f"(ac)'s, rows within {ulps:.3g} bf16 ulps; largest Selection count "
          f"{probe.max_count} (k_cap {k_cap}); launches {json.dumps(probe.launches)}",
          flush=True)
    print(f"{WHISPER} (ac): graphed = eager, greedy tokens identical, {rows} logits rows bit "
          f"for bit; replay median {sum_g['replay_ms_median']} ms (eager "
          f"{np.median(sum_e['tick_ms']):.2f}); encoder ms {sum_g['encoder_ms']}; cross-cache "
          f"bytes per slot {sum_g['state_bytes_per_slot']['cross_caches']}; peak memory GB "
          f"{sum_g['peak_mem_gb']}", flush=True)
    del model, reqs, probe
    gc.collect()
    torch.cuda.empty_cache()

    model = config_model(dev, LLAVA)
    cfg = model[0]
    reqs = vlm_requests(dev, cfg)
    runs["llava"], sum_g, tok_g, tr_g = serve_model_api(dev, model, reqs, VLM_MAX_SEQ,
                                                        VLM_NEW_TOKENS, profile_tick=PROFILE_TICK)
    print_model_api("(ad) image path, contiguous pool, graphed", LLAVA, sum_g)
    runs["llava eager"], sum_e, tok_e, tr_e = serve_model_api(
        dev, model, reqs, VLM_MAX_SEQ, VLM_NEW_TOKENS, eager_run=True)
    print_model_api("(ad') eager (built under steps.eager())", LLAVA, sum_e)
    rows = check_bitwise(f"{LLAVA} graphed vs eager", tok_g, tr_g, tok_e, tr_e)
    print(f"{LLAVA} (ad): {len(reqs)} requests of {cfg.num_image_tokens} patch rows + "
          f"{VLM_TEXT} text tokens; graphed = eager, greedy tokens identical, {rows} logits rows "
          f"bit for bit; replay median {sum_g['replay_ms_median']} ms (eager "
          f"{np.median(sum_e['tick_ms']):.2f}); peak memory GB {sum_g['peak_mem_gb']}",
          flush=True)
    del reqs
    runs["llava paged"], sum_p, _, _ = serve_main_path(
        dev, model=model, prompts=VLM_TEXT_PROMPTS, new_tokens=VLM_TEXT_NEW_TOKENS)
    print_serve("(ad'') text only, paged engine, graphed", sum_p, LLAVA)
    del model
    gc.collect()
    torch.cuda.empty_cache()


# ---- training (PR 30): runs (ae)-(ag') ------------------------------------
# B3-bwd against its plain version (tests/test_torch_cuda.py's rule): both
# work in f32 from the same operands (the kernel's forward output and LSE);
# their sums run in other orders, and a bf16 gradient rounds once, so an
# element may differ by one bf16 ulp of itself (2^-7 |x|) plus the f32 sums'
# difference (atol). (atol, rtol) by operand type
B3_BWD_TOL = {"bf16": (1e-3, 2.0 ** -7), "f32": (1e-4, 1e-4)}
TRAIN_ARCH = "qwen3-0.6b"
# the train_4k cell of configs/shapes.py, its global batch cut from 256 to
# 4 sequences so that one card holds the step (the (4, 4096, 151936) bf16
# logits and their f32 copy in the cross-entropy take ~15 GB)
TRAIN_SHAPE = dict(name="train_4k", seq_len=4096, global_batch=4, kind="train")
TRAIN_STEPS, TRAIN_CKPT_EVERY = 8, 6
# run (ae)'s windowed case at the training shape (gemma3-12b's window)
B3_BWD_WINDOW = 1024


def b3_bwd_executed(hd: int, kind: str) -> int:
    """Flops B3-bwd's design executes per kept (query, key) pair, in units
    of HD (csrc/flash_prefill_bwd.cu's header): bf16 S, P^T·dO (hi + lo) in
    the dV pass, S, dP, dS^T·Q (hi + lo) in the dK pass, S, dP, dS·K (hi +
    lo) for dQ: 22; at HD 256 both consumers of a tile compute S and dP for
    their half of the channels: 32. f32: 14 (S and dP twice)."""
    if kind == "f32":
        return 14
    return 32 if hd > 128 else 22
TRAIN_OPT = dict(lr=1e-3, warmup_steps=3, total_steps=TRAIN_STEPS)
# run (am'): AdamW steps on the EF21-compressed gradients
COMPRESSED_STEPS = 4
# run (af): qwen3-0.6b's widths cut to this many layers; every parameter's
# gradient through B3 + B3-bwd against the same through their plain
# versions, each leaf within GRAD_CHECK_LIMIT of its largest magnitude. The
# two runs differ only in the attention's roundings (B3's bf16 output
# within one ulp of the plain version's), which the bf16 model carries
# into every gradient; a wrong or missing gradient term moves a leaf by
# O(1) of its largest value
GRAD_LAYERS, GRAD_CHECK_LIMIT = 2, 2.0 ** -4


def train_config():
    """The training runs' model: full-width TRAIN_ARCH."""
    from repro_torch.configs import get_config
    return get_config(TRAIN_ARCH)


def b3_bwd_pairs(t: int, s_len: int, causal: bool, window: int) -> int:
    """(query, key) pairs one head keeps at q_offset 0."""
    if not causal:
        return t * s_len
    i = np.arange(t)
    kept = np.minimum(i + 1, s_len)
    if window > 0:
        kept = np.minimum(kept, window)
    return int(kept.sum())


def sdpa_backward(q, k, v, dout, causal: bool, window: int, iters: int):
    """The yardstick, timed and used nowhere in the port: the backward of
    one ``scaled_dot_product_attention`` call (``enable_gqa``; causal, or a
    boolean mask for the window) on the same tensors, by CUDA events. Returns
    (ms, its (dq, dk, dv) in B3's layout)."""
    import torch
    import torch.nn.functional as F
    bh, t, _ = q.shape
    bkv, s_len = k.shape[:2]
    q4, k4, v4 = (x[None].detach().requires_grad_() for x in (q, k, v))
    mask = None
    if window:
        i = torch.arange(t, device=q.device)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    out = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                         is_causal=causal and not window,
                                         enable_gqa=bkv != bh)
    grad = lambda: torch.autograd.grad(out, (q4, k4, v4), dout[None],   # noqa: E731
                                       retain_graph=True)
    grads = tuple(g[0] for g in grad())
    return events_ms(grad, iters), grads


def b3_bwd_case(dev, gen, label: str, h: int, kv: int, t: int, s_len: int, hd: int, dtype,
                causal=True, window=0, iters=5) -> dict:
    """B3-bwd at one shape (h query heads over kv, the batch folded in):
    dQ, dK and dV against the plain version on the same forward output and
    LSE (each gradient's max |kernel - plain| over atol + rtol·|plain|),
    its time by `graph_ms`, the plain version's and SDPA's backward by CUDA
    events, and its bound (10·HD flops per kept pair at the operand type's
    peak; inputs and gradients read or written once). SDPA's own gradients
    are held to the same tolerance against the plain version and printed:
    a reading, never a gate. TFLOP/s are printed on the bound's work and on
    the work the design executes (`b3_bwd_executed`)."""
    import torch
    from repro_torch.kernels.flash_prefill import ops as fp
    kind = "bf16" if dtype == torch.bfloat16 else "f32"
    atol, rtol = B3_BWD_TOL[kind]
    q = torch.randn((h, t, hd), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((kv, s_len, hd), generator=gen, device=dev).to(dtype) for _ in range(2))
    dout = torch.randn((h, t, hd), generator=gen, device=dev).to(dtype)
    mask = dict(causal=causal, window=window)
    out, lse = fp.flash_attention_lse(q, k, v, **mask)
    got = fp.flash_attention_backward(q, k, v, out, dout, lse, **mask)
    want = fp.flash_attention_backward_plain(q, k, v, out, dout, lse, **mask)

    def ratios_of(grads):
        return {name: float(((a.float() - b.float()).abs()
                             / (atol + rtol * b.float().abs())).max())
                for name, a, b in zip(("dq", "dk", "dv"), grads, want)}
    errs = {name: float((a.float() - b.float()).abs().max())
            for name, a, b in zip(("dq", "dk", "dv"), got, want)}
    ratios = ratios_of(got)
    for name in ratios:
        if not ratios[name] <= 1.0:
            raise AssertionError(f"B3-bwd {label} {name}: |kernel - plain| reaches "
                                 f"{ratios[name]:.3g}x its bound {atol:g} + {rtol:g}·|plain| "
                                 f"(max abs err {errs[name]})")
    del got
    ms = graph_ms(lambda: fp.flash_attention_backward(q, k, v, out, dout, lse, **mask), iters)
    plain_ms = events_ms(lambda: fp.flash_attention_backward_plain(q, k, v, out, dout, lse,
                                                                   **mask), 1)
    lib, lib_grads = sdpa_backward(q, k, v, dout, causal, window, iters)
    lib_ratios = ratios_of(lib_grads)
    del want, lib_grads
    pairs = b3_bwd_pairs(t, s_len, causal, window) * h
    elt = q.element_size()
    moved = elt * 2 * (3 * q.numel() + 2 * k.numel()) + 4 * lse.numel()
    bms, bby = bound(moved, 10 * hd * pairs, kind)
    executed = b3_bwd_executed(hd, kind)
    line = (f"B3-bwd {label} ({kind}, {h} H / {kv} KV, HD {hd}, T {t}, S {s_len}, "
            f"{'causal' if causal else 'unmasked'}{f', window {window}' if window else ''}): "
            + ", ".join(f"{n} max_abs_err={errs[n]:.3g} ({ratios[n]:.3g} of {atol:g} + "
                        f"{rtol:g}*|plain|)" for n in errs)
            + f"; ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib:.4f} (SDPA backward; its "
            f"gradients at " + ", ".join(f"{n} {r:.3g}" for n, r in lib_ratios.items())
            + f" of the same tolerance, a reading) bound_ms={bms:.5f} ({bby}); "
            f"{10 * hd * pairs / ms / 1e9:.1f} TFLOP/s of the bound's work (10*HD a pair), "
            f"{executed * hd * pairs / ms / 1e9:.1f} of the work executed ({executed}*HD)")
    return dict(label=label, errs=errs, ratios=ratios, tol=(atol, rtol), ms=ms,
                plain_ms=plain_ms, library_ms=lib, library_ratios=lib_ratios, bound_ms=bms,
                bound_by=bby, tflops_bound_work=10 * hd * pairs / ms / 1e9,
                tflops_executed=executed * hd * pairs / ms / 1e9, line=line)


def check_b3_bwd(dev) -> dict:
    """Run (ae): B3-bwd at qwen3-0.6b's training shapes (TRAIN_SHAPE's batch
    of 4 × 16 heads over 8 KV, HD 128, T 4096, bf16; causal, and under a
    window of 1024), whisper-small's encoder (4 × 12 heads, HD 64, T 4096
    unmasked) and its cross-attention (the 448-token decoder stream over
    4096 frames), gemma3-12b's (4 × 16 heads over 8 KV, HD 256, T 4096;
    causal and under the window) and one f32 case. Returns the kernel's
    record (the causal qwen3 shape, its launches counted on run (ag))."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(30)
    b, t = TRAIN_SHAPE["global_batch"], TRAIN_SHAPE["seq_len"]
    bf = torch.bfloat16
    cases = [
        b3_bwd_case(dev, gen, "qwen3-0.6b", b * 16, b * 8, t, t, 128, bf),
        b3_bwd_case(dev, gen, "qwen3-0.6b window", b * 16, b * 8, t, t, 128, bf,
                    window=B3_BWD_WINDOW),
        b3_bwd_case(dev, gen, "whisper-small encoder", b * 12, b * 12, t, t, 64, bf,
                    causal=False),
        b3_bwd_case(dev, gen, "whisper-small cross", b * 12, b * 12, min(448, t), t, 64, bf,
                    causal=False),
        # gemma3-12b's training shape (16 H / 8 KV, HD 256), causal and under its
        # sliding window
        b3_bwd_case(dev, gen, "gemma3-12b", b * 16, b * 8, t, t, 256, bf),
        b3_bwd_case(dev, gen, "gemma3-12b window", b * 16, b * 8, t, t, 256, bf,
                    window=B3_BWD_WINDOW),
        b3_bwd_case(dev, gen, "qwen3-0.6b f32", 16, 8, t // 2, t // 2, 128, torch.float32),
    ]
    for c in cases:
        print(c["line"], flush=True)
    main, win = cases[0], cases[1]
    worst = max(main["ratios"], key=main["ratios"].get)
    atol, rtol = main["tol"]
    return dict(name="flash_prefill_bwd", counter="flash_prefill_bwd", route="cuda",
                source="src/repro_torch/csrc/flash_prefill_bwd.cu",
                replaces="src/repro/models/attention.py:64",
                replaces_note="no TPU kernel: the reference's gradient is XLA's autodiff of "
                              "flash_attention_xla",
                launches=None, max_abs_err=max(main["errs"].values()),
                tolerance=f"{atol:g} + 2^-7*|plain|", err_over_tol=main["ratios"][worst],
                errs=main["errs"], ms=main["ms"], graph_ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=main["library_ms"],
                library_call="scaled_dot_product_attention backward (is_causal, enable_gqa)",
                window=B3_BWD_WINDOW, window_ms=win["ms"], window_max_abs_err=max(win["errs"].values()),
                window_err_over_tol=max(win["ratios"].values()),
                window_bound_ms=win["bound_ms"], window_bound_by=win["bound_by"],
                window_library_ms=win["library_ms"], run="train",
                cases={c["label"]: {k: c[k] for k in ("errs", "ratios", "ms", "plain_ms",
                                                     "library_ms", "library_ratios", "bound_ms",
                                                     "tflops_bound_work", "tflops_executed")}
                       for c in cases})


# ---- runs (an), (ao): B3 and B3-bwd at a query offset -----------------------
# A context-parallel rank of the training step (`models.attention`, cp)
# holds the query rows [r·T/M, (r+1)·T/M) at q_offset r·T/M over the
# gathered keys [0, (r+1)·T/M): (an) phi3-medium-14b's training attention
# (40 H / 10 KV, HD 128), and qwen3-0.6b's (16 H / 8 KV) under gemma3's
# window of 1024; (ao) granite-moe-3b-a800m's (24 H / 8 KV: G 3, HD 64); at
# TRAIN_SHAPE's batch of 4 × 4096, bf16, in CP_SHARDS query shards. Per case
# (label, heads, KV heads, window, head dim, run, the suffix of the last
# shard's records in the JSON line or None)
CP_SHARDS = 4
CP_CASES = (("phi3-medium-14b", 40, 10, 0, 128, "an", ""),
            ("qwen3-0.6b window", 16, 8, B3_BWD_WINDOW, 128, "an", None),
            ("granite-moe-3b-a800m", 24, 8, 0, 64, "ao", ", granite"),
            ("recurrentgemma-2b", 10, 1, 2048, 256, "aq", ", recurrentgemma"))
# B3's LSE against its plain version: both f32, the kernel's from bf16
# products with its row max and exponential sums in another order over the
# key tiles (exp2 and log2 units), the plain version's torch.logsumexp
B3_LSE_TOL = (1e-4, 1e-5)          # (atol, rtol)


def offset_pairs(tq: int, q_offset: int, window: int) -> int:
    """(query, key) pairs one head keeps for causal rows at positions
    [q_offset, q_offset + tq) (under a window: keys kpos > qpos - window)."""
    kept = q_offset + np.arange(tq) + 1
    if window > 0:
        kept = np.minimum(kept, window)
    return int(kept.sum())


def sdpa_offset(q, k, v, dout, q_offset: int, window: int, iters: int) -> tuple[float, float]:
    """The yardstick for a shard, timed and used nowhere in the port:
    ``scaled_dot_product_attention`` on the shard's rows with an explicit
    boolean mask (``is_causal`` aligns the diagonal top-left, which an
    offset shard does not have), ``enable_gqa``: (forward ms, backward ms) by
    CUDA events."""
    import torch
    import torch.nn.functional as F
    bh, t, _ = q.shape
    s_len = k.shape[1]
    qpos = q_offset + torch.arange(t, device=q.device)[:, None]
    kpos = torch.arange(s_len, device=q.device)[None, :]
    mask = kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    q4, k4, v4 = (x[None].detach().requires_grad_() for x in (q, k, v))
    call = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,   # noqa: E731
                                                  enable_gqa=k.shape[0] != bh)
    fwd = events_ms(lambda: call(), iters)
    out = call()
    bwd = events_ms(lambda: torch.autograd.grad(out, (q4, k4, v4), dout[None],
                                                retain_graph=True), iters)
    return fwd, bwd


def check_cp_shards(dev, iters=5) -> tuple[list, Counter]:
    """Runs (an) and (ao): per case of CP_CASES, the whole sequence through B3's LSE
    form and B3-bwd once (the unsharded call), then each of CP_SHARDS query
    shards through the same two kernels at its q_offset: the shard's out and
    LSE against the plain version (B3's one-ulp rule; `B3_LSE_TOL`) and its
    dQ, dK, dV against `flash_attention_backward_plain` at the offset
    (`B3_BWD_TOL`); its out, LSE and dQ equal to the unsharded call's rows
    bit for bit (a shard's query tiles start on the whole call's tile bounds
    and visit the same key tiles in the same order, by position), its dK/dV
    summed over the shards against the unsharded call's within `B3_BWD_TOL`
    counted once for each rounding: atol + 2^-7·(|whole| + Σ|shard's|) (the
    shards split each key's sum over the query rows into M partial sums,
    each rounded once to bf16 before the sum, as the cp ranks' reduce-scatter
    of dK and dV sums them). Each shard's kernels timed by `graph_ms`,
    their bounds from its kept pairs, SDPA on the shard with a boolean mask.
    Returns (B3's and B3-bwd's records at the last, longest shard of each
    case that names a suffix, the wrapper launches of the shards' calls by
    run: (an), (ao))."""
    import torch
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.kernels.flash_prefill import ops as fp
    gen = torch.Generator(device=dev).manual_seed(34)
    b, t = TRAIN_SHAPE["global_batch"], TRAIN_SHAPE["seq_len"]
    atol, rtol = B3_BWD_TOL["bf16"]
    launched = {}
    recs = []
    for label, h, kv, window, hd, run, suffix in CP_CASES:
        q = torch.randn((b * h, t, hd), generator=gen, device=dev).to(torch.bfloat16)
        k, v = (torch.randn((b * kv, t, hd), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2))
        dout = torch.randn((b * h, t, hd), generator=gen, device=dev).to(torch.bfloat16)
        mask = dict(causal=True, window=window)
        whole_out, whole_lse = fp.flash_attention_lse(q, k, v, **mask)
        whole = fp.flash_attention_backward(q, k, v, whole_out, dout, whole_lse, **mask)
        n = t // CP_SHARDS
        sums = {name: torch.zeros_like(k, dtype=torch.float32) for name in ("dk", "dv")}
        mags = {name: torch.zeros_like(k, dtype=torch.float32) for name in ("dk", "dv")}
        for r in range(CP_SHARDS):
            a, e = r * n, (r + 1) * n
            sq, sdo = q[:, a:e].contiguous(), dout[:, a:e].contiguous()
            sk, sv = k[:, :e].contiguous(), v[:, :e].contiguous()
            at = dict(mask, q_offset=a)
            before = Counter(LAUNCHES)
            out, lse = fp.flash_attention_lse(sq, sk, sv, **at)           # the shard's run
            grads = fp.flash_attention_backward(sq, sk, sv, out, sdo, lse, **at)
            torch.cuda.synchronize()
            launched.setdefault(run, Counter()).update(
                {key: c - before[key] for key, c in LAUNCHES.items() if c > before[key]})
            p_out, p_lse = fp.flash_attention_lse_plain(sq, sk, sv, **at)
            want = fp.flash_attention_backward_plain(sq, sk, sv, out, sdo, lse, **at)
            o_ratio = float(((out.float() - p_out.float()).abs()
                             / (B3_ATOL + B3_RTOL * p_out.float().abs())).max())
            l_ratio = float(((lse - p_lse).abs()
                             / (B3_LSE_TOL[0] + B3_LSE_TOL[1] * p_lse.abs())).max())
            g_ratio = {name: float(((x.float() - y.float()).abs()
                                    / (atol + rtol * y.float().abs())).max())
                       for name, x, y in zip(("dq", "dk", "dv"), grads, want)}
            errs = {name: float((x.float() - y.float()).abs().max())
                    for name, x, y in zip(("dq", "dk", "dv"), grads, want)}
            tag = f"({run}) {label} shard {r} (q_offset {a}, keys [0, {e}))"
            for what, ratio in (("out", o_ratio), ("lse", l_ratio), *g_ratio.items()):
                if not ratio <= 1.0:
                    raise AssertionError(f"{tag}: {what} reaches {ratio:.3g}x its bound "
                                         "against the plain version")
            for what, x, y in (("out", out, whole_out[:, a:e]), ("lse", lse, whole_lse[:, a:e]),
                               ("dq", grads[0], whole[0][:, a:e])):
                if not torch.equal(x, y):
                    raise AssertionError(f"{tag}: {what} differs from the unsharded call's "
                                         f"rows on {int((x != y).sum())} elements")
            for name, g in (("dk", grads[1]), ("dv", grads[2])):
                sums[name][:, :e] += g.float()
                mags[name][:, :e] += g.float().abs()
            del p_out, p_lse, want
            f_ms = graph_ms(lambda: fp.flash_attention_lse(sq, sk, sv, **at), iters)
            b_ms = graph_ms(lambda: fp.flash_attention_backward(sq, sk, sv, out, sdo, lse,
                                                                **at), iters)
            f_plain = events_ms(lambda: fp.flash_attention_lse_plain(sq, sk, sv, **at), 1)
            b_plain = events_ms(lambda: fp.flash_attention_backward_plain(
                sq, sk, sv, out, sdo, lse, **at), 1)
            f_lib, b_lib = sdpa_offset(sq, sk, sv, sdo, a, window, iters)
            pairs = offset_pairs(n, a, window) * b * h
            f_bytes = 2 * (2 * sq.numel() + sk.numel() + sv.numel()) + 4 * lse.numel()
            b_bytes = 2 * (3 * sq.numel() + 2 * sk.numel() + 2 * sv.numel()) + 4 * lse.numel()
            f_bound, f_by = bound(f_bytes, 4 * hd * pairs, "bf16")
            b_bound, b_by = bound(b_bytes, 10 * hd * pairs, "bf16")
            print(f"{tag}, {b * h} H / {b * kv} KV, HD {hd}, bf16: out {o_ratio:.3g}, lse "
                  f"{l_ratio:.3g}, " + ", ".join(f"{n_} {x:.3g}" for n_, x in g_ratio.items())
                  + " of their bounds against the plain version; out, lse, dq bit for bit "
                  f"with the unsharded call; B3 graph_ms={f_ms:.4f} bound_ms={f_bound:.5f} "
                  f"({f_by}) plain_ms={f_plain:.2f} SDPA fwd {f_lib:.4f}; B3-bwd graph_ms="
                  f"{b_ms:.4f} bound_ms={b_bound:.5f} ({b_by}) plain_ms={b_plain:.2f} SDPA bwd "
                  f"{b_lib:.4f}", flush=True)
            if r == CP_SHARDS - 1 and suffix is not None:
                common = dict(route="cuda", launches=None, run=run, q_offset=a, keys=e,
                              shape=f"{b * h} H / {b * kv} KV, HD {hd}, {n} rows, {label}")
                recs.append(dict(
                    common, name=f"flash_prefill[q_offset{suffix}]", counter="flash_prefill",
                    source="src/repro_torch/csrc/flash_prefill.cu",
                    replaces="src/repro/kernels/flash_prefill/kernel.py:98",
                    max_abs_err=float((out.float() - fp.flash_attention_lse_plain(
                        sq, sk, sv, **at)[0].float()).abs().max()),
                    tolerance=f"{B3_ATOL:g} + 2^-7*|plain|", err_over_tol=o_ratio,
                    lse_over_tol=l_ratio, ms=f_ms, graph_ms=f_ms, plain_ms=f_plain,
                    bound_ms=f_bound, bound_by=f_by, library_ms=f_lib,
                    library_call="scaled_dot_product_attention (boolean mask, enable_gqa)"))
                recs.append(dict(
                    common, name=f"flash_prefill_bwd[q_offset{suffix}]",
                    counter="flash_prefill_bwd",
                    source="src/repro_torch/csrc/flash_prefill_bwd.cu",
                    replaces="src/repro/models/attention.py:64",
                    replaces_note="no TPU kernel: the reference's gradient is XLA's autodiff "
                                  "of flash_attention_xla",
                    max_abs_err=max(errs.values()), errs=errs,
                    tolerance=f"{atol:g} + 2^-7*|plain|", err_over_tol=max(g_ratio.values()),
                    ms=b_ms, graph_ms=b_ms, plain_ms=b_plain, bound_ms=b_bound, bound_by=b_by,
                    library_ms=b_lib,
                    library_call="scaled_dot_product_attention backward (boolean mask)"))
        for name, ref in (("dk", whole[1]), ("dv", whole[2])):
            ref = ref.float()
            diff = (sums[name] - ref).abs()
            ratio = float((diff / (atol + rtol * (ref.abs() + mags[name]))).max())
            once = float((diff / (atol + rtol * ref.abs())).max())
            if not ratio <= 1.0:
                raise AssertionError(f"({run}) {label}: the shards' summed {name} reaches "
                                     f"{ratio:.3g}x its bound against the unsharded call's")
            print(f"({run}) {label}: the {CP_SHARDS} shards' summed {name} within {ratio:.3g} of "
                  f"{atol:g} + 2^-7*(|whole| + sum|shard's|) of the unsharded call's "
                  f"({once:.3g} of {atol:g} + 2^-7*|whole|, a reading)", flush=True)
        del q, k, v, dout, whole_out, whole_lse, whole, sums, mags
        torch.cuda.empty_cache()
    return recs, launched


# ---- run (ao'): granite's full-width MoE layer as 4 ep ranks run it --------
# One MoE layer of granite-moe-3b-a800m (d 1536, 40 experts padded to 48,
# top 8, d_ff 512 an expert), bf16, on TRAIN_SHAPE's 4 × 4096 tokens, run as
# the EP_RANKS ranks of a (1, 4) mesh would run it under ``ep``, one after
# another on one card: each rank's steps of `models.moe` (its sequence
# shard's routing, counts → offsets → positions, its dispatch buffer, its
# 12 experts, the combine of its tokens), with the tensors that the
# collectives would return passed by hand (the counts stacked, the dispatch
# buffers summed and cut by expert: the reduce-scatter; the experts' outputs
# concatenated: the all-gather); the whole differentiated at once
EP_RANKS = 4
# bf16 outputs and gradients against the unsharded layer's: the expert
# products over 12 experts may take other GEMMs than over 48, so an
# element may round to a neighbour (one bf16 ulp of the tensor's largest
# magnitude, 2^-8, twice: the product and the combine) — the CPU tests hold
# the same steps within 1e-5 in f32
EP_LAYER_TOL = 2.0 ** -7


def check_ep_layer(dev) -> dict:
    """Run (ao') (above): every rank's ``topi``, ``pos`` and ``keep`` equal
    to the unsharded `models.moe.route`'s rows exactly; the output, the load-
    balancing loss and the gradients of x, the router and the three expert
    weights (the loss: the output against a random cotangent plus 0.01 ×
    aux, as `lm_loss` weighs it) within EP_LAYER_TOL of each tensor's
    largest magnitude of the unsharded `moe_apply`'s. Prints the share of
    dropped (token, choice) pairs and each side's ms (CUDA events)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.flags import PERF
    from repro_torch.models import moe
    t0 = time.time()
    cfg = get_config(GRANITE)
    b, t = TRAIN_SHAPE["global_batch"], TRAIN_SHAPE["seq_len"]
    d, e, f = cfg.d_model, cfg.padded_experts, cfg.moe_d_ff
    gen = torch.Generator(device=dev).manual_seed(35)

    def randn(*shape, scale, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)
    params = {"router": randn(d, e, scale=d ** -0.5, dtype=torch.float32),
              "w_gate": randn(e, d, f, scale=d ** -0.5), "w_up": randn(e, d, f, scale=d ** -0.5),
              "w_down": randn(e, f, d, scale=f ** -0.5)}
    x, cot = randn(b, t, d, scale=1.0), randn(b, t, d, scale=1.0)
    names = ["x", *params]

    def grads_of(out, aux, leaves):
        return torch.autograd.grad((out.float() * cot.float()).sum() + 0.01 * aux, leaves)

    leaves = [x.clone().requires_grad_(), *(v.clone().requires_grad_() for v in params.values())]
    whole = dict(zip(params, leaves[1:]))
    torch.cuda.synchronize()
    t_one = time.time()
    out, aux = moe.moe_apply(whole, leaves[0], cfg)
    want = grads_of(out, aux, leaves)
    torch.cuda.synchronize()
    t_one = (time.time() - t_one) * 1e3
    cap = moe.capacity(t, cfg, tight=PERF.moe_flat_dispatch)
    ref = moe.route(params["router"], x, cfg, cap)

    leaves = [x.clone().requires_grad_(), *(v.clone().requires_grad_() for v in params.values())]
    xs, p = leaves[0], dict(zip(params, leaves[1:]))
    n, el = t // EP_RANKS, e // EP_RANKS
    torch.cuda.synchronize()
    t_ep = time.time()
    tops = [moe.gate_top_k(p["router"], xs[:, r * n:(r + 1) * n], cfg) for r in range(EP_RANKS)]
    counts = torch.stack([moe.expert_counts(topi, e) for _, topi, _ in tops])  # the all-gather
    routes = [moe.positions(*tops[r], cap, moe.queue_offsets(counts, r)) for r in range(EP_RANKS)]
    bufs = [moe.gather_slots(xs[:, r * n:(r + 1) * n], routes[r]) for r in range(EP_RANKS)]
    summed = bufs[0][0]
    for xe, _ in bufs[1:]:
        summed = summed + xe                                   # the reduce-scatter's sum
    ye = torch.cat([moe.expert_glu({k: p[k][r * el:(r + 1) * el]
                                    for k in ("w_gate", "w_up", "w_down")},
                                   summed[r * el:(r + 1) * el], cfg.act)
                    for r in range(EP_RANKS)])                  # the all-gather
    out_ep = torch.cat([moe.combine_slots(routes[r], ye, bufs[r][1]) for r in range(EP_RANKS)], 1)
    sums = moe.aux_sums(routes[0], 0, n)
    for r in range(1, EP_RANKS):
        sums = sums + moe.aux_sums(routes[r], 0, n)            # sum_over_tokens' all-reduce
    aux_ep = moe.aux_from_sums(sums, b * t)
    got = grads_of(out_ep, aux_ep, leaves)
    torch.cuda.synchronize()
    t_ep = (time.time() - t_ep) * 1e3
    for r, rr in enumerate(routes):
        for field in ("topi", "pos", "keep"):
            if not torch.equal(getattr(rr, field), getattr(ref, field)[:, r * n:(r + 1) * n]):
                raise AssertionError(f"(ao') rank {r}: {field} differs from the unsharded "
                                     "routing's rows")
    ratios = {}
    for name, a, w in (("out", out_ep, out), *zip(names, got, want)):
        a, w = a.detach().float(), w.detach().float()
        ratios[name] = float((a - w).abs().max()) / (EP_LAYER_TOL * float(w.abs().max()))
    aux, aux_ep = float(aux.detach()), float(aux_ep.detach())
    ratios["aux"] = abs(aux_ep - aux) / (EP_LAYER_TOL * abs(aux))
    worst = max(ratios, key=ratios.get)
    if not ratios[worst] <= 1.0:
        raise AssertionError(f"(ao') {worst} reaches {ratios[worst]:.3g}x 2^-7 of its largest "
                             "magnitude against the unsharded layer")
    dropped = 1.0 - float(ref.keep.float().mean())
    per_rank = [1.0 - float(rr.keep.float().mean()) for rr in routes]
    print(f"(ao') {GRANITE} MoE layer, bf16, {b} x {t} tokens as {EP_RANKS} ep ranks on one "
          f"card: topi, pos and keep of every rank equal to the unsharded routing's rows; "
          + ", ".join(f"{k} {v:.3g}" for k, v in ratios.items())
          + f" of 2^-7 of their largest magnitudes; capacity {cap}, dropped (token, choice) "
          f"pairs {dropped:.4f} (by rank {', '.join(f'{x:.4f}' for x in per_rank)}); "
          f"aux {aux:.6f} / {aux_ep:.6f}; forward + backward unsharded "
          f"{t_one:.1f} ms, emulated ranks {t_ep:.1f} ms (first calls); {time.time() - t0:.1f} s",
          flush=True)
    del out, want, got, bufs, summed, ye, out_ep
    torch.cuda.empty_cache()
    return dict(ratios=ratios, dropped=dropped, dropped_by_rank=per_rank)


# ---- run (ap): the SSD and RG-LRU blocks at full width as 4 model ranks ----
# One "S" layer of mamba2-2.7b (d 2560, d_inner 5120: 80 heads of 64, state
# 128, chunk 256) and one "R" block of recurrentgemma-2b (d 2560, RG-LRU
# width 2560, d_ff 7680), bf16, random weights from a seeded generator
# (`weights.init_lm_params` of a one-layer config), on TRAIN_SHAPE's 4 ×
# 4096 tokens, run as the TP_RANKS ranks of a (1, 4) mesh run them in
# training, one after another on one card: each rank's blocks of the
# reference's specs (`param_specs`, `local_block`), its heads
# (`ssm.head_block`, `ssm.ssd_scan`) or channels, with the tensors that the
# collectives would return passed by hand (the sequence gathered: the whole
# normed input; the SSD norm's all-reduce: the ranks' sums of squares
# summed; the RG-LRU's two gate reduce-scatters: the ranks' partials summed
# and cut to each rank's channels; the closing reduce-scatters: the ranks'
# partial outputs summed); the whole differentiated at once
TP_RANKS = 4
# bf16 outputs and gradients against the unsharded block's, in units of 2^-7
# of the tensor's largest magnitude: the unsharded bf16 block itself sits up
# to 1.58 of them from an f32 truth of the same block on an H100 (dt_bias;
# w_B 1.37, w_C 1.42), and the layout adds one bf16 rounding a rank where
# each rank's partial (an output, dx, a replicated leaf's gradient: its
# heads' or channels' part) rounds before the ranks' sum, as the
# collectives sum it. So the limit counts 2^-7 once for each of the
# TP_RANKS rounded partials (as (an)'s dK / dV rule counts each shard's);
# each reading is printed against 2^-7 too, with both sides' distances from
# the f32 truth. A missed or doubled sum over the ranks moves a tensor by
# O(1) of its largest magnitude: 128 units. The CPU tests hold the same
# layers within 1e-5 in f32
TP_LAYER_TOL = 2.0 ** -7
TP_LAYER_ROUNDINGS = TP_RANKS


def _tp_rank_blocks(sctx, layer: dict, r: int) -> dict:
    """Model rank ``r``'s blocks of a layer's leaves (a nested dict) under
    the reference's specs on a (1, TP_RANKS) mesh."""
    from repro_torch.distributed.sharding import DecodeCtx, Mesh, local_block, param_specs
    from repro_torch.runtime.tree import leaves
    flat = {f"layers/0/{p}": t for p, t in leaves(layer)}
    specs = param_specs(sctx, {p: tuple(t.shape) for p, t in flat.items()})
    mesh = Mesh(dict(sctx.mesh.shape), DecodeCtx(None, r, TP_RANKS, "nccl"))
    out = {}
    for path, t in flat.items():
        node = out
        *keys, last = path.split("/")[2:]
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = t[local_block(mesh, specs[path], t.shape)]
    return out


def _tp_s_block(sctx, layer: dict, x, cfg):
    """An "S" block as the TP_RANKS ranks compute it (`ssm.ssd_train`'s
    model-axis branch), the collectives by hand."""
    import torch
    from repro_torch.models import ssm
    from repro_torch.models.common import rmsnorm
    di = cfg.ssm_expand * cfg.d_model
    nh = di // cfg.ssm_head_dim
    xn = rmsnorm(layer["ln1"], x, cfg.norm_eps)            # the gathered sequence
    ranks = []
    for r in range(TP_RANKS):
        p = _tp_rank_blocks(sctx, layer, r)["ssd"]
        y, up, _, _ = ssm.ssd_scan(ssm.head_block(p, cfg, r, TP_RANKS), xn, cfg,
                                   (di // TP_RANKS, nh // TP_RANKS))
        ranks.append((p, y, up))
    total = sum(y.float().square().sum(-1, keepdim=True) for _, y, _ in ranks)  # all-reduce
    out = None
    for p, y, up in ranks:
        yn = (y.float() * torch.rsqrt(total / di + cfg.norm_eps)
              * p["norm"]["scale"].float()).to(y.dtype)
        part = ssm.gated_out(p, yn, up)[:, :x.shape[1]]
        out = part if out is None else out + part           # the reduce-scatter's sum
    return x + out


def _tp_r_block(sctx, layer: dict, x, cfg):
    """An "R" block as the TP_RANKS ranks compute it (`rglru.rglru_train`'s
    model-axis branch, then `parallel_glu`), the collectives by hand."""
    import torch.nn.functional as F
    from repro_torch.models import rglru
    from repro_torch.models.common import glu_apply, rmsnorm
    from repro_torch.models.ssm import causal_conv
    n = (cfg.rnn_width or cfg.d_model) // TP_RANKS
    xn = rmsnorm(layer["ln1"], x, cfg.norm_eps)
    blocks = [_tp_rank_blocks(sctx, layer, r) for r in range(TP_RANKS)]
    xs = [causal_conv(xn @ b["rglru"]["w_x"], b["rglru"]["conv_w"])[0].float() for b in blocks]
    zr = sum(xf @ b["rglru"]["w_r"] for xf, b in zip(xs, blocks))   # the partials' sums
    zi = sum(xf @ b["rglru"]["w_i"] for xf, b in zip(xs, blocks))
    out = None
    for r, (b, xf) in enumerate(zip(blocks, xs)):
        p = b["rglru"]
        a, bb = rglru.gate_terms(p, xf, zr[..., r * n:(r + 1) * n], zi[..., r * n:(r + 1) * n])
        _, h = rglru.associative_scan(a, bb)
        y = h.to(x.dtype) * F.gelu(xn @ p["w_gate_out"], approximate="tanh")
        part = y @ p["w_out"]
        out = part if out is None else out + part
    x = x + out
    x2 = rmsnorm(layer["ln2"], x, cfg.norm_eps)
    f = None
    for b in blocks:
        part = glu_apply(b["ffn"]["glu"], x2, cfg.act)
        f = part if f is None else f + part
    return x + f


def check_tp_recurrent(dev) -> dict:
    """Run (ap) (above): per block, the output and the gradients of the
    input and of every leaf (the loss: the output against a random
    cotangent) within TP_LAYER_ROUNDINGS × TP_LAYER_TOL of each tensor's
    largest magnitude of the unsharded `blocks.block_train`'s; prints every
    reading in units of TP_LAYER_TOL against that limit, the same unsharded
    block's in f32 (the truth) against both, and each side's ms
    (CUDA-synchronized wall, first calls)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import DecodeCtx, Mesh, ShardingCtx
    from repro_torch.models import blocks as B
    from repro_torch.runtime.tree import leaves, tree_map
    from repro_torch.weights import init_lm_params
    t0 = time.time()
    b, t = TRAIN_SHAPE["global_batch"], TRAIN_SHAPE["seq_len"]
    gen = torch.Generator(device=dev).manual_seed(36)
    out = {}
    for arch, kind, emulated in ((MAMBA, "S", _tp_s_block), (RGEMMA, "R", _tp_r_block)):
        cfg = dataclasses.replace(get_config(arch), num_layers=1)
        assert cfg.block_kinds() == [kind], cfg.block_kinds()
        layer = init_lm_params(cfg, gen, dev)["layers"][0]
        sctx = ShardingCtx(mesh=Mesh({"data": 1, "model": TP_RANKS},
                                     DecodeCtx(None, 0, TP_RANKS, "nccl")),
                           dp=("data",), strategy=cfg.attn_strategy)
        x = torch.randn((b, t, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
        cot = torch.randn((b, t, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
        names = ["out", "x"] + [p for p, _ in leaves(layer)]
        res = {}
        for side in ("whole", "ranks", "truth"):
            up = (lambda z: z.float()) if side == "truth" else (lambda z: z)
            c = dataclasses.replace(cfg, dtype="float32") if side == "truth" else cfg
            xs = up(x).clone().requires_grad_()
            flat = [up(t_).clone().requires_grad_() for _, t_ in leaves(layer)]
            it = iter(flat)
            lay = tree_map(lambda _: next(it), layer)
            torch.cuda.synchronize()
            t1 = time.time()
            y = emulated(sctx, lay, xs, c) if side == "ranks" else B.block_train(lay, xs, c, kind)[0]
            grads = torch.autograd.grad((y.float() * cot.float()).sum(), [xs] + flat)
            torch.cuda.synchronize()
            res[side] = ([y.detach().float()] + [g.float() for g in grads],
                         (time.time() - t1) * 1e3)
            del y, grads, flat, lay, xs
        ratios, truth = {}, {}
        for name, a, w, f in zip(names, res["ranks"][0], res["whole"][0], res["truth"][0]):
            if not bool(torch.isfinite(a).all()):
                raise AssertionError(f"(ap) {arch} {kind}: {name} is not finite")
            unit = TP_LAYER_TOL * float(w.abs().max())
            ratios[name] = float((a - w).abs().max()) / unit
            unit_f = TP_LAYER_TOL * float(f.abs().max())
            truth[name] = (float((w - f).abs().max()) / unit_f, float((a - f).abs().max()) / unit_f)
        worst = max(ratios, key=ratios.get)
        if not ratios[worst] <= TP_LAYER_ROUNDINGS:
            raise AssertionError(f"(ap) {arch} {kind}: {worst} reaches {ratios[worst]:.3g}x 2^-7 "
                                 f"of its largest magnitude against the unsharded block (limit "
                                 f"{TP_LAYER_ROUNDINGS})")
        print(f"(ap) {arch} \"{kind}\" block, bf16, {b} x {t} tokens as {TP_RANKS} model ranks "
              f"on one card, each tensor against the unsharded block's in units of 2^-7 of its "
              f"largest magnitude (limit {TP_LAYER_ROUNDINGS}; above 1: "
              f"{sorted(k for k, v in ratios.items() if v > 1)}): "
              + ", ".join(f"{k} {v:.3g}" for k, v in ratios.items())
              + "; against the f32 truth (unsharded, ranks): "
              + ", ".join(f"{k} {u:.3g}/{v:.3g}" for k, (u, v) in truth.items())
              + f"; forward + backward unsharded {res['whole'][1]:.1f} ms, emulated ranks "
              f"{res['ranks'][1]:.1f} ms (first calls)", flush=True)
        out[arch] = dict(ratios=ratios, truth=truth)
        del layer, res
        torch.cuda.empty_cache()
    print(f"(ap): {time.time() - t0:.1f} s", flush=True)
    return out


def train_gradients(cfg, params, batch, plain: bool):
    """(loss, every parameter's gradient) of ``cfg``'s loss on ``batch``:
    through B3 and B3-bwd, or with ``plain`` through their plain versions
    (patched into `FlashAttentionFn`'s module for the call)."""
    import torch
    from repro_torch.kernels.flash_prefill import ops as fp
    from repro_torch.models import get_model
    from repro_torch.runtime.tree import leaves, tree_map
    plain_fns = {"flash_attention_lse": fp.flash_attention_lse_plain,
                 "flash_attention_backward": fp.flash_attention_backward_plain}
    saved = {n: getattr(fp, n) for n in plain_fns}
    if plain:
        for n, f in plain_fns.items():
            setattr(fp, n, f)
    try:
        p = tree_map(lambda x: x.detach().requires_grad_(), params)
        loss = get_model(cfg).loss(p, batch)
        grads = torch.autograd.grad(loss, [x for _, x in leaves(p)], allow_unused=True,
                                    materialize_grads=True)
    finally:
        for n, f in saved.items():
            setattr(fp, n, f)
    return float(loss.detach()), [k for k, _ in leaves(p)], grads


def check_train_gradients(dev) -> None:
    """Run (af): qwen3-0.6b's widths at GRAD_LAYERS layers, random bf16
    weights from seed 0, one TRAIN_SHAPE batch from `make_batch`: every
    parameter's gradient through B3 + B3-bwd against the same through their
    plain versions on the card, each leaf within GRAD_CHECK_LIMIT of its
    largest magnitude."""
    import dataclasses

    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import common
    from repro_torch.runtime.data import make_batch, to_device
    from repro_torch.weights import init_lm_params
    cfg = dataclasses.replace(train_config(), num_layers=GRAD_LAYERS)
    params = init_lm_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    batch = to_device(make_batch(cfg, ShapeConfig(**TRAIN_SHAPE), 0, 0), dev)
    loss_k, names, gk = train_gradients(cfg, params, batch, plain=False)
    before = dict(common.LAUNCHES)
    loss_p, _, gp = train_gradients(cfg, params, batch, plain=True)
    if dict(common.LAUNCHES) != before:
        raise AssertionError("run (af): the plain run launched a kernel")
    worst, where = 0.0, names[0]
    for n, a, b in zip(names, gk, gp):
        rel = float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))
        if rel > worst:
            worst, where = rel, n
    print(f"(af) {TRAIN_ARCH} widths, {GRAD_LAYERS} layers, batch {TRAIN_SHAPE['global_batch']}"
          f" x {TRAIN_SHAPE['seq_len']}: loss {loss_k:.6f} (kernels) vs {loss_p:.6f} (plain); "
          f"{len(names)} gradient leaves, worst {where} at {worst:.4g} of its largest "
          f"magnitude (limit {GRAD_CHECK_LIMIT:g})", flush=True)
    if not worst <= GRAD_CHECK_LIMIT:
        raise AssertionError(f"run (af): gradient leaf {where} differs by {worst:.4g} of its "
                             f"largest magnitude (limit {GRAD_CHECK_LIMIT:g})")


def ckpt_bytes(directory: str) -> int:
    """Bytes of the checkpoints under ``directory``, each ``step_<N>``."""
    import os
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(directory) for f in files)


def profile_train_step(trainer, batch) -> dict:
    """Device time of one training step (fresh parameters, after a warm-up
    step) from the profiler's trace: in all, in B3 and in B3-bwd."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    params, opt = trainer.init_state()
    trainer.step_fn(params, opt, batch)
    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.step_fn(params, opt, batch)
        torch.cuda.synchronize()
    wall = (time.time() - t0) * 1e3
    tot = {"all": 0.0, "b3": 0.0, "b3_bwd": 0.0}
    count = {"b3": 0, "b3_bwd": 0}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
        tot["all"] += us
        for part, name in (("b3", "flash_prefill_bf16_kernel"), ("b3_bwd", "flash_bwd_")):
            if name in e.key:
                tot[part] += us
                count[part] += e.count
    return {k: v / 1e3 for k, v in tot.items()} | {"wall_ms": wall, "launches": count}


def check_training(dev) -> dict:
    """Runs (ag) and (ag'): full-width qwen3-0.6b (28 layers, random bf16
    weights from seed 0) trained by `Trainer` over `make_batch`'s stream at
    TRAIN_SHAPE for TRAIN_STEPS steps, a checkpoint every TRAIN_CKPT_EVERY
    into a temporary directory; every loss finite and the mean of the last
    three below that of the first three; then a fresh `Trainer` on the
    directory with the last checkpoint removed resumes at step
    TRAIN_CKPT_EVERY and must give the first run's later losses and gradient
    norms bit for bit. Then runs (am) and (am') (`check_sharded_training`)
    against (ag). Returns each run's launch counts by run name."""
    import os
    import tempfile

    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import common
    from repro_torch.runtime import AdamWConfig, Trainer, TrainerConfig
    from repro_torch.runtime.data import make_batch, to_device
    cfg, shape = train_config(), ShapeConfig(**TRAIN_SHAPE)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        def trainer():
            return Trainer(cfg, shape, None,
                           TrainerConfig(num_steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY,
                                         ckpt_dir=tmp, seed=0, log_every=TRAIN_STEPS),
                           AdamWConfig(**TRAIN_OPT), device=dev)
        tr = trainer()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        common.reset_launches()
        t0 = time.time()
        out = tr.train()
        wall = time.time() - t0
        launches = dict(common.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 1e9
        n_attn = cfg.num_layers
        want = {"flash_prefill": 2 * n_attn * TRAIN_STEPS,
                "flash_prefill_bwd": 3 * n_attn * TRAIN_STEPS}
        if launches != want:
            raise AssertionError(f"run (ag): launches {launches}, expected {want} (B3 in the "
                                 "forward and its recomputation, B3-bwd's three kernels)")
        tokens = shape.global_batch * shape.seq_len
        for m in tr.metrics:
            print(f"(ag) step {m['step']}: {m['seconds'] * 1e3:.1f} ms, "
                  f"{tokens / m['seconds']:.0f} tokens/s, loss {m['loss']:.6f}, grad norm "
                  f"{m['grad_norm']:.6f}, lr {m['lr']:.3g}", flush=True)
        losses = out["losses"]
        if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
            raise AssertionError(f"run (ag): losses {losses}")
        if not np.mean(losses[-3:]) < np.mean(losses[:3]):
            raise AssertionError(f"run (ag): the loss did not fall: {losses}")
        steady = [m["seconds"] for m in tr.metrics[1:]]
        print(f"(ag) {TRAIN_ARCH} full width ({n_attn} layers), {TRAIN_STEPS} steps of "
              f"{shape.global_batch} x {shape.seq_len} tokens: loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f} (mean of the first 3 {np.mean(losses[:3]):.4f}, last 3 "
              f"{np.mean(losses[-3:]):.4f}); median step {np.median(steady) * 1e3:.1f} ms "
              f"(steps 1-{TRAIN_STEPS - 1}), {tokens / np.median(steady):.0f} tokens/s; peak "
              f"memory {peak:.3f} GB; launches {launches}; checkpoints "
              f"{tr.ckpt.all_steps()} of {ckpt_bytes(tmp) / 1e9:.2f} GB; train() "
              f"{wall:.1f} s of wall in all", flush=True)
        # (ag') resume from step TRAIN_CKPT_EVERY (the later checkpoint removed)
        shutil.rmtree(os.path.join(tmp, f"step_{TRAIN_STEPS}"))
        tr2 = trainer()
        t0 = time.time()
        out2 = tr2.train()
        wall2 = time.time() - t0
        first = tr2.metrics[0]["step"] if tr2.metrics else None
        keys = ("loss", "grad_norm")
        again = [[m[k] for k in keys] for m in tr2.metrics]
        orig = [[m[k] for k in keys] for m in tr.metrics[TRAIN_CKPT_EVERY:]]
        if first != TRAIN_CKPT_EVERY or out2["final_step"] != TRAIN_STEPS or again != orig:
            raise AssertionError(f"run (ag'): resumed at {first}, losses and gradient norms "
                                 f"{again} vs the uninterrupted run's {orig}")
        print(f"(ag') a fresh Trainer resumed at step {first}: steps {first}-{TRAIN_STEPS - 1} "
              f"give the uninterrupted run's losses and gradient norms bit for bit (train() "
              f"{wall2:.1f} s of wall)", flush=True)
        prof = profile_train_step(tr2, to_device(make_batch(cfg, shape, 0, 0), dev))
        print(f"(ag) one profiled step: device {prof['all']:.1f} ms of {prof['wall_ms']:.1f} "
              f"ms wall; B3 {prof['b3']:.1f} ms ({prof['launches']['b3']} launches in the "
              f"trace of {2 * n_attn}), B3-bwd {prof['b3_bwd']:.1f} ms "
              f"({prof['launches']['b3_bwd']} of {3 * n_attn})", flush=True)
        ag = dict(metrics=tr.metrics, losses=losses, dir=tmp, peak_gb=peak,
                  median_ms=float(np.median(steady) * 1e3))
        del tr, tr2
        torch.cuda.empty_cache()
        return {"train": launches, **check_sharded_training(dev, ag)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_sharded_training(dev, ag: dict) -> dict:
    """Runs (am) and (am'): the (ag) model, shape, seed and optimizer over
    the data axis at one nccl rank (the one-rank world `init_decode_ctx`
    joined). (am): `Trainer(cfg, shape, MeshPlan.for_mesh((1, 1) mesh))`
    for TRAIN_CKPT_EVERY steps, every loss and gradient norm bit for bit
    with (ag)'s (else the first step where they part, and the first leaf
    of that step's checkpointed state, are printed and the run fails), its
    step-6 checkpoint through `restore(shardings=)` bit for bit with (ag)'s;
    (am'): `make_compressed_grad_fn` + AdamW for COMPRESSED_STEPS steps.
    Returns both runs' launch counts."""
    import tempfile

    import torch
    from repro_torch.analysis.collectives import TRACE
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed.compression import make_compressed_grad_fn
    from repro_torch.distributed.sharding import COLLECTIVES
    from repro_torch.kernels import common
    from repro_torch.launch.mesh import make_data_mesh
    from repro_torch.models import get_model
    from repro_torch.runtime import (AdamWConfig, CheckpointManager, Trainer, TrainerConfig,
                                     adamw_update, init_opt_state)
    from repro_torch.runtime.data import make_batch, to_device
    from repro_torch.runtime.steps import MeshPlan
    from repro_torch.runtime.tree import leaves, tree_map
    from repro_torch.weights import init_lm_params
    cfg, shape = train_config(), ShapeConfig(**TRAIN_SHAPE)
    steps, n_attn = TRAIN_CKPT_EVERY, cfg.num_layers
    tokens = shape.global_batch * shape.seq_len
    mesh = make_data_mesh(dev)
    plan = MeshPlan.for_mesh(mesh)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_sharded_")
    t_am = time.time()
    try:
        tr = Trainer(cfg, shape, plan, TrainerConfig(num_steps=steps, ckpt_every=steps,
                                                     ckpt_dir=tmp, seed=0, log_every=steps),
                     AdamWConfig(**TRAIN_OPT), device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        common.reset_launches()
        COLLECTIVES.clear()
        TRACE.reset()
        t0 = time.time()
        out = tr.train()
        wall = time.time() - t0
        launches = dict(common.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 1e9
        per_step = {k: v / steps for k, v in COLLECTIVES.items()}
        want = {"flash_prefill": 2 * n_attn * steps, "flash_prefill_bwd": 3 * n_attn * steps}
        if launches != want:
            raise AssertionError(f"run (am): launches {launches}, expected {want}")
        keys = ("loss", "grad_norm")
        got = [[m[k] for k in keys] for m in tr.metrics]
        ref = [[m[k] for k in keys] for m in ag["metrics"][:steps]]
        n_sharded = sum(d is not None for _, _, d in tr.step_fn.layout.values())
        # steps 1..steps-1 of both runs: no checkpoint is being written behind them
        ms = np.median([m["seconds"] * 1e3 for m in tr.metrics[1:]])
        ag_ms = np.median([m["seconds"] * 1e3 for m in ag["metrics"][1:steps]])
        print(f"(am) {TRAIN_ARCH} full width, Trainer over a (1, 1) ('data', 'model') mesh at "
              f"one nccl rank, {steps} steps of {shape.global_batch} x {shape.seq_len}: median "
              f"step {ms:.1f} ms over steps 1-{steps - 1} ((ag)'s same steps: {ag_ms:.1f}), "
              f"{tokens / ms * 1e3:.0f} tokens/s ((ag): {tokens / ag_ms * 1e3:.0f}); peak memory "
              f"{peak:.3f} GB ((ag): {ag['peak_gb']:.3f}); collectives per step {per_step} "
              f"({n_sharded} sharded leaves of {len(tr.step_fn.layout)}; TRACE "
              f"{TRACE.summary()}: a group of one moves no bytes); launches {launches}; "
              f"train() {wall:.1f} s of wall", flush=True)
        for i, (a, b) in enumerate(zip(got, ref)):
            print(f"(am) step {i}: loss {a[0]:.6f} grad norm {a[1]:.6f} ((ag): {b[0]:.6f} "
                  f"{b[1]:.6f})", flush=True)
        if out["final_step"] != steps or got != ref:
            first = next((i for i, (a, b) in enumerate(zip(got, ref)) if a != b), None)
            raise AssertionError(f"run (am): the sharded trainer at one rank parts from (ag) "
                                 f"at step {first}: {got} vs {ref}")
        # its checkpoint's parameters through their shardings, against (ag)'s step 6
        t0 = time.time()
        params, _ = tr.init_state()
        shardings = {"params": tr._shardings()["params"]}
        _, mine = CheckpointManager(tmp).restore({"params": params}, step=steps,
                                                 shardings=shardings)
        _, theirs = CheckpointManager(ag["dir"]).restore({"params": params}, step=steps)
        for (name, a), (_, b) in zip(leaves(mine), leaves(theirs)):
            if not torch.equal(a, b):
                raise AssertionError(f"run (am): restored leaf {name} differs from (ag)'s "
                                     f"step-{steps} checkpoint")
        print(f"(am) losses and gradient norms bit for bit with (ag)'s steps 0-{steps - 1}; "
              f"its step-{steps} checkpoint's parameters, restored through "
              f"restore(shardings=), bit for bit with (ag)'s ({len(list(leaves(mine)))} "
              f"leaves, {time.time() - t0:.1f} s); (am) {time.time() - t_am:.1f} s in all",
              flush=True)
        del tr, params, mine, theirs
        torch.cuda.empty_cache()
        t_c = time.time()

        # (am') EF21-compressed gradients at one rank, AdamW on them
        api = get_model(cfg)
        opt_cfg = AdamWConfig(**TRAIN_OPT)
        params = init_lm_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
        state = init_opt_state(params, opt_cfg)
        grad_fn = make_compressed_grad_fn(api.loss, mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        common.reset_launches()
        errors, losses, times, worst = None, [], [], None
        for s in range(COMPRESSED_STEPS):
            batch = to_device(make_batch(cfg, shape, 0, s), dev)
            t0 = time.time()
            loss, grads, errors = grad_fn(params, batch, errors)
            if s == 0:          # against the exact gradients (errors start at zero)
                exact = tree_map(lambda t: t.detach().requires_grad_(True), params)
                ex_loss = api.loss(exact, batch)
                ex = torch.autograd.grad(ex_loss, [t for _, t in leaves(exact)],
                                         allow_unused=True, materialize_grads=True)
                worst = max(float((g.float() - e.float()).abs().max()
                                  / e.float().abs().max().clamp_min(1e-30))
                            for (_, g), e in zip(leaves(grads), ex))
                del exact, ex_loss, ex
            params, state, m = adamw_update(params, grads, state, opt_cfg)
            losses.append(float(loss))
            times.append((time.time() - t0) * 1e3)
        launches_c = dict(common.LAUNCHES)
        peak_c = torch.cuda.max_memory_allocated() / 1e9
        ref_l = ag["losses"][:COMPRESSED_STEPS]
        print(f"(am') make_compressed_grad_fn at one nccl rank + AdamW, {COMPRESSED_STEPS} "
              f"steps: losses {[round(x, 6) for x in losses]} ((ag): "
              f"{[round(x, 6) for x in ref_l]}; relative "
              f"{[f'{a / b - 1:+.3g}' for a, b in zip(losses, ref_l)]}); the compressed "
              f"gradients' largest error at step 0 {worst:.4g} of each leaf's largest "
              f"magnitude (bound 0.5/127 = {0.5 / 127:.4g}); median step "
              f"{np.median(times[1:]):.1f} ms; peak memory {peak_c:.3f} GB; launches "
              f"{launches_c}; {time.time() - t_c:.1f} s in all", flush=True)
        if not all(np.isfinite(losses)) or not all(
                a < 1.5 * b + 1e-3 for a, b in zip(losses, ref_l)):
            raise AssertionError(f"run (am'): losses {losses} against (ag)'s {ref_l}")
        if not worst <= 0.5 / 127 * (1 + 1e-5):
            raise AssertionError(f"run (am'): compressed gradients {worst} of their leaves' "
                                 "largest magnitude off the exact ones")
        del params, state, grads, errors
        torch.cuda.empty_cache()
        return {"train sharded": launches, "train compressed": launches_c}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# The example entry points on the card (runs (ah)-(al)): qwen3-0.6b served at
# long contexts through examples/torch_serve_longcontext.py, the quickstart,
# the ablation sweep and the small trainer
# ---------------------------------------------------------------------------

LONG_SLOTS, LONG_NEW_TOKENS = 8, 16
# run (ah): eight prompts between 28,000 and 32,700 tokens (max_seq 32768)
LONG_PROMPTS = (28000, 32700, 30150, 29300, 31850, 28650, 32200, 30700)
# run (ai): one prompt of 131,000 tokens (max_seq 131072: k at its cap,
# salca_max_k 4,096, and k_cap 5,120)
LONGEST_PROMPT, LONGEST_K = 131000, (4096, 5120)
TRAIN_SMALL_STEPS = 40


def long_max_seq(prompts) -> int:
    """The serving twin's max_seq: the longest prompt and its new tokens,
    rounded up to 128."""
    return ((max(prompts) + LONG_NEW_TOKENS + 127) // 128) * 128


def load_example(name: str):
    """``examples/<name>.py`` of this checkout as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_long_kernels(dev, cfg) -> list:
    """Phase 3 at the long-context runs' shapes: B1 and B2 over random pools
    of (ah)'s 8 slots × 32768 (k 1,638, k_cap 2,048) and (ai)'s one slot ×
    131072 (k 4,096, k_cap 5,120; a row may list 4,096 blocks), and B3 at
    their longest prompts (32,700 and 131,000 rows, checked on three row
    blocks), each against its plain version, timed by `graph_ms` beside its
    bound and its library call. Records tagged ``[qwen3-0.6b 32k]`` /
    ``[qwen3-0.6b 131k]``, counted on runs (ah) / (ai)."""
    from repro_torch.models.blocks import salca_params_for
    recs = []
    for tag, prompts, slots, run, iters in (("32k", LONG_PROMPTS, LONG_SLOTS, "long 32k", 20),
                                            ("131k", (LONGEST_PROMPT,), 1, "long 131k", 8)):
        mseq = long_max_seq(prompts)
        sp = salca_params_for(cfg, mseq)
        got = check_kernels(dev, cfg, [n + LONG_NEW_TOKENS for n in prompts], max(prompts),
                            iters=iters, tag=f"[qwen3-0.6b {tag}]", sharded=False,
                            slots=slots, run=run, max_seq=mseq)
        for r in got:
            r.update(max_seq=mseq, k=sp.k, k_cap=sp.k_cap)
        recs += got
    return recs


class LongProbe:
    """Installed on a long-context run: times every tick and prefill, keeps
    every logits row, and on the first (eager) tick reads layer 0's call of
    the paged attention: its `SalcaParams` (k, k_cap) and, with ``snapshot``,
    a copy of its query and pool (the state every kernel is then held to).
    With ``b3``, it keeps layer 0's B3 operands and output of the first
    prefill. Peak memory is read at the end of the prefills. Tick
    PROFILE_TICK (a replay on a graphed run) runs under the profiler: its
    device ms, kernel launches and the kernels that take the most time."""

    def __init__(self, snapshot=False, b3=False):
        self.snapshot, self.b3 = snapshot, b3
        self.tick_ms, self.prefill_ms, self.rows, self.params = [], [], {}, None
        self.state = self.b3_ops = None
        self.prefill_peak_gb = None
        self.profiled = {}

    def install(self, engine):
        import copy

        import torch
        from repro_torch.models import attention as mattn
        from repro_torch.models import blocks
        orig_decode, orig_prefill = engine._decode, engine._prefill
        real_attn, real_b3 = blocks.salca_decode_attention_paged, mattn.flash_attention_chunked
        self._restore = lambda: (setattr(blocks, "salca_decode_attention_paged", real_attn),
                                 setattr(mattn, "flash_attention_chunked", real_b3))

        def attn(q, pool, params, **kw):
            if self.params is None and not torch.cuda.is_current_stream_capturing():
                self.params = params
                if self.snapshot:
                    self.state = (q.clone(), copy.deepcopy(pool))
            return real_attn(q, pool, params, **kw)

        def b3(q, k, v, **kw):
            out = real_b3(q, k, v, **kw)
            if self.b3 and self.b3_ops is None:
                self.b3_ops = (q.clone(), k.clone(), v.clone(), out.clone(), kw)
            return out

        def decode(*a):
            who = [(slot, req.rid, len(req.output)) for slot, req in engine._active.items()]
            t0 = time.perf_counter()
            if len(self.tick_ms) == PROFILE_TICK:
                nxt, logits, finite = self._profile(orig_decode, a)
            else:
                nxt, logits, finite = orig_decode(*a)
            host = logits.to("cpu", non_blocking=True)
            torch.cuda.synchronize()
            self.tick_ms.append(1e3 * (time.perf_counter() - t0))
            for slot, rid, j in who:
                self.rows[(rid, j)] = host[slot]
            return nxt, logits, finite

        def prefill(req):
            t0 = time.perf_counter()
            out = orig_prefill(req)
            self.prefill_ms.append(1e3 * (time.perf_counter() - t0))
            self.prefill_peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
            return out

        blocks.salca_decode_attention_paged, mattn.flash_attention_chunked = attn, b3
        engine._decode, engine._prefill = decode, prefill

    def _profile(self, decode, args):
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_IDLE_S)
            out = decode(*args)
            torch.cuda.synchronize()
            time.sleep(PROFILE_IDLE_S)
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                ms, n = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
        self.profiled = dict(tick=PROFILE_TICK,
                             launches=sum(n for _, n in by_name.values()) or None,
                             device_ms=sum(ms for ms, _ in by_name.values()) or None,
                             top=[(name[:80], round(ms, 4), n) for name, (ms, n) in top])
        return out

    def remove(self):
        self._restore()


def serve_long(dev, params, prompts, slots, eager_run=False, probe=None) -> dict:
    """Runs (ah) / (ai): ``examples/torch_serve_longcontext.py --full --paged``
    (full-width qwen3-0.6b, int8 pool, block 32) with ``prompts`` on
    ``slots`` slots × LONG_NEW_TOKENS, through its `serve`, every launch
    counter set to 0 just before; built under `steps.eager()` with
    ``eager_run``. Returns the launches, the summary, the tokens and the
    probe's readings."""
    import contextlib
    import gc

    import torch
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.runtime.steps import eager
    gc.collect()
    torch.cuda.empty_cache()
    tsl = load_example("torch_serve_longcontext")
    args = tsl.parse_args().parse_args([
        "--full", "--paged", "--slots", str(slots), "--new-tokens", str(LONG_NEW_TOKENS),
        "--prompt-lens", ",".join(map(str, prompts)), "--device", dev])
    cfg = tsl.model_config(args)
    probe = probe or LongProbe()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with eager() if eager_run else contextlib.nullcontext():
        try:
            out = tsl.serve(args, cfg, params, hook=probe.install)
        finally:
            probe.remove()
    launches = dict(LAUNCHES)
    engine, reqs, summary = out["engine"], out["requests"], out["summary"]
    assert summary["completed"] == len(prompts), summary
    assert all(r.stop_reason == "length" and len(r.output) == LONG_NEW_TOKENS for r in reqs)
    want = {"paged_score_estimate": cfg.num_layers * summary["ticks"],
            "sparse_flash_decode_paged": cfg.num_layers * summary["ticks"],
            "flash_prefill": cfg.num_layers * summary["admissions"]}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != expected {want}")
    bad = [k for k, r in probe.rows.items() if not bool(torch.isfinite(r).all())]
    if bad:
        raise AssertionError(f"non-finite logits at {sorted(bad)[:5]}")
    step = engine._step
    if step.graphed == eager_run or (step.graphed and step._graph is None):
        raise AssertionError(f"tick graphed={step.graphed} with eager_run={eager_run}")
    ms = probe.tick_ms
    summary.update(
        max_seq=engine.max_seq, wall_s=out["wall_s"], tick_ms=ms, graphed=step.graphed,
        replay_ms_median=float(np.median(ms[2:])) if step.graphed else None,
        eager_ms_median=float(np.median(ms)), prefill_ms=probe.prefill_ms,
        ttft_s=[r.ttft_s for r in reqs], prompts=[len(r.prompt) for r in reqs],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
        prefill_peak_mem_gb=probe.prefill_peak_gb,
        launches_per_tick={k: v / summary["ticks"] for k, v in launches.items()
                           if k != "flash_prefill"},
        launches_per_replay=(sum(step.launches_per_tick.values())
                             if step.launches_per_tick else None),
        k=probe.params.k, k_cap=probe.params.k_cap, profiled_tick=probe.profiled)
    del engine, out
    return dict(launches=launches, summary=summary, tokens=[list(r.output) for r in reqs],
                rows=probe.rows, probe=probe)


def print_long(label: str, s: dict) -> None:
    ticks = (f"replay median {s['replay_ms_median']:.2f} ms (first {s['tick_ms'][0]:.2f}, "
             f"capture {s['tick_ms'][1]:.2f})" if s["graphed"]
             else f"eager median {s['eager_ms_median']:.2f} ms")
    print(f"serve longcontext {label}: max_seq {s['max_seq']}, k {s['k']}, k_cap {s['k_cap']}; "
          f"ms/tick {ticks}; wrapper launches per replay {s['launches_per_replay']}; "
          f"kernel launches per tick {json.dumps(s['launches_per_tick'])}; prefill ms "
          f"{[round(x, 1) for x in s['prefill_ms']]}; TTFT s "
          f"{[round(x, 3) for x in s['ttft_s']]}; peak mem GB during prefill "
          f"{s['prefill_peak_mem_gb']:.3f}, in all {s['peak_mem_gb']:.3f}; "
          f"{s['ticks']} ticks, wall {s['wall_s']:.1f} s", flush=True)
    p = s["profiled_tick"]
    if p:
        print(f"serve longcontext {label}: profiled tick {p['tick']}: device ms "
              f"{p['device_ms']}, kernel launches {p['launches']}, top kernels "
              f"{json.dumps(p['top'])}", flush=True)
    print(f"serve stats longcontext {label}: {json.dumps(s)}", flush=True)


def check_long_state(dev, probe, cfg, iters=20) -> dict:
    """Run (ai)'s first tick, layer 0, on its own state (`LongProbe`
    snapshot): B1 bit for bit with its plain version; the selection from
    B1's scores bit for bit with the torch chain on the CPU over the same
    scores; B2 on that selection within its bound; each timed by
    `graph_ms` beside `performance_model`'s bytes per token at this N over
    HBM3's rate (salca: B1 the feature stream, B2 the gathered K/V; dense:
    bf16 K/V), and a dense decode by SDPA over the same N bf16 keys of the
    KV heads (GQA). Then
    B3 on layer 0's prefill operands, three PLAIN_ROWS blocks against the
    plain version (the one-ulp bound)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import performance_model as pm
    from repro_torch.core.selection import (
        _quantized_query_groups, query_heavy_features, select_sparse_pattern_blocked)
    from repro_torch.flags import PERF
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.score_est import ops as se
    q, pool = probe.state
    params = probe.params
    s, h, hd = q.shape
    kv, bs = pool.num_kv_heads, pool.block_size
    n = int(pool.length.max())
    q_feat = query_heavy_features(q, pool.heavy_idx, h // kv)
    qc, qs, qsum = _quantized_query_groups(q_feat, kv)
    b1_args = (qc, qs, qsum, pool.feat_words, pool.feat_scale, pool.feat_zero,
               pool.clamped_pages())
    scores = se.paged_score_estimate(*b1_args, bf16=PERF.bf16_collectives)
    plain = se.paged_score_estimate_plain(*b1_args, bf16=PERF.bf16_collectives)
    if not torch.equal(scores, plain):
        raise AssertionError(f"(ai) B1: kernel differs from plain on "
                             f"{int((scores != plain).sum())} of {scores.numel()} scores")
    valid = pool.mapped_valid_mask()[:, None, :]
    sel = select_sparse_pattern_blocked(scores, params, valid, bs)
    sel_cpu = select_sparse_pattern_blocked(scores.cpu(), params, valid.cpu(), bs)
    for f, a, b in zip(sel._fields, sel, sel_cpu):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"(ai) selection: field {f} differs from the torch chain's on "
                                 "the CPU")
    pblk, counts, bmask = fd._selected_block_plan(pool, sel)
    qr = q.reshape(s * kv, h // kv, hd).float().contiguous()
    b2_args = (qr, pool.k_codes, pool.k_scale, pool.v_codes, pool.v_scale, pblk, counts,
               bmask, kv)
    out2 = fd.sparse_flash_decode_paged_kernel(*b2_args)
    plain2 = fd.sparse_flash_decode_paged_plain(qr, pool.k_codes, pool.k_scale, pool.v_codes,
                                                pool.v_scale, pblk, bmask, kv)
    ratio2 = float(((out2 - plain2).abs() / (B2_ATOL + B2_RTOL * plain2.abs())).max())
    if not ratio2 <= 1.0:
        raise AssertionError(f"(ai) B2: |kernel - plain| reaches {ratio2:.3g}x its bound")
    b1_ms = graph_ms(lambda: se.paged_score_estimate(*b1_args), iters)
    b2_ms = graph_ms(lambda: fd.sparse_flash_decode_paged_kernel(*b2_args), iters)
    kd = torch.randn((1, kv, n, hd), device=dev, dtype=torch.bfloat16)
    dense_ms = events_ms(lambda: F.scaled_dot_product_attention(
        q.reshape(1, h, 1, hd).to(torch.bfloat16), kd, kd, enable_gqa=True), iters)
    del kd
    kept = int(sel.count.sum())
    salca = pm.salca_bytes_per_token(n, hd, kv, params.feature_sparsity, kept / (kv * n),
                                     "int8", bs)
    dense = pm.dense_bytes_per_token(n, hd, kv)
    out = dict(n=n, k=params.k, k_cap=params.k_cap, kept=kept, listed_blocks=int(counts.sum()),
               b2_err_over_tol=ratio2, b1_ms=b1_ms, b2_ms=b2_ms,
               model_b1_ms=1e3 * salca.feature_stream / HBM_BYTES_PER_S,
               model_b2_ms=1e3 * salca.kv_gather / HBM_BYTES_PER_S,
               model_dense_ms=1e3 * dense.total / HBM_BYTES_PER_S, dense_sdpa_ms=dense_ms,
               model_salca_over_dense=salca.total / dense.total,
               measured_salca_over_dense=(b1_ms + b2_ms) / dense_ms)
    out.update(b1_share_of_bound=out["model_b1_ms"] / b1_ms,
               b2_share_of_bound=out["model_b2_ms"] / b2_ms)
    qb, kb, vb, ob, kw = probe.b3_ops
    assert kw.get("q_offset", 0) == 0 and qb.shape[1] == n - 1, (kw, qb.shape)
    out["b3_max_abs_err"], out["b3_err_over_tol"] = b3_causal_blocks(qb, kb, vb, ob)
    if not out["b3_err_over_tol"] <= 1.0:
        raise AssertionError(f"(ai) B3 layer 0: {out['b3_err_over_tol']:.3g}x its bound")
    return out


def check_long_context(dev, runs: dict) -> None:
    """Runs (ah) and (ai): qwen3-0.6b at 32k and 128k contexts through the
    serving twin (module docstring)."""
    import torch
    from repro_torch.models.blocks import salca_params_for
    cfg, params = main_path_model(dev)
    a = serve_long(dev, params, LONG_PROMPTS, LONG_SLOTS)
    print_long("(ah) 8 x 32k, graphed", a["summary"])
    ae = serve_long(dev, params, LONG_PROMPTS, LONG_SLOTS, eager_run=True)
    print_long("(ah') 8 x 32k, eager (built under steps.eager())", ae["summary"])
    if a["tokens"] != ae["tokens"]:
        raise AssertionError(f"(ah) graphed tokens differ from the eager twin's at "
                             f"{first_divergence(a['tokens'], ae['tokens'])}")
    same = sum(torch.equal(r, ae["rows"][key]) for key, r in a["rows"].items())
    print(f"(ah) graphed vs eager: greedy tokens identical; {same} of {len(a['rows'])} logits "
          f"rows bit for bit", flush=True)
    sp = salca_params_for(cfg, long_max_seq(LONG_PROMPTS))
    if (a["summary"]["k"], a["summary"]["k_cap"]) != (sp.k, sp.k_cap):
        raise AssertionError(f"(ah) k, k_cap {a['summary']['k']}, {a['summary']['k_cap']}")
    runs["long 32k"], runs["long 32k eager"] = a["launches"], ae["launches"]
    del a, ae
    probe = LongProbe(snapshot=True, b3=True)
    b = serve_long(dev, params, (LONGEST_PROMPT,), 1, probe=probe)
    print_long("(ai) 1 x 131k, graphed", b["summary"])
    sp = salca_params_for(cfg, long_max_seq((LONGEST_PROMPT,)))
    if (b["summary"]["k"], b["summary"]["k_cap"]) != (sp.k, sp.k_cap) or \
            (sp.k, sp.k_cap) != LONGEST_K:
        raise AssertionError(f"(ai) k, k_cap {b['summary']['k']}, {b['summary']['k_cap']}")
    runs["long 131k"] = b["launches"]
    st = check_long_state(dev, probe, cfg)
    print(f"(ai) first tick, layer 0, at N {st['n']}: k {st['k']}, k_cap {st['k_cap']}, "
          f"{st['kept']} kept over {st['listed_blocks']} listed blocks; B1 bit for bit; the "
          f"selection bit for bit with the torch chain on the CPU; B2 {st['b2_err_over_tol']:.3g}"
          f" of its bound; B3 (layer 0's prefill, rows first / middle / last "
          f"{PLAIN_ROWS}) {st['b3_err_over_tol']:.3g} of its bound", flush=True)
    print(f"(ai) per layer: B1 {st['b1_ms']:.4f} ms against the model's feature stream "
          f"{st['model_b1_ms']:.4f} ms at {HBM_BYTES_PER_S:g} B/s ({st['b1_share_of_bound']:.3f}"
          f" of the bound); B2 {st['b2_ms']:.4f} ms against the gathered K/V's "
          f"{st['model_b2_ms']:.4f} ms ({st['b2_share_of_bound']:.3f}); dense: the model "
          f"{st['model_dense_ms']:.4f} ms, SDPA over {st['n']} bf16 keys {st['dense_sdpa_ms']:.4f}"
          f" ms; Salca over dense: the model's bytes {st['model_salca_over_dense']:.4f}, "
          f"measured (B1 + B2) / SDPA {st['measured_salca_over_dense']:.4f}", flush=True)
    print(f"long state (ai): {json.dumps(st)}", flush=True)
    del b, probe
    torch.cuda.empty_cache()


def run_plain_flat(fn):
    """``fn()`` with the contiguous tick's kernels (B7, B9, B8) replaced by
    their plain versions, on the same device (the callers import the
    wrappers from their modules at call time)."""
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.score_est import ops as se
    from repro_torch.kernels.selection_fused import ops as sf
    saved = [(m, n, getattr(m, n)) for m, n in ((se, "flat_score_estimate"),
                                                (sf, "fused_bin_pool_threshold"),
                                                (fd, "sparse_flash_decode"))]
    try:
        for m, n, _ in saved:
            setattr(m, n, getattr(m, n + "_plain"))
        return fn()
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def check_examples(dev, runs: dict) -> None:
    """Runs (aj)-(al): the quickstart, the ablation sweep and the small
    trainer, each an example entry point on the card, launch counters set
    to 0 just before each."""
    import tempfile

    from repro_torch.kernels.common import LAUNCHES, reset_launches
    qs = load_example("torch_quickstart")
    reset_launches()
    got = qs.run(dev)
    runs["quickstart"] = dict(LAUNCHES)
    want = run_plain_flat(lambda: qs.run(dev))
    if not (np.array_equal(got["threshold"], want["threshold"])
            and np.array_equal(got["kept"], want["kept"])):
        raise AssertionError(f"(aj) thresholds {got['threshold']} / kept {got['kept']} differ "
                             f"from the plain versions' {want['threshold']} / {want['kept']}")
    if runs["quickstart"] != {"score_estimate": 1, "fused_bin_pool_threshold": 1,
                              "sparse_flash_decode": 1}:
        raise AssertionError(f"(aj) launches {runs['quickstart']}")
    qs.report(got)
    print(f"(aj) quickstart: thresholds and kept counts equal to the plain versions'; "
          f"recall {got['recall']} (plain {want['recall']}), rel. error {got['rel']:.6f} "
          f"(plain {want['rel']:.6f}); launches {json.dumps(runs['quickstart'])}", flush=True)

    abl = load_example("torch_ablation_selection")
    reset_launches()
    rows = abl.sweep(dev)
    runs["ablation"] = dict(LAUNCHES)
    plain = run_plain_flat(lambda: abl.sweep(dev))
    for r, p in zip(rows, plain):
        if (r["overlap"], r["coverage"]) != (p["overlap"], p["coverage"]):
            raise AssertionError(f"(ak) row ({r['s_f']}, {r['r_q']}): overlap / coverage "
                                 f"{r['overlap']} / {r['coverage']} != plain {p['overlap']} / "
                                 f"{p['coverage']}")
        print(f"(ak) s_f {r['s_f']} r_q {r['r_q']}: overlap {r['overlap']:.3f} coverage "
              f"{r['coverage']:.3f} rel_err {r['rel_err']:.5f} (plain {p['rel_err']:.5f})",
              flush=True)
    if runs["ablation"] != {k: len(abl.GRID) for k in runs["quickstart"]}:
        raise AssertionError(f"(ak) launches {runs['ablation']}")
    print(f"(ak) ablation: {len(rows)} rows, overlap and coverage equal to the plain "
          f"versions'; launches {json.dumps(runs['ablation'])}", flush=True)

    tts = load_example("torch_train_small")
    with tempfile.TemporaryDirectory() as ckpt:
        reset_launches()
        t0 = time.perf_counter()
        out = tts.run(tts.parse_args(["--steps", str(TRAIN_SMALL_STEPS), "--device", dev,
                                      "--ckpt-dir", ckpt]))
        wall = time.perf_counter() - t0
        runs["train small"] = dict(LAUNCHES)
    losses = out["losses"]
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    if not (np.all(np.isfinite(losses)) and last < first and out["final_step"] ==
            TRAIN_SMALL_STEPS):
        raise AssertionError(f"(al) losses {losses}")
    if not (runs["train small"].get("flash_prefill", 0) > 0
            and runs["train small"].get("flash_prefill_bwd", 0) > 0):
        raise AssertionError(f"(al) launches {runs['train small']}")
    print(f"(al) train_small: {TRAIN_SMALL_STEPS} steps in {wall:.1f} s, loss {first:.3f} → "
          f"{last:.3f} (mean of the first and last 10); launches B3 "
          f"{runs['train small']['flash_prefill']}, B3-bwd "
          f"{runs['train small']['flash_prefill_bwd']}", flush=True)


def print_serve(label: str, summary: dict, name: str = "qwen3-0.6b") -> None:
    ticks = summary["tick_ms"]
    graph = (f"first tick (eager) {ticks[0]:.2f} ms, capture tick {ticks[1]:.2f} ms, "
             f"replays median {summary['replay_ms_median']:.2f} ms, "
             f"wrapper launches per replay {summary['launches_per_replay']}"
             if summary["graphed"] else f"eager, ticks median {np.median(ticks):.2f} ms")
    if summary.get("profiled_tick"):
        p = summary["profiled_tick"]
        graph += (f"; profiled tick {p['tick']}: device ms {p['device_ms']}, "
                  f"kernel launches {p['launches']}")
    print(f"serve {name} {label}: ms/tick={summary['decode_ms_per_tick']:.2f} "
          f"decode tok/s={summary['decode_steps'] / max(summary['decode_s'], 1e-9):.1f} "
          f"mean TTFT s={summary['mean_ttft_s']:.3f} prefill_s={summary['prefill_s']:.3f} "
          f"peak mem GB={summary['peak_mem_gb']:.2f} "
          f"launches/tick={json.dumps(summary['launches_per_tick'])}; {graph}", flush=True)
    print(f"serve stats {label}: {json.dumps(summary)}", flush=True)


def main() -> int:
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import init_decode_ctx
    from repro_torch.kernels import common
    from repro_torch.models.blocks import ring_size, salca_params_for

    dev = "cuda"
    t_start = time.time()
    print(gpu_line(), flush=True)                                          # phase 1
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    secs = common.build_kernels()                                          # phase 2
    print(f"build: {secs:.1f} s", flush=True)
    for name, log in common.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")

    cfg = get_config("qwen3-0.6b")                                         # phase 3
    lengths = [n + NEW_TOKENS for n in PROMPTS]
    recs = check_kernels(dev, cfg, lengths=lengths, prompt_len=max(PROMPTS))
    recs += check_flat_kernels(dev, cfg, lengths=lengths)
    recs += check_tiered_kernels(dev, cfg, lengths=lengths)
    recs += check_bin_kernels(dev)
    recs += check_sp_flat_kernels(dev, cfg, lengths=lengths)
    # gemma3-12b's shapes: B1 at W = 8, B2 at HD 256 and G 2 on the selection
    # its tick makes (k and k_cap from layer 0's ring of 1024:
    # `models.transformer.decode_salca_params`), B3 at HD 256, causal and
    # under the window; then B3's other HD-256 cases and B2's fp16 and int4
    # branches at these shapes, checked and printed (no gemma3 run serves
    # those pools)
    gcfg = get_config(GEMMA)
    gsalca = salca_params_for(gcfg, max(ring_size(gcfg, gcfg.block_kinds()[0],
                                                  SERVE["max_seq"]), 128))
    recs += check_kernels(dev, gcfg, lengths=lengths, prompt_len=max(PROMPTS),
                          tag=f"[{GEMMA}]", salca=gsalca, sharded=False, run="gemma3")
    # … and its contiguous twin's B7, B9 and B8 (run (t)) on the same
    # `SalcaParams`; qwen3-8b's and phi3-medium-14b's B1, B2 and B3 at their
    # runs' (u) slots and lengths
    recs += check_flat_kernels(dev, gcfg, lengths=lengths, tag=f"[{GEMMA}]", salca=gsalca,
                               run="gemma3 contiguous")
    recs += check_sp_flat_kernels(dev, gcfg, lengths=lengths, tag=f"[{GEMMA}]", salca=gsalca,
                                  pooling=False)
    dense_lengths = [n + DENSE_NEW_TOKENS for n in DENSE_PROMPTS]
    for arch in DENSE_ARCHS:
        recs += check_kernels(dev, get_config(arch), lengths=dense_lengths,
                              prompt_len=max(DENSE_PROMPTS), tag=f"[{arch}]", sharded=False,
                              slots=DENSE_SLOTS, run=arch)
    # granite-moe-3b-a800m's shapes (24 H / 8 KV: G 3; HD 64; r 32, two
    # words), runs (z) and its twins: B1, B2 and B3 at HD 64, and B4-B6 at one
    # rank; its contiguous twin's B7, B9 and B8; B8's partials branch at G 3
    mcfg = get_config(GRANITE)
    recs += check_kernels(dev, mcfg, lengths=lengths, prompt_len=max(PROMPTS),
                          tag=f"[{GRANITE}]", run="granite", sharded_run="granite sharded")
    recs += check_flat_kernels(dev, mcfg, lengths=lengths, tag=f"[{GRANITE}]",
                               run="granite contiguous")
    recs += check_sp_flat_kernels(dev, mcfg, lengths=lengths, tag=f"[{GRANITE}]",
                                  pooling=False)
    # recurrentgemma-2b's prefill: B3 at G 10 (10 H / 1 KV), HD 256, under its
    # window of 2048 in the 8 "L" layers (runs (ab)); mamba2-2.7b runs no kernel
    recs.append(b3_record(dev, torch.Generator(device=dev).manual_seed(12), get_config(RGEMMA),
                          max(PROMPTS), tag=f"[{RGEMMA}]", home={"run": "recurrentgemma"}))
    # whisper-small's work, counted on run (ac): B3 without a causal mask at
    # its encoder's shapes (12 H / 12 KV, HD 64, over ENC_FRAMES frames) and
    # its cross-attention prefill's (the longest decoder prompt over the
    # frames); its tick's B7, B9 and B8 over the ENC_FRAMES-row cross stream
    # (G 1, r 32, k and k_cap from T_enc)
    wcfg = get_config(WHISPER)
    wgen = torch.Generator(device=dev).manual_seed(14)
    for tq, part in ((ENC_FRAMES, "encoder"), (max(ENC_PROMPTS), "cross")):
        recs.append(b3_bidirectional_record(dev, wgen, wcfg, tq, ENC_FRAMES,
                                            f"[{WHISPER} {part}]", "whisper"))
    wsalca = salca_params_for(wcfg, ENC_FRAMES)
    recs += check_flat_kernels(dev, wcfg, lengths=[ENC_FRAMES] * SERVE["slots"],
                               tag=f"[{WHISPER}]", salca=wsalca, run="whisper", n=ENC_FRAMES)
    # … and the ctx branch's at one rank (run (ac*)): B10 over the
    # halo-padded bins, B11 and B8's partials over the rank's capacity of
    # 4·k_cap
    recs += check_sp_flat_kernels(dev, wcfg, lengths=[ENC_FRAMES] * SERVE["slots"],
                                  tag=f"[{WHISPER}]", salca=wsalca, run="whisper sharded",
                                  n=ENC_FRAMES)
    # llava's image run (ad): the contiguous tick's B7, B9 and B8 at G 4 (32
    # H / 8 KV), HD 128, over VLM_MAX_SEQ rows in VLM_REQUESTS slots, each
    # holding its patch rows and text
    lcfg = get_config(LLAVA)
    recs += check_flat_kernels(dev, lcfg, lengths=[lcfg.num_image_tokens + VLM_TEXT]
                               * VLM_REQUESTS, tag=f"[{LLAVA}]", run="llava", n=VLM_MAX_SEQ,
                               slots=VLM_REQUESTS)
    # the long-context runs' shapes: B1 and B2 at 8 x 32768 and 1 x 131072,
    # B3 at 32,700 and 131,000 rows (runs (ah), (ai))
    recs += check_long_kernels(dev, cfg)
    # B3-bwd at the training shapes (run (ae)), counted on the training run (ag)
    recs.append(check_b3_bwd(dev))
    # B3 and B3-bwd at a context-parallel rank's query offset (runs (an),
    # (ao), (aq)); granite's full-width MoE layer as 4 ep ranks run it (run (ao'))
    cp_recs, cp_launches = check_cp_shards(dev)
    recs += cp_recs
    check_ep_layer(dev)
    # mamba2's SSD layer and recurrentgemma's "R" block as 4 model ranks run
    # them in training (run (ap)); recurrentgemma's cp shards are (aq), above
    check_tp_recurrent(dev)
    # the main path's records by `graph_ms` too, now that no profiler
    # session of phase 3 follows
    for r in recs:
        if "_graph" in r:
            r["graph_ms"] = graph_ms(*r.pop("_graph"))
    for r in recs:
        print(f"kernel {r['name']}: max_abs_err={r['max_abs_err']:.3g} "
              f"(tolerance {r['tolerance']}; {r['err_over_tol']:.3g} of it) "
              f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              + (f"graph_ms={r['graph_ms']:.4f} " if "graph_ms" in r else "")
              + f"library_ms={r['library_ms']} bound_ms={r['bound_ms']:.5f} "
              f"({r['bound_by']})", flush=True)
        if "window" in r:
            print(f"kernel {r['name']} under window {r['window']}: max_abs_err="
                  f"{r['window_max_abs_err']:.3g} ({r['window_err_over_tol']:.3g} of the "
                  f"tolerance) ms={r['window_ms']:.4f} library_ms={r['window_library_ms']:.4f} "
                  f"(SDPA, boolean mask) bound_ms={r['window_bound_ms']:.5f} "
                  f"({r['window_bound_by']})", flush=True)
    for line in check_b3_offsets(dev, gcfg):
        print(line, flush=True)
    for r in check_tiered_kernels(dev, gcfg, lengths, salca=gsalca, timed=False):
        print(f"kernel {r['name']} at {GEMMA}'s shapes: max_abs_err={r['max_abs_err']:.3g} "
              f"({r['err_over_tol']:.3g} of {r['tolerance']}), {r['selected_blocks']} "
              f"blocks listed", flush=True)
    for r in check_tiered_kernels(dev, mcfg, lengths, timed=False):
        print(f"kernel {r['name']} at {GRANITE}'s shapes (G 3, HD 64): max_abs_err="
              f"{r['max_abs_err']:.3g} ({r['err_over_tol']:.3g} of {r['tolerance']}), "
              f"{r['selected_blocks']} blocks listed", flush=True)
    for line in check_group_rows_and_baseline(dev, cfg, mcfg, lengths):
        print(line, flush=True)
    for paged, kw in ((True, {}), (False, {}), (True, {"kv_pool_dtype": "fp16"}),
                      (True, SMALL_SPILL), (True, {"arch": GEMMA}), (False, {"arch": GEMMA}),
                      (True, {"arch": MAMBA}), (True, {"arch": RGEMMA}), (True, {"arch": LLAVA})):
        small = check_small_path(dev, paged, **kw)
        print(f"small path (card vs plain on CPU): {json.dumps(small)}", flush=True)
    print(f"small path (card vs plain on CPU): {json.dumps(check_small_encdec(dev))}",
          flush=True)

    hists = []                                                              # phase 4
    launches, summary, tokens, trace = serve_main_path(dev, hists=hists)
    print_serve("paged", summary)
    launches_e, summary_e, tokens_e, trace_e = serve_main_path(dev, eager_run=True)
    print_serve("paged, eager (built under steps.eager())", summary_e)
    rows = check_bitwise("graphed vs eager", tokens, trace, tokens_e, trace_e)
    print(f"graphed vs eager (paged int8): greedy tokens identical, {rows} logits rows bit "
          f"for bit; ms per tick eager {np.median(summary_e['tick_ms']):.2f}, graphed "
          f"replay {summary['replay_ms_median']:.2f} (median); wrapper launches per replay "
          f"{summary['launches_per_replay']}; peak memory GB eager "
          f"{summary_e['peak_mem_gb']:.3f}, graphed {summary['peak_mem_gb']:.3f}", flush=True)
    ctx = init_decode_ctx(dev)
    launches_sh, summary_sh, tokens_sh, trace_sh = serve_main_path(dev, ctx)
    print_serve("paged sharded (one rank, nccl)", summary_sh)
    where = first_divergence(tokens, tokens_sh)
    if where is not None:
        i, j = where
        raise AssertionError(f"sharded run diverges from the unsharded run at request {i}, "
                             f"generated token {j}: {tokens[i][j:j + 1]} vs "
                             f"{tokens_sh[i][j:j + 1]}")
    print("sharded vs unsharded greedy tokens: identical", flush=True)
    launches_c, summary_c, picks_c, trace_c = serve_main_path(
        dev, paged=False, force=dict(enumerate(tokens)))
    print_serve("contiguous (teacher-forced on the paged run's tokens)", summary_c)
    worst = check_contiguous_logits(tokens, trace, picks_c, trace_c)
    print(f"contiguous vs paged: every logits row within {max(worst.values()):.3g} bf16 ulps "
          f"(limit {CONTIG_LOGIT_ULPS})", flush=True)
    # the tiered pool: fp16 and int4 pools, each unsharded and block-sharded
    # (tokens must agree), then int4 with the host tier on a small pool
    runs = {"int8": launches, "int8 eager": launches_e, "int8 sharded": launches_sh,
            "contiguous": launches_c, **cp_launches}
    clean = {}
    for mode in ("fp16", "int4"):
        runs[mode], summary_m, tokens_m, clean[mode] = serve_main_path(dev, kv_pool_dtype=mode)
        clean[mode] = (tokens_m, clean[mode])
        print_serve(f"paged {mode}", summary_m)
        runs[f"{mode} sharded"], summary_ms, tokens_ms, _ = serve_main_path(
            dev, ctx, kv_pool_dtype=mode)
        print_serve(f"paged {mode} sharded (one rank, nccl)", summary_ms)
        if first_divergence(tokens_m, tokens_ms) is not None:
            raise AssertionError(f"{mode}: the sharded run's tokens differ from the paged "
                                 f"run's at (request, token) {first_divergence(tokens_m, tokens_ms)}")
        print(f"{mode}: sharded vs unsharded greedy tokens: identical", flush=True)
    runs["int4 spill"], summary_sp, _, _ = serve_main_path(dev, probe=SpillProbe(), **SPILL_RUN)
    print_serve(f"paged int4 + host spill {json.dumps(SPILL_RUN)}", summary_sp)
    check_prefix_sharing(dev, ctx, runs)
    b = check_scheduler(dev, ctx, runs)
    check_lifecycle(dev, ctx, runs, tokens, clean["fp16"], b)
    check_prefix_cache(dev, ctx, runs)
    gemma_r = check_dense_configs(dev, runs)
    check_flat_and_rings(dev, ctx, runs, tokens, trace_c, gemma_r)
    check_unfused(dev, ctx, runs, (tokens, trace, summary, hists),
                  (tokens_sh, trace_sh, summary_sh))
    check_moe(dev, ctx, runs)
    check_recurrent(dev, runs)
    check_encdec_and_vlm(dev, ctx, runs)
    check_train_gradients(dev)
    runs.update(check_training(dev))
    check_long_context(dev, runs)
    check_examples(dev, runs)
    # each kernel's launches on the run of its path (a record at another
    # model's shapes: its `run`, under its wrapper's counter)
    home = {"maxpool_int8": "sp contiguous", "hist_threshold": "sp contiguous",
            "sparse_flash_decode_partials": "sp contiguous",
            "sparse_flash_decode_paged[fp16]": "fp16",
            "sparse_flash_decode_paged_partials[fp16]": "fp16 sharded",
            "sparse_flash_decode_paged[int4]": "int4 spill",
            "sparse_flash_decode_paged_partials[int4]": "int4 sharded",
            "paged_score_bounds": "int8 sharded", "paged_fused_select": "int8 sharded",
            "sparse_flash_decode_paged_partials": "int8 sharded",
            "score_estimate": "contiguous", "fused_bin_pool_threshold": "contiguous",
            "sparse_flash_decode": "contiguous"}
    for r in recs:
        counter = r.get("counter", r["name"])
        if r["name"] in ("maxpool_int8", "hist_threshold"):
            r["drive_launches"] = r["launches"]       # phase 3's drive of the entry point
        path = r.get("run") or home.get(r["name"], "int8")
        r["launches"] = runs[path].get(counter, 0)
        r["launches_per_call"] = sum(run.get(counter, 0) for run in runs.values())
        if r["launches"] < 1:
            raise AssertionError(f"{r['name']} was not launched on its main path")
    print(f"chip_smoke: {time.time() - t_start:.1f} s in all", flush=True)
    print(json.dumps({"kernels": recs}), flush=True)
    dist.destroy_process_group()
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
