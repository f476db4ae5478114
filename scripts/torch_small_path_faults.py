#!/usr/bin/env python3
"""Holds chip_smoke.py's small-path logits gate for gemma3-12b.reduced()
against faults in its sliding-window rings.

    PYTHONPATH=src python3 scripts/torch_small_path_faults.py

Serves chip_smoke.py's small path (`small_path_model` / `small_path_run`:
reduced gemma3-12b at f32, rings of 64 slots that every prompt wraps,
max_seq 256, two slots, three prompts × 5 new tokens) on the CPU through
the paged and the contiguous engine, once as it is and once with each
fault below patched in memory into every ring layer:

- ``ring_late``: each decode token is written one ring slot late
  (slot (pos + 1) % W), so the window holds token pos - W in place of
  pos + 1 - W;
- ``ring_drop``: the ring's decode writes are lost, so the window holds
  token pos - W in place of pos.

Prints one JSON line per run: whether its greedy tokens equal the clean
run's, the largest logits gap to the clean run on the first tick and over
all ticks (`chip_smoke.logit_gaps`, the quantity chip_smoke's gate reads),
beside SMALL_PATH_CODE_STEP_TOL. Fails unless every faulted run's largest
gap exceeds that limit. CPU only; the source files are not changed.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch

    import chip_smoke as cs
    from repro_torch.models import blocks

    cfg, params, prompts = cs.small_path_model(cs.GEMMA)
    w = cfg.local_window
    append = blocks.append_token

    def ring_late(cache, k, v):
        if cache.max_seq == w:          # a ring; an inactive slot's cursor stays at w
            late = torch.remainder(cache.length + 1, w)
            cache.length.copy_(torch.where(cache.length < w, late, cache.length))
        return append(cache, k, v)

    def ring_drop(cache, k, v):
        if cache.max_seq != w:
            return append(cache, k, v)

    faults = {"ring_late": ring_late, "ring_drop": ring_drop}
    ok = True
    for paged in (True, False):
        tok, lg, _, _ = cs.small_path_run("cpu", cfg, params, prompts, paged)
        for name, fault in faults.items():
            blocks.append_token = fault
            try:
                tok_f, lg_f, _, _ = cs.small_path_run("cpu", cfg, params, prompts, paged)
            finally:
                blocks.append_token = append
            gaps = cs.logit_gaps(lg, lg_f)
            caught = max(gaps) > cs.SMALL_PATH_CODE_STEP_TOL
            ok &= caught
            print(json.dumps({"arch": cs.GEMMA, "paged": paged, "fault": name,
                              "tokens_equal": tok_f == tok, "first_tick_gap": gaps[0],
                              "max_logit_gap": max(gaps),
                              "limit": cs.SMALL_PATH_CODE_STEP_TOL, "caught": caught}),
                  flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
