#!/usr/bin/env python3
"""Holds chip_smoke.py's contiguous-vs-paged logits check against faults.

    python3 scripts/torch_contiguous_faults.py

Serves chip_smoke.py's main path once through the paged engine, then
through the contiguous engine fed the paged run's tokens (teacher
forcing), once as it is and once with each fault below patched in memory
into one slot of the contiguous tick:

- ``drop_append``: slot 2's decode appends are lost (the cursor advances);
- ``early_append``: slot 2's decode appends land one row early;
- ``shift_gather``: slot 1's row gather reads each selected token's
  neighbour.

Prints, per run, the largest logits difference of every request in bf16
ulps of the top logit, and whether ``check_contiguous_logits`` accepts
it. Fails unless the fault-free run passes and every fault fails. Needs a
CUDA device; the source files are not changed.
"""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import repro_torch.core.attention as att
    import repro_torch.models.blocks as blocks
    from repro_torch.core.cache import _DATA_FIELDS
    from repro_torch.kernels import common

    common.build_kernels()
    _, _, tokens, trace = cs.serve_main_path("cuda")
    append, gather = blocks.append_token, att.gather_selected

    def drop_append(cache, k, v, slot=2):
        at = int(cache.length[slot].clamp(0, cache.max_seq - 1))
        old = [getattr(cache, f)[slot, at].clone() for f in _DATA_FIELDS]
        append(cache, k, v)
        for f, o in zip(_DATA_FIELDS, old):
            getattr(cache, f)[slot, at] = o
        return cache

    def early_append(cache, k, v, slot=2):
        cache.length[slot] -= 1
        append(cache, k, v)
        cache.length[slot] += 1
        return cache

    def shift_gather(cache, sel, slot=1):
        idx = sel.indices.clone()
        idx[slot] = torch.clamp(idx[slot] + 1, max=cache.max_seq - 1)
        return gather(cache, sel._replace(indices=idx))

    faults = {"none": (append, gather), "drop_append": (drop_append, gather),
              "early_append": (early_append, gather), "shift_gather": (append, shift_gather)}
    wrong = []
    for name, patch in faults.items():
        blocks.append_token, att.gather_selected = patch
        _, _, picks, rows = cs.serve_main_path("cuda", paged=False,
                                               force=dict(enumerate(tokens)))
        worst = [max(float((rows[(i, j)].float() - trace[(i, j)].float()).abs().max())
                     / cs.bf16_ulp(trace[(i, j)]) for j in range(len(x)))
                 for i, x in enumerate(tokens)]
        try:
            cs.check_contiguous_logits(tokens, trace, picks, rows)
            caught = False
        except AssertionError as e:
            caught = True
            print(f"  {e}")
        print(f"fault {name}: largest difference per request {worst} bf16 ulps; "
              f"{'fails' if caught else 'passes'} the check "
              f"(limit {cs.CONTIG_LOGIT_ULPS})", flush=True)
        if caught != (name != "none"):
            wrong.append(name)
    blocks.append_token, att.gather_selected = append, gather
    if wrong:
        print(f"the check misjudged: {wrong}", file=sys.stderr)
        return 1
    print(f"gpu: {cs.gpu_line()}; the check passes the fault-free run and fails every fault")
    return 0


if __name__ == "__main__":
    sys.exit(main())
