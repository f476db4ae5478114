#!/usr/bin/env python3
"""Where the contiguous tick's results part from the paged tick's, layer by
layer, on chip_smoke.py's teacher-forced run.

    python3 scripts/torch_contiguous_divergence.py [--tree DIR]

Serves chip_smoke.py's main path through the paged engine, then through
the contiguous engine fed the paged run's tokens, recording the query and
the output of every decode attention call (one per layer and tick). Both
runs see the same tokens, so a layer's inputs differ only where an earlier
layer's or tick's rounding differed. Prints, per layer over the ticks:

- ``q``: the largest |q_contiguous - q_paged| relative to max |q_paged|
  (0 while the inputs are identical);
- ``flips``: the output elements whose bf16 rounding (what the model
  feeds its output projection) differs;

the same at layer 0, where the inputs are identical on every tick (the
tokens decide them), as the rounding B8 itself adds against B2; and the
largest logits difference per request in bf16 ulps of the top logit, the
quantity chip_smoke.py holds to ``CONTIG_LOGIT_ULPS``.

``--tree DIR`` runs the port of another checkout (for example a
``git archive`` of the parent commit), built in that checkout, so two
versions of a kernel are compared on one card. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[1],
                    help="root of the checkout whose port runs (default: this one)")
    root = ap.parse_args().tree.resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import repro_torch.models.blocks as blocks
    from repro_torch.kernels import common
    assert Path(blocks.__file__).resolve().is_relative_to(root), blocks.__file__

    common.build_kernels()
    calls = {"paged": [], "contiguous": []}

    def recorder(fn, key):
        def run(q, *a, **kw):
            out = fn(q, *a, **kw)
            o = out[0] if isinstance(out, tuple) else out
            calls[key].append((q.detach().clone(), o.detach().clone()))
            return out
        return run

    orig = blocks.salca_decode_attention_paged, blocks.salca_decode_attention
    blocks.salca_decode_attention_paged = recorder(orig[0], "paged")
    blocks.salca_decode_attention = recorder(orig[1], "contiguous")
    try:
        _, summ, tokens, trace = cs.serve_main_path("cuda")
        _, summ_c, _, trace_c = cs.serve_main_path("cuda", paged=False,
                                                   force=dict(enumerate(tokens)))
    finally:
        blocks.salca_decode_attention_paged, blocks.salca_decode_attention = orig

    from repro_torch.configs import get_config
    ticks, layers = summ["ticks"], get_config("qwen3-0.6b").num_layers
    assert summ_c["ticks"] == ticks
    # the main runs' calls are the last ones (a warm-up engine runs first)
    n = layers * ticks
    pag, con = calls["paged"][-n:], calls["contiguous"][-n:]
    q_rel = [[0.0] * ticks for _ in range(layers)]
    flips = [[0] * ticks for _ in range(layers)]
    for i, ((qp, op), (qc, oc)) in enumerate(zip(pag, con)):
        t, layer = divmod(i, layers)
        q_rel[layer][t] = float((qc - qp).abs().max() / qp.abs().max())
        flips[layer][t] = int((oc.bfloat16() != op.bfloat16()).sum())
    size = pag[0][1].numel()
    print(f"tree {root}: {ticks} ticks x {layers} layers, {size} output elements per call")
    for layer in range(layers):
        print(f"layer {layer:2d}: q {max(q_rel[layer]):.3g} (identical on "
              f"{sum(x == 0 for x in q_rel[layer])} of {ticks} ticks); "
              f"flips {sum(flips[layer])} (largest tick {max(flips[layer])})")
    ratio0 = max(float(((oc - op).abs() / (1e-5 + 1e-5 * op.abs())).max())
                 for (qp, op), (qc, oc) in zip(pag[::layers], con[::layers]))
    print(f"layer 0 (identical inputs on every tick): {sum(flips[0])} bf16 flips in "
          f"{ticks * size} outputs; outputs within {ratio0:.3g} of 1e-5 + 1e-5*|paged|")
    worst = [max(float((trace_c[(i, j)].float() - trace[(i, j)].float()).abs().max())
                 / cs.bf16_ulp(trace[(i, j)]) for j in range(len(x)))
             for i, x in enumerate(tokens)]
    print(f"logits: largest difference per request {worst} bf16 ulps "
          f"(chip_smoke's limit {cs.CONTIG_LOGIT_ULPS})")
    print(f"gpu: {cs.gpu_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
