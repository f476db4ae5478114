#!/usr/bin/env python3
"""Kernels B1, B2, B4, B5, B6, B7, B9, B10 and B11 against other checkouts',
bit for bit, on chip_smoke.py's operands.

    python3 scripts/torch_b2_ab.py --tree DIR [DIR ...] [--rows NAME ...]

Runs chip_smoke.py's phase-3 checks of the paged, block-sharded, contiguous,
tiered and bin kernels and records the operands of the first launch of each
of fourteen rows: B1, B4, B5, B7 in the contiguous tick's bf16 chain and in
the reference op's f32 chain, B2 and B6 in each storage mode (int8, fp16,
int4), B9, B10 and B11. Then, on those operands:

- this checkout's kernels, timed from the profiler's trace, with their CTA
  count;
- the kernels of each checkout ``DIR`` (for example a ``git archive`` of
  the parent commit under ``build/``), one after another, each in a child
  process that builds that tree's sources into the tree's own
  ``build/kernels/``, timed the same way;

and prints, per row and tree, whether the outputs are ``torch.equal`` to
that tree's, and the times; the last line is one JSON object with all of
it. ``--rows NAME ...`` compares only the named rows. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# recorded wrappers: (module, function) → a name that the CUDA symbol of
# the wrapper's kernel holds in every tree compared; B2/B6 are recorded per
# storage mode, B7 per chain
KERNELS = {
    ("flash_decode", "sparse_flash_decode_paged_kernel"): "sparse_flash_decode_paged_kernel",
    ("flash_decode", "sparse_flash_decode_paged_partials_kernel"):
        "sparse_flash_decode_paged_kernel",                       # B6 runs B2's kernel
    ("score_est", "paged_score_estimate"): "paged_score_estimate_kernel",
    ("score_est", "paged_score_bounds"): "paged_score_bounds_kernel",
    ("score_est", "flat_score_estimate"): "flat_score",
    ("selection_fused", "paged_fused_select"): "paged_fused_select_kernel",
    ("selection_fused", "fused_bin_pool_threshold"): "fused_bin_pool_threshold_kernel",
    ("hist_topk", "hist_threshold"): "hist_threshold_kernel",
    ("maxpool", "maxpool_int8"): "maxpool_u8_kernel",
}
ITERS = 20


def modules():
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.hist_topk import ops as ht
    from repro_torch.kernels.maxpool import ops as mp
    from repro_torch.kernels.score_est import ops as se
    from repro_torch.kernels.selection_fused import ops as sf
    return {"flash_decode": fd, "score_est": se, "selection_fused": sf, "hist_topk": ht,
            "maxpool": mp}


def run_rows(mods, cs, rows) -> dict:
    """Each recorded row through its wrapper in ``mods``: outputs and device
    ms per launch (chip_smoke ``cs``'s profiler timing)."""
    out = {}
    for name, (mod, fname, args, kw) in rows.items():
        fn = getattr(mods[mod], fname)
        res = fn(*args, **kw)
        out[name] = dict(out=res if isinstance(res, tuple) else (res,),
                         ms=cs.kernel_ms(lambda: fn(*args, **kw), KERNELS[mod, fname],
                                         ITERS))
    return out


def child(tree: Path, ops_file: Path, out_file: Path) -> int:
    """Run the tree's kernels on the saved operands; save outputs and times."""
    sys.path[:0] = [str(tree), str(tree / "src")]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import common
    mods = modules()
    for m in mods.values():
        assert Path(m.__file__).resolve().is_relative_to(tree), m.__file__
    common.build_kernels()
    rows = torch.load(ops_file, map_location="cuda")
    res = run_rows(mods, cs, rows)
    torch.save({k: dict(out=[t.cpu() for t in v["out"]], ms=v["ms"]) for k, v in res.items()},
               out_file)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, nargs="+", required=True,
                    help="roots of the checkouts whose kernels this one is held to")
    ap.add_argument("--rows", nargs="+", metavar="NAME",
                    help="compare only these rows (default: all fourteen)")
    ap.add_argument("--child", nargs=2, type=Path, metavar=("OPERANDS", "OUT"),
                    help=argparse.SUPPRESS)
    a = ap.parse_args()
    trees = [t.resolve() for t in a.tree]
    if a.child:
        return child(trees[0], *a.child)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import common

    common.build_kernels()
    print(cs.gpu_line(), flush=True)
    mods = modules()
    rows = {}

    def recorder(mod, fname, fn):
        def run(*args, **kw):
            name = fname
            if mod == "flash_decode":
                base = fname.removesuffix("_kernel")
                name = mods[mod]._counter(base, args[9] if len(args) > 9
                                          else kw.get("kv_dtype", "int8"))
            elif fname == "flat_score_estimate":
                name = f"{fname}[{'bf16' if kw.get('bf16', True) else 'f32'}]"
            rows.setdefault(name, (mod, fname, args, kw))
            return fn(*args, **kw)
        return run

    orig = {w: getattr(mods[w[0]], w[1]) for w in KERNELS}
    for (mod, fname), fn in orig.items():
        setattr(mods[mod], fname, recorder(mod, fname, fn))
    try:
        cfg = get_config("qwen3-0.6b")
        lengths = [n + cs.NEW_TOKENS for n in cs.PROMPTS]
        cs.check_kernels("cuda", cfg, lengths=lengths, prompt_len=max(cs.PROMPTS))
        cs.check_flat_kernels("cuda", cfg, lengths=lengths)
        cs.check_tiered_kernels("cuda", cfg, lengths=lengths)
        cs.check_bin_kernels("cuda")
    finally:
        for (mod, fname), fn in orig.items():
            setattr(mods[mod], fname, fn)
    assert len(rows) == 14, sorted(rows)
    if a.rows:
        unknown = set(a.rows) - set(rows)
        if unknown:
            ap.error(f"unknown rows {sorted(unknown)}; rows: {sorted(rows)}")
        rows = {name: row for name, row in rows.items() if name in a.rows}

    # this tree's kernels first: after the child has profiled, sessions of
    # this process lost every launch of B1 (PERF.md)
    mine = run_rows(mods, cs, rows)
    for name, (mod, fname, args, kw) in rows.items():
        fn = getattr(mods[mod], fname)
        mine[name]["ctas"] = cs.kernel_ctas(lambda: fn(*args, **kw), KERNELS[mod, fname])
    work = ROOT / "build" / "b2_ab"
    work.mkdir(parents=True, exist_ok=True)
    ops_file = work / "operands.pt"
    torch.save(rows, ops_file)
    others = []
    for i, tree in enumerate(trees):
        out_file = work / f"tree{i}_out.pt"
        subprocess.run([sys.executable, __file__, "--tree", str(tree), "--child",
                        str(ops_file), str(out_file)], check=True, timeout=900)
        others.append(torch.load(out_file))

    report = []
    for name in rows:
        rec = dict(name=name, ms=mine[name]["ms"], ctas=mine[name]["ctas"], trees=[
            dict(tree=str(tree), ms=other[name]["ms"],
                 equal=all(torch.equal(x.cpu(), y)
                           for x, y in zip(mine[name]["out"], other[name]["out"])))
            for tree, other in zip(trees, others)])
        print(f"{name}: ms {rec['ms']:.5f} ({rec['ctas']} CTAs); " + "; ".join(
            f"{t['tree']}: ms {t['ms']:.5f}, torch.equal {t['equal']}" for t in rec["trees"]),
            flush=True)
        report.append(rec)
    print(json.dumps({"gpu": cs.gpu_line(), "rows": report}), flush=True)
    return 0 if all(t["equal"] for r in report for t in r["trees"]) else 1


if __name__ == "__main__":
    sys.exit(main())
