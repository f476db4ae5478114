#!/usr/bin/env python3
"""Kernels B2 and B6 against another checkout's, bit for bit, on
chip_smoke.py's operands.

    python3 scripts/torch_b2_ab.py --tree DIR

Runs chip_smoke.py's phase-3 checks of B2 and B6 (the int8 branch, then the
fp16 and int4 branches) and records the operands of the first launch of each
of the six branch rows (B2 and B6 in each storage mode). Then, on those
operands:

- this checkout's kernels, timed from the profiler's trace, with their CTA
  count;
- the kernels of the checkout at ``DIR`` (for example a ``git archive`` of
  the parent commit under ``build/``), in a child process that builds that
  tree's sources into the tree's own ``build/kernels/``, timed the same way;

and prints, per row, whether the outputs are ``torch.equal`` to the other
tree's, and both times; the last line is one JSON object with all
of it. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNEL = "sparse_flash_decode_paged_kernel"     # the CUDA symbol of B2 and B6 in both trees
ITERS = 20


def run_rows(fd, cs, rows) -> dict:
    """Each recorded row through the wrapper of module ``fd``: outputs and
    device ms per launch (chip_smoke ``cs``'s profiler timing)."""
    out = {}
    for name, (base, args, kw) in rows.items():
        fn = getattr(fd, base + "_kernel")
        res = fn(*args, **kw)
        out[name] = dict(out=res if isinstance(res, tuple) else (res,),
                         ms=cs.kernel_ms(lambda: fn(*args, **kw), KERNEL, ITERS))
    return out


def child(tree: Path, ops_file: Path, out_file: Path) -> int:
    """Run the tree's B2/B6 on the saved operands; save outputs and times."""
    sys.path[:0] = [str(tree), str(tree / "src")]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_decode import ops as fd
    assert Path(fd.__file__).resolve().is_relative_to(tree), fd.__file__
    common.build_kernels(["flash_decode"])
    rows = torch.load(ops_file, map_location="cuda")
    res = run_rows(fd, cs, rows)
    torch.save({k: dict(out=[t.cpu() for t in v["out"]], ms=v["ms"]) for k, v in res.items()},
               out_file)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, required=True,
                    help="root of the checkout whose B2/B6 this one is held to")
    ap.add_argument("--child", nargs=2, type=Path, metavar=("OPERANDS", "OUT"),
                    help=argparse.SUPPRESS)
    a = ap.parse_args()
    tree = a.tree.resolve()
    if a.child:
        return child(tree, *a.child)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_decode import ops as fd

    common.build_kernels()
    print(cs.gpu_line(), flush=True)
    rows = {}

    def recorder(fn, base):
        def run(*args, **kw):
            mode = args[9] if len(args) > 9 else kw.get("kv_dtype", "int8")
            rows.setdefault(fd._counter(base, mode), (base, args, kw))
            return fn(*args, **kw)
        return run

    orig = fd.sparse_flash_decode_paged_kernel, fd.sparse_flash_decode_paged_partials_kernel
    fd.sparse_flash_decode_paged_kernel = recorder(orig[0], "sparse_flash_decode_paged")
    fd.sparse_flash_decode_paged_partials_kernel = recorder(
        orig[1], "sparse_flash_decode_paged_partials")
    try:
        cfg = get_config("qwen3-0.6b")
        lengths = [n + cs.NEW_TOKENS for n in cs.PROMPTS]
        cs.check_kernels("cuda", cfg, lengths=lengths, prompt_len=max(cs.PROMPTS))
        cs.check_tiered_kernels("cuda", cfg, lengths=lengths)
    finally:
        fd.sparse_flash_decode_paged_kernel, fd.sparse_flash_decode_paged_partials_kernel = orig
    assert len(rows) == 6, sorted(rows)

    work = ROOT / "build" / "b2_ab"
    work.mkdir(parents=True, exist_ok=True)
    ops_file, out_file = work / "operands.pt", work / "tree_out.pt"
    torch.save(rows, ops_file)
    subprocess.run([sys.executable, __file__, "--tree", str(tree), "--child", str(ops_file),
                    str(out_file)], check=True, timeout=900)
    other = torch.load(out_file)

    report = []
    mine = run_rows(fd, cs, rows)
    for name, (base, args, kw) in rows.items():
        rec = dict(name=name, equal=all(torch.equal(x.cpu(), y) for x, y in
                                        zip(mine[name]["out"], other[name]["out"])),
                   ms=mine[name]["ms"], tree_ms=other[name]["ms"],
                   ctas=cs.kernel_ctas(lambda: getattr(fd, base + "_kernel")(*args, **kw),
                                       KERNEL))
        print(f"{name}: torch.equal to the tree's: {rec['equal']}; ms {rec['ms']:.5f} "
              f"({rec['ctas']} CTAs), tree {rec['tree_ms']:.5f}", flush=True)
        report.append(rec)
    print(json.dumps({"gpu": cs.gpu_line(), "tree": str(tree), "rows": report}), flush=True)
    return 0 if all(r["equal"] for r in report) else 1


if __name__ == "__main__":
    sys.exit(main())
