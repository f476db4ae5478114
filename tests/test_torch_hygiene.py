"""Port hygiene: the PyTorch package and chip_smoke.py stand alone (no JAX,
nothing of the reference package), and the entry points run on the card
unless the caller names the CPU."""

import ast
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "scripts").glob("torch_*.py")))


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_or_reference(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {name}"


def test_entry_points_default_to_cuda():
    """Without a card, the default device raises instead of running on the
    CPU; only an explicit device='cpu' runs there."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from repro_torch.configs import get_config
    from repro_torch.runtime.serve import ServingEngine
    from repro_torch.weights import init_lm_params
    cfg = get_config("qwen3-0.6b").reduced()
    params = init_lm_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, params, max_seq=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_lm_params(cfg, torch.Generator().manual_seed(0))
    eng = ServingEngine(cfg, params, max_seq=64, block_size=16, device="cpu")
    assert eng.device.type == "cpu"
    assert np.all(eng._mask == 0)


def test_kernel_build_staleness_follows_headers(tmp_path, monkeypatch):
    """A kernel library is rebuilt when its source or a csrc header the
    source includes is newer than it; every header the real sources
    include exists."""
    import os

    from repro_torch.kernels import common
    for name in common.SOURCES:
        assert all(p.exists() for p in common._inputs(name)), name
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    (csrc / "helper.cuh").write_text("#pragma once\n")
    (csrc / "k.cu").write_text('#include <cuda_runtime.h>\n#include "helper.cuh"\n')
    monkeypatch.setattr(common, "CSRC", csrc)
    monkeypatch.setattr(common, "BUILD_DIR", build)
    monkeypatch.setattr(common, "SOURCES", {"k": "k.cu"})
    assert common._stale("k")                                   # no library yet
    lib = build / "libk.so"
    lib.write_bytes(b"")
    os.utime(csrc / "k.cu", (100, 100))
    os.utime(csrc / "helper.cuh", (100, 100))
    os.utime(lib, (200, 200))
    assert not common._stale("k")
    os.utime(csrc / "helper.cuh", (300, 300))                  # the header changed
    assert common._stale("k")
    os.utime(csrc / "helper.cuh", (100, 100))
    os.utime(csrc / "k.cu", (300, 300))                         # the source changed
    assert common._stale("k")
