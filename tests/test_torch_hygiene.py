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
