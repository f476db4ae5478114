"""Helpers shared by the port's parity tests (tests/test_torch_*.py): move
numpy data into the JAX reference and the PyTorch port, and compare their
outputs field by field."""

import dataclasses

import numpy as np
import torch

POOL_FIELDS = ("k_codes", "k_scale", "v_codes", "v_scale", "feat_words", "feat_scale",
               "feat_zero", "heavy_idx", "length", "page_table", "refcount", "sel_hist")
CACHE_FIELDS = ("k_codes", "k_scale", "v_codes", "v_scale", "feat_words", "feat_scale",
                "feat_zero", "heavy_idx", "length")


def tt(x) -> torch.Tensor:
    """numpy/JAX array → CPU tensor; uint32 words keep their bits as int32."""
    a = np.array(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def tn(x: torch.Tensor, like=None) -> np.ndarray:
    """CPU tensor → numpy; int32 words read back as uint32 when ``like`` is."""
    a = x.detach().cpu().numpy()
    if like is not None and np.asarray(like).dtype == np.uint32:
        a = a.view(np.uint32)
    return a


def assert_fields_equal(jx, tx, fields, layer=None):
    for f in fields:
        j = np.asarray(getattr(jx, f))
        if layer is not None:
            j = j[layer]
        np.testing.assert_array_equal(tn(getattr(tx, f), j), j, err_msg=f)


def f32_configs():
    """qwen3-0.6b.reduced() at float32 compute, for the reference and the port."""
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget
    return (dataclasses.replace(jget("qwen3-0.6b").reduced(), dtype="float32"),
            dataclasses.replace(tget("qwen3-0.6b").reduced(), dtype="float32"))

