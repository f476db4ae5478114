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



def int8_codes(rows: np.ndarray) -> np.ndarray:
    """The int8 K/V codes of pool rows (..., HD): an int8 pool stores them;
    an fp16 pool stores code × the row's scale, whose largest |code| is 127
    (f16 rounding moves a ratio by at most 127·2^-10, well under a half)."""
    if rows.dtype == np.int8:
        return rows.astype(np.int16)
    rows = np.nan_to_num(rows.astype(np.float32))     # a poisoned row: code 0
    amax = np.abs(rows).max(-1, keepdims=True)
    return np.round(rows * 127 / np.where(amax > 0, amax, 1)).astype(np.int16)


def record_ticks(eng) -> list:
    """Wrap a serving engine's decode call (the port's or the reference's):
    per tick the slots' mask, the logits rows, and the int8 K/V codes (every
    layer) of the blocks the active slots map."""
    ticks, orig = [], eng._decode

    def recording(*args):
        out = orig(*args)
        if torch.is_tensor(out[1]):
            caches = eng._state.caches
            codes = np.stack([torch.stack([getattr(c, f) for c in caches]).numpy()
                              for f in ("k_codes", "v_codes")])
            pt, lg = caches[0].page_table.numpy(), out[1].float().numpy()
        else:
            st = out[3].period_states[0]
            codes = np.stack([np.asarray(st.k_codes), np.asarray(st.v_codes)])
            pt, lg = np.asarray(st.page_table[0]), np.asarray(out[1])
        mask = np.asarray(args[-1]).copy()
        read = np.unique(pt[mask][pt[mask] >= 0])
        ticks.append((mask, np.array(lg, np.float32), int8_codes(codes[:, :, read])))
        return out

    eng._decode = recording
    return ticks
