"""The input-shape cells (the reference's `configs/shapes.py`): the same four
for every LM architecture."""

from __future__ import annotations

from repro_torch.configs.base import ShapeConfig

SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode"),
}


def get_shape(name: str) -> ShapeConfig:
    try:
        return SHAPES[name]
    except KeyError:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}") from None
