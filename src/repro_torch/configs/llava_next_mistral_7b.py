"""llava-next-mistral-7b [vlm]: 32L d4096 32H (GQA kv=8) ff14336 vocab=32000 —
anyres tiling. [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

The port's copy of the reference `configs/llava_next_mistral_7b.py`. The
vision tower is a STUB: the caller delivers precomputed anyres patch
embeddings (5 tiles x 576 patches, CLIP dim 1024), which a linear
projector maps into the LM stream ahead of the text tokens."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000, act="silu", rope_theta=1_000_000.0,
    frontend="vision", frontend_dim=1024, num_image_tokens=2880,
    attn_strategy="tp", salca=True,
)
