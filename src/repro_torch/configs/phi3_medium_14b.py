"""phi3-medium-14b [dense]: 40L d5120 40H (GQA kv=10) ff17920 vocab=100352 —
RoPE SwiGLU GQA. [arXiv:2404.14219; unverified]

The port's copy of the reference `configs/phi3_medium_14b.py`."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b", family="dense", source="arXiv:2404.14219; unverified",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=10, head_dim=128,
    d_ff=17920, vocab_size=100352, act="silu", rope_theta=10_000.0,
    attn_strategy="cp", salca=True,
)
