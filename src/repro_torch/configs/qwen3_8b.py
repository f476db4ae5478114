"""qwen3-8b [dense]: 36L d4096 32H (GQA kv=8) ff12288 vocab=151936 — qk_norm, GQA.
[hf:Qwen/Qwen3-8B; hf]

The port's copy of the reference `configs/qwen3_8b.py`."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense", source="hf:Qwen/Qwen3-8B; hf",
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=12288, vocab_size=151936, qk_norm=True, act="silu",
    rope_theta=1_000_000.0, attn_strategy="tp", salca=True,
)
