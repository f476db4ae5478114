"""qwen3-0.6b [dense]: 28L d1024 16H (GQA kv=8) ff3072 vocab=151936, qk_norm."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense", source="hf:Qwen/Qwen3-8B; hf",
    num_layers=28, d_model=1024, num_heads=16, num_kv_heads=8, head_dim=128,
    d_ff=3072, vocab_size=151936, qk_norm=True, act="silu",
    rope_theta=1_000_000.0, tie_embeddings=True, attn_strategy="tp", salca=True,
)
