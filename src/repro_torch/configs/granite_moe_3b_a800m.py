"""granite-moe-3b-a800m [moe]: 32L d1536 24H (GQA kv=8) vocab=49155, MoE 40e
top-8 (d_ff 512 per expert). [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

The port's copy of the reference `configs/granite_moe_3b_a800m.py`: 40
experts pad to 48 (the router masks the phantom experts)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155, act="silu",
    moe=True, num_experts=40, experts_per_token=8, moe_d_ff=512,
    expert_pad_to=48, capacity_factor=1.25,
    attn_strategy="cp", salca=True,
)
