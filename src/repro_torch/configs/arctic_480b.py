"""arctic-480b [moe]: 35L d7168 56H (GQA kv=8) vocab=32000, MoE 128e top-2 +
dense residual (d_ff 4864 per expert). [hf:Snowflake/snowflake-arctic-base; hf]

The port's copy of the reference `configs/arctic_480b.py`: the dense
residual FFN runs in parallel with the MoE branch (`models.blocks.ffn_apply`)."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe", source="hf:Snowflake/snowflake-arctic-base; hf",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8, head_dim=128,
    d_ff=4864, vocab_size=32000, act="silu",
    moe=True, num_experts=128, experts_per_token=2, moe_d_ff=4864,
    dense_residual=True, capacity_factor=1.25,
    attn_strategy="cp", salca=True,
)
