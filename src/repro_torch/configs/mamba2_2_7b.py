"""mamba2-2.7b [ssm]: 64L d2560 (attention-free) vocab=50280, ssm_state=128 —
SSD (state-space duality). [arXiv:2405.21060; unverified]

The port's copy of the reference `configs/mamba2_2_7b.py`. Salca does not
apply: the model has no attention and an O(1) decode state. d_inner=5120,
80 SSD heads of dim 64."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm", source="arXiv:2405.21060; unverified",
    num_layers=64, d_model=2560, num_heads=1, num_kv_heads=1, head_dim=64,
    d_ff=0, vocab_size=50280, layer_pattern="S",
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256, conv_width=4,
    attn_strategy="tp", salca=False,
)
