"""gemma3-12b [dense]: 48L d3840 16H (GQA kv=8) ff15360 vocab=262144 — 5:1
local:global, 128k context. [hf:google/gemma-3-1b-pt; unverified]

Pattern "LLLLLA": five sliding-window (1024) layers per global layer. Salca
accelerates the global layers; a local layer keeps a window-slot ring per
request slot (`models.blocks.ring_size`). The port's copy of the reference
`configs/gemma3_12b.py`."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense", source="hf:google/gemma-3-1b-pt; unverified",
    num_layers=48, d_model=3840, num_heads=16, num_kv_heads=8, head_dim=256,
    d_ff=15360, vocab_size=262144, qk_norm=True, act="gelu", tie_embeddings=True,
    layer_pattern="LLLLLA", local_window=1024, rope_theta=1_000_000.0,
    attn_strategy="tp", salca=True,
)
