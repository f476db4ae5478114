"""recurrentgemma-2b [hybrid]: 26L d2560 10H (MQA kv=1) ff7680 vocab=256000 —
RG-LRU + local attention, 1:2 attention:recurrent. [arXiv:2402.19427; hf]

The port's copy of the reference `configs/recurrentgemma_2b.py`. Pattern
"RRL": two RG-LRU blocks, then one local-attention block (window 2048);
26 layers are 8 periods and an "RR" tail. Salca is not needed: the
recurrent layers keep an O(1) state and the attention layers a
window-bounded ring."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid", source="arXiv:2402.19427; hf",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256000, act="gelu", tie_embeddings=True,
    layer_pattern="RRL", local_window=2048, rnn_width=2560, conv_width=4,
    attn_strategy="cp", salca=False,
)
