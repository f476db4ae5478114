"""whisper-small [audio]: 12L d768 12H (kv=12, MHA) ff3072 vocab=51865 —
enc-dec, conv frontend (stub). [arXiv:2212.04356; unverified]

The port's copy of the reference `configs/whisper_small.py`. The audio
frontend is a STUB: the caller delivers precomputed frame embeddings
(post-conv). Decode shapes exercise the decoder with Salca on the
cross-attention stream (32k/500k encoder frames); the self-attention
stream is capped at ``decoder_max_len`` tokens."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio", source="arXiv:2212.04356; unverified",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=51865, act="gelu",
    encdec=True, encoder_layers=12, decoder_max_len=448,
    frontend="audio", frontend_dim=768,
    attn_strategy="cp", salca=True,
)
