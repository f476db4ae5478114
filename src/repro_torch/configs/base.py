"""Model configuration: the port's own copy of the reference `ModelConfig`.

Field names, defaults and `reduced()` match the JAX package's
`configs/base.py`, so one architecture id means the same shapes on both
sides. The dense and MoE LMs (global and sliding-window layers) read most
of these fields; the rest are kept so a config compares equal field for
field. `ShapeConfig` is the reference's input-shape cell (sequence length
and global batch), which the trainer's data stream reads.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Literal

Family = Literal["dense", "audio", "ssm", "hybrid", "vlm", "moe"]


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: Family
    source: str = ""

    # trunk
    num_layers: int = 12
    d_model: int = 1024
    num_heads: int = 16
    num_kv_heads: int = 8
    head_dim: int = 0                # 0 → d_model // num_heads
    d_ff: int = 4096
    vocab_size: int = 32000
    act: str = "silu"                # silu (SwiGLU) | gelu (GeGLU)
    qk_norm: bool = False
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # attention pattern: "A" global, "L" local, "R" RG-LRU, "S" SSD
    layer_pattern: str = "A"
    local_window: int = 0

    # MoE
    moe: bool = False
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    dense_residual: bool = False
    capacity_factor: float = 1.25
    moe_strategy: str = "ep"

    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4

    # RG-LRU
    rnn_width: int = 0

    # encoder-decoder
    encdec: bool = False
    encoder_layers: int = 0
    decoder_max_len: int = 448

    # modality frontend
    frontend: Literal["none", "audio", "vision"] = "none"
    frontend_dim: int = 0
    num_image_tokens: int = 0

    # distribution
    attn_strategy: str = "tp"
    expert_pad_to: int = 0

    # Salca
    salca: bool = True
    salca_feature_sparsity: float = 0.5
    salca_retention: float = 0.05
    salca_max_k: int = 4096
    salca_pool_window: int = 7
    salca_use_pool: bool = True
    salca_static_channels: bool = False
    kv_pool_dtype: str = "int8"      # paged pool K/V precision

    # compute dtype of activations and weights
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, 256)

    @property
    def padded_experts(self) -> int:
        return self.expert_pad_to or self.num_experts

    @property
    def groups(self) -> int:
        return self.num_heads // self.num_kv_heads

    def block_kinds(self) -> list[str]:
        """Expanded per-layer block kinds, pattern tiled to num_layers."""
        p = self.layer_pattern
        return [p[i % len(p)] for i in range(self.num_layers)]

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + trunk), for 6ND (the
        reference's formula)."""
        d, hd = self.d_model, self.resolved_head_dim
        h, kv = self.num_heads, self.num_kv_heads
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        glu = 3 * d * self.d_ff
        moe = 0
        if self.moe:
            moe = self.num_experts * 3 * d * self.moe_d_ff + d * self.num_experts
            glu = glu if self.dense_residual else 0
        ssd = 0
        if "S" in self.layer_pattern:
            di = self.ssm_expand * d
            nh = di // self.ssm_head_dim
            ssd = (d * (2 * di + 2 * self.ssm_state + nh) + di * d
                   + self.conv_width * (di + 2 * self.ssm_state))
        rglru = 0
        if "R" in self.layer_pattern:
            w = self.rnn_width or d
            rglru = 2 * d * w + w * d + 3 * w + self.conv_width * w
        kinds = self.block_kinds()
        total = 0
        for kind in kinds:
            if kind in ("A", "L"):
                total += attn + (glu + moe)
            elif kind == "S":
                total += ssd
            elif kind == "R":
                total += rglru + (glu + moe)
        total += self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        if self.encdec:
            total += self.encoder_layers * (2 * attn + glu)  # self+cross & ffn
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.moe:
            return self.param_count()
        inactive = (self.num_experts - self.experts_per_token) * 3 * self.d_model * self.moe_d_ff
        n_moe_layers = sum(1 for k in self.block_kinds() if k in ("A", "L", "R"))
        return self.param_count() - inactive * n_moe_layers

    def reduced(self) -> "ModelConfig":
        """CPU test variant: same family and features, tiny dims."""
        kw = dict(
            num_layers=min(self.num_layers, 2 * max(1, len(self.layer_pattern))),
            d_model=128,
            num_heads=max(2, min(4, self.num_heads)),
            num_kv_heads=1 if self.num_kv_heads == 1 else 2,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            local_window=min(self.local_window, 64) if self.local_window else 0,
            salca_retention=0.25,
        )
        if self.moe:
            kw.update(num_experts=8, experts_per_token=min(self.experts_per_token, 2),
                      moe_d_ff=64, expert_pad_to=8)
        if "S" in self.layer_pattern:
            kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=32)
        if "R" in self.layer_pattern:
            kw.update(rnn_width=128)
        if self.encdec:
            kw.update(encoder_layers=2, decoder_max_len=64)
        if self.frontend != "none":
            kw.update(frontend_dim=64, num_image_tokens=8)
        return replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (the reference's `ShapeConfig`)."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]

    def reduced(self) -> "ShapeConfig":
        return replace(self, seq_len=min(self.seq_len, 256),
                       global_batch=min(self.global_batch, 4))
