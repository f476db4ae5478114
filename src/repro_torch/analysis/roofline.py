"""Roofline terms of a step on the NVIDIA H100, and the useful FLOPs of
every config and shape.

Port of the reference `analysis/roofline.py`. Three terms per step, in
seconds, per card:

    compute    = FLOPs_per_card / PEAK_FLOPS
    memory     = HBM_bytes_per_card / HBM_BW
    collective = wire_bytes_per_card / NVLINK_BW

plus MODEL_FLOPS = 6·N·D (train) / 2·N_active·D (inference) and the
useful-compute ratio MODEL_FLOPS / FLOPs. `model_flops` is the
reference's formula, term for term; the peaks are the H100 SXM's in place
of the reference's TPU figures. The FLOPs and bytes a step really moves
come from the caller (a profiler trace, or a byte model such as
`core.performance_model`), not from a compiled artifact.

The peaks below are **datasheet figures of the H100 SXM at its 700 W
limit**, not measurements: dense bf16 tensor-core FLOP/s (989e12), dense
f32 CUDA-core FLOP/s (67e12), dense int8 tensor-core op/s (1979e12), HBM3
bytes/s (3.35e12) and NVLink 4 bytes/s per direction (450e9). A card held
below 700 W runs slower under load. Field names keep the reference's
``_per_chip``: a chip is one card here.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig, ShapeConfig

PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}   # dense, per second
PEAK_FLOPS = PEAK_OPS["bf16"]     # bf16 FLOP/s per card
HBM_BW = 3.35e12                  # bytes/s per card (HBM3)
NVLINK_BW = 450e9                 # bytes/s per direction per card


@dataclass
class RooflineTerms:
    flops_per_chip: float
    hbm_bytes_per_chip: float
    wire_bytes_per_chip: float
    model_flops_per_chip: float = 0.0

    @property
    def compute_s(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_chip / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.wire_bytes_per_chip / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        return (self.model_flops_per_chip / self.flops_per_chip
                if self.flops_per_chip else 0.0)

    @property
    def roofline_fraction(self) -> float:
        """How close the *dominant* term runs to its roof if everything
        overlapped perfectly: useful compute time / bound time."""
        ideal = self.model_flops_per_chip / PEAK_FLOPS
        return ideal / self.bound_s if self.bound_s else 0.0

    def as_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops_per_chip,
            "hbm_bytes_per_chip": self.hbm_bytes_per_chip,
            "wire_bytes_per_chip": self.wire_bytes_per_chip,
            "model_flops_per_chip": self.model_flops_per_chip,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Analytic useful FLOPs per step (global, all cards): the reference's
    formula, so the same work whatever implements it.

    train: 6·N_active·tokens + attention 12·L_attn·H·HD·T²·(B/2 causal …)
    prefill: one third of train (fwd only);
    decode: 2·N_active·B (+ attention reads are bandwidth, not FLOPs-bound;
    score-estimation and exact attention FLOPs included explicitly).
    """
    n_active = cfg.active_param_count()
    kinds = cfg.block_kinds()
    n_attn = sum(1 for k in kinds if k in ("A", "L"))
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        attn = 12 * n_attn * h * hd * shape.seq_len * tokens / 2
        return 6.0 * n_active * tokens + attn
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        attn = 4 * n_attn * h * hd * shape.seq_len * tokens / 2
        return 2.0 * n_active * tokens + attn
    # decode: one token per sequence
    b = shape.global_batch
    kv = cfg.num_kv_heads
    r = int(cfg.salca_feature_sparsity * hd)
    k_sel = min(int(shape.seq_len * cfg.salca_retention), cfg.salca_max_k)
    score = 2 * n_attn * b * kv * shape.seq_len * r if cfg.salca else 0
    exact_n = k_sel if cfg.salca else shape.seq_len
    attn = 4 * n_attn * b * h * hd * exact_n
    return 2.0 * n_active * b + score + attn


def make_terms(cfg: ModelConfig, shape: ShapeConfig, chips: int,
               flops_per_chip: float, hbm_bytes_per_chip: float,
               wire_bytes_per_chip: float) -> RooflineTerms:
    return RooflineTerms(
        flops_per_chip=flops_per_chip,
        hbm_bytes_per_chip=hbm_bytes_per_chip,
        wire_bytes_per_chip=wire_bytes_per_chip,
        model_flops_per_chip=model_flops(cfg, shape) / chips,
    )


def format_row(arch: str, shape: str, mesh: str, t: RooflineTerms) -> str:
    return (f"| {arch} | {shape} | {mesh} | {t.compute_s:.3e} | {t.memory_s:.3e} "
            f"| {t.collective_s:.3e} | {t.bottleneck} | {t.useful_ratio:.2f} "
            f"| {t.roofline_fraction:.3f} |")
