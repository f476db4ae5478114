"""Analysis of the port's work: roofline terms on the H100, useful FLOPs,
the collectives the sharded ticks issue, and the synthetic attention
workload of the reference's benchmarks."""

from repro_torch.analysis.collectives import TRACE, Collectives
from repro_torch.analysis.roofline import RooflineTerms, make_terms, model_flops

__all__ = ["TRACE", "Collectives", "RooflineTerms", "make_terms", "model_flops"]
