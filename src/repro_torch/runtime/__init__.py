"""Serving runtime of the port."""

from repro_torch.runtime.serve import Request, ServeStats, ServingEngine

__all__ = ["Request", "ServeStats", "ServingEngine"]
