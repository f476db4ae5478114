"""Serving runtime of the port."""

from repro_torch.runtime.monitor import NaNGuard, StepMonitor
from repro_torch.runtime.serve import Request, ServeStats, ServingEngine

__all__ = ["NaNGuard", "Request", "ServeStats", "ServingEngine", "StepMonitor"]
