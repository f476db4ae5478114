"""Serving runtime of the port."""

from repro_torch.runtime.monitor import NaNGuard, StepMonitor
from repro_torch.runtime.serve import Request, ServeStats, ServingEngine
from repro_torch.runtime.steps import PooledServer

__all__ = ["NaNGuard", "PooledServer", "Request", "ServeStats", "ServingEngine",
           "StepMonitor"]
