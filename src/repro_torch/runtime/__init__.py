"""Runtime of the port: serving, and training (trainer, AdamW, checkpoints,
data), on one device or over a mesh's data axes."""

from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.data import PrefetchIterator, make_batch
from repro_torch.runtime.monitor import NaNGuard, StepMonitor
from repro_torch.runtime.optimizer import AdamWConfig, AdamWState, adamw_update, init_opt_state
from repro_torch.runtime.serve import Request, ServeStats, ServingEngine
from repro_torch.runtime.steps import MeshPlan, PooledServer, make_train_step
from repro_torch.runtime.trainer import Trainer, TrainerConfig

__all__ = ["AdamWConfig", "AdamWState", "CheckpointManager", "MeshPlan", "NaNGuard",
           "PooledServer", "PrefetchIterator", "Request", "ServeStats", "ServingEngine",
           "StepMonitor", "Trainer", "TrainerConfig", "adamw_update", "init_opt_state",
           "make_batch", "make_train_step"]
