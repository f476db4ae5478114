"""Runtime of the port: serving, and training (trainer, AdamW, checkpoints,
data)."""

from repro_torch.runtime.checkpoint import CheckpointManager
from repro_torch.runtime.data import PrefetchIterator, make_batch
from repro_torch.runtime.monitor import NaNGuard, StepMonitor
from repro_torch.runtime.optimizer import AdamWConfig, AdamWState, adamw_update, init_opt_state
from repro_torch.runtime.serve import Request, ServeStats, ServingEngine
from repro_torch.runtime.steps import PooledServer, make_train_step
from repro_torch.runtime.trainer import Trainer, TrainerConfig

__all__ = ["AdamWConfig", "AdamWState", "CheckpointManager", "NaNGuard", "PooledServer",
           "PrefetchIterator", "Request", "ServeStats", "ServingEngine", "StepMonitor",
           "Trainer", "TrainerConfig", "adamw_update", "init_opt_state", "make_batch",
           "make_train_step"]
