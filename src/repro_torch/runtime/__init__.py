"""Fault-tolerant training (PyTorch port of ``repro.runtime``)."""
from repro_torch.runtime.tm_task import TMTask, make_tm_task, step_generator
from repro_torch.runtime.trainer import SimulatedFailure, Trainer, TrainLoopConfig

__all__ = ["SimulatedFailure", "TMTask", "Trainer", "TrainLoopConfig",
           "make_tm_task", "step_generator"]
