"""Training of the port: AdamW, the train step, int8 gradient compression
and the fault-tolerant trainer (counterpart of ``repro.train``)."""
from . import compression
from .optimizer import AdamState, AdamW, cosine_schedule, global_norm
from .train_step import TrainState, init_state, make_optimizer, make_train_step
from .trainer import InjectedFailure, StragglerMonitor, Trainer

__all__ = ["AdamState", "AdamW", "InjectedFailure", "StragglerMonitor",
           "TrainState", "Trainer", "compression", "cosine_schedule",
           "global_norm", "init_state", "make_optimizer", "make_train_step"]
