"""Continuous-time score training: state, step, checkpoints and loop."""
from .checkpoint import Checkpointer
from .loop import FitConfig, MetricsLogger, batch_iterator, fit
from .state import TrainState, get_optimizer
from .train import make_continuous_score_train_step

__all__ = ["Checkpointer", "FitConfig", "MetricsLogger", "TrainState",
           "batch_iterator", "fit", "get_optimizer",
           "make_continuous_score_train_step"]
