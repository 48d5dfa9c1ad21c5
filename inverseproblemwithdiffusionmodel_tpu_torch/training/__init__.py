"""Score training (discrete and continuous) and the guidance nets'
training (classifier, segmentation): state, steps, checkpoints and loop."""
from .checkpoint import Checkpointer
from .loop import (FitConfig, MetricsLogger, batch_iterator, fit,
                   make_train_iterator)
from .state import MultiSteps, TrainState, get_optimizer
from .train import (make_clf_train_step, make_continuous_score_train_step,
                    make_score_eval_step, make_score_train_step,
                    make_seg_train_step)

__all__ = ["Checkpointer", "FitConfig", "MetricsLogger", "MultiSteps",
           "TrainState", "batch_iterator", "fit", "get_optimizer",
           "make_clf_train_step", "make_continuous_score_train_step",
           "make_score_eval_step", "make_score_train_step",
           "make_seg_train_step", "make_train_iterator"]
