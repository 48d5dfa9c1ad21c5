"""Score-matching losses, and the guidance nets' losses."""
from .dsm import anneal_dsm_score_estimation, continuous_dsm_loss
from .guidance import (clf_loss_with_perturbation, dice_ce_loss,
                       seg_loss_with_perturbation)

__all__ = ["anneal_dsm_score_estimation", "clf_loss_with_perturbation",
           "continuous_dsm_loss", "dice_ce_loss",
           "seg_loss_with_perturbation"]
