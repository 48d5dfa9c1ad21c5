"""Score networks: NCSN++, DDPM, NCSN v1, the NCSNv2 family (2-D, and 1-D
for the temporal prior) and ScoreNet, with their layers."""
from .ncsn import NCSN, NCSNdeeper
from .ncsn1d import NCSN1D, NCSN1DDeeper, NCSN1DDeepest
from .ncsnpp import NCSNpp
from .ncsnv2 import NCSNv2, NCSNv2Deeper, NCSNv2Deepest
from .registry import (create_model, get_model, get_model_fn, get_network,
                       make_apply_fn, make_score_fn, module_takes_train,
                       register_model)
from .simple import ScoreNet
