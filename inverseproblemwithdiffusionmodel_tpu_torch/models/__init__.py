"""Score networks: NCSN++, DDPM, NCSN v1, the NCSNv2 family (2-D, and 1-D
for the temporal prior) and ScoreNet, with their layers."""
from .classifier import ResNet18, ResNetClf
from .ddpm import DDPM
from .ema import EmaState
from .ncsn import NCSN, NCSNdeeper
from .ncsn1d import NCSN1D, NCSN1DDeeper, NCSN1DDeepest, UNET1D
from .ncsn3d import NCSN3D, NCSN3DShallow
from .ncsnpp import NCSNpp
from .ncsnv2 import NCSNv2, NCSNv2Deeper, NCSNv2Deepest
from .registry import (TASK_NAME_TO_MODEL_CTOR, build_clf, build_seg_unet,
                       create_model, get_model, get_model_fn, get_network,
                       load_model, make_apply_fn, make_score_fn,
                       make_tube_score_fn_3d, module_takes_train,
                       register_model)
from .simple import ScoreNet
from .unet import UNet
