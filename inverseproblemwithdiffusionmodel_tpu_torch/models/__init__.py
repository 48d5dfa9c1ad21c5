"""Score networks: NCSN++ and the NCSNv2 family (2-D, and 1-D for the
temporal prior), with their layers."""
from .ncsn1d import NCSN1D, NCSN1DDeeper, NCSN1DDeepest
from .ncsnpp import NCSNpp
from .ncsnv2 import NCSNv2, NCSNv2Deeper, NCSNv2Deepest
from .registry import create_model, get_model, get_network, make_score_fn
