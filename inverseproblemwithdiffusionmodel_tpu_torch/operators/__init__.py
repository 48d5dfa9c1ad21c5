"""Forward operators and proximal solvers of the inverse problems: the
complex64 operators (as the JAX package exports them) and their
real-pair forms."""
from .base import LinearTransform
from .masks import generate_mask, random_cartesian_mask
from .masking import SkipLines
from .fourier import (UndersamplingFourier, RandomUndersamplingFourier, SENSE,
                      make_sense)
from .finite_diff import FiniteDiff
from .proximal import (Proximal, L2Penalty, Constrained, SingleCoil,
                       get_proximal)
from .pair import (PairL2Penalty, PairRandomUndersamplingFourier, PairSENSE,
                   line_mask_normal_kernel)
from ..ops.fft import i2k_complex, k2i_complex
