"""Continuous-time SDE stack: the VP, subVP and VE SDEs and the
predictor-corrector and probability-flow ODE samplers."""
from .sde_lib import SDE, ReverseSDE, VESDE, VPSDE, get_ddpm_params, subVPSDE
from .sampling import (AncestralSamplingPredictor, AnnealedLangevinDynamics,
                       EulerMaruyamaPredictor, get_corrector,
                       get_ode_sampler, get_pc_sampler,
                       get_predictor, get_sampling_fn, get_score_fn,
                       register_corrector, register_predictor,
                       LangevinCorrector, NoneCorrector, NonePredictor,
                       ReverseDiffusionPredictor, vanilla_pc_sampler)

__all__ = [
    "SDE", "ReverseSDE", "VPSDE", "subVPSDE", "VESDE",
    "get_ddpm_params",
    "register_predictor", "register_corrector", "get_predictor",
    "get_corrector", "get_score_fn", "get_pc_sampler", "get_ode_sampler",
    "get_sampling_fn", "vanilla_pc_sampler",
    "EulerMaruyamaPredictor", "ReverseDiffusionPredictor",
    "AncestralSamplingPredictor", "NonePredictor", "LangevinCorrector",
    "AnnealedLangevinDynamics", "NoneCorrector",
]
