"""The port's VE SDE and PC sampler (sde/) against the JAX package's, with
an analytic score and the JAX sampler's own noise injected.

Tolerances: the SDE coefficients are a few float32 operations (rtol 1e-6);
a whole chain compounds rounding through N steps (rtol 1e-5 against values
of order sigma_max). The time grid and its integer ladder indices are held
equal exactly.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from inverseproblemwithdiffusionmodel_tpu.sde import (
    LangevinCorrector as JaxLangevin, ReverseDiffusionPredictor as JaxRD,
    VESDE as JaxVESDE, get_pc_sampler as jax_get_pc_sampler)
from inverseproblemwithdiffusionmodel_tpu_torch.configs_continuous import (
    get_continuous_config, make_sde)
from inverseproblemwithdiffusionmodel_tpu_torch.sde import (
    LangevinCorrector, ReverseDiffusionPredictor, VESDE, get_pc_sampler,
    get_sampling_fn)
from inverseproblemwithdiffusionmodel_tpu_torch.sde.sde_lib import (
    linspace_f32)

torch.set_num_threads(1)

SIGMA_MIN, SIGMA_MAX = 0.01, 348.0
SHAPE = (2, 4, 4, 3)
MU = np.linspace(-1.0, 1.0, int(np.prod(SHAPE[1:]))).reshape(SHAPE[1:])


def jax_score(sde):
    """Score of N(MU, sigma(t)^2 + 1) per pixel: a stand-in network."""
    def score(x, t):
        _, std = sde.marginal_prob(x, t)
        return -(x - MU) / (std[:, None, None, None] ** 2 + 1.0)
    return score


def port_score(sde):
    mu = torch.tensor(MU, dtype=torch.float32)

    def score(x, t):
        _, std = sde.marginal_prob(x, t)
        return -(x - mu) / (std[:, None, None, None] ** 2 + 1.0)
    return score


def _t(x):
    return torch.tensor(np.asarray(x, dtype=np.float32))


def _pair(N=2000):
    return (JaxVESDE(N=N, sigma_min=SIGMA_MIN, sigma_max=SIGMA_MAX),
            VESDE(N=N, sigma_min=SIGMA_MIN, sigma_max=SIGMA_MAX))


@pytest.mark.parametrize("N,eps", [(2000, 1e-3), (1000, 1e-3), (100, 1e-3),
                                   (2000, 1e-5)])
def test_time_grid_and_ladder_indices_equal_jax(N, eps):
    jsde, sde = _pair(N)
    port_t = linspace_f32(1.0, eps, N)
    port_idx = (port_t * (N - 1) / sde.T).to(torch.int64).numpy()
    for ref_t in (jnp.linspace(1.0, eps, N),
                  jax.jit(lambda: jnp.linspace(1.0, eps, N))()):
        # XLA forms 1 - i / (N - 1) in float32 first: its small t carry an
        # absolute error of up to one ulp of 1.0.
        np.testing.assert_allclose(port_t.numpy(), np.asarray(ref_t),
                                   rtol=0, atol=np.finfo(np.float32).eps)
        ref_idx = np.asarray((ref_t * (N - 1) / jsde.T).astype(jnp.int32))
        np.testing.assert_array_equal(port_idx, ref_idx)
    np.testing.assert_allclose(sde.discrete_sigmas().numpy(),
                               np.asarray(jsde.discrete_sigmas), rtol=1e-5)


def test_vesde_coefficients_match_jax():
    jsde, sde = _pair()
    rs = np.random.RandomState(0)
    x = rs.randn(*SHAPE).astype(np.float32)
    t = np.array([1.0, 0.4321], np.float32)
    # discretize's G = sqrt(sigma_i^2 - sigma_{i-1}^2) cancels: adjacent
    # sigmas differ by 1% at N = 2000, so the ladder's float32 rounding
    # (one ulp of log sigma, 5e-7 of sigma) grows about 50-fold.
    for jf, pf, rtol in [(jsde.sde, sde.sde, 1e-6),
                         (jsde.marginal_prob, sde.marginal_prob, 1e-6),
                         (jsde.discretize, sde.discretize, 1e-4)]:
        for ref, out in zip(jf(jnp.asarray(x), jnp.asarray(t)),
                            pf(_t(x), _t(t))):
            np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                       rtol=rtol, atol=1e-6)


def test_prior_sampling_scales_the_injected_draws_like_jax():
    jsde, sde = _pair()
    key = jax.random.PRNGKey(3)
    z = np.asarray(jax.random.normal(key, SHAPE))
    out = sde.prior_sampling(lambda s: _t(z), SHAPE)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jsde.prior_sampling(key, SHAPE)),
                               rtol=1e-6)


def test_one_predictor_step_matches_jax():
    jsde, sde = _pair()
    key = jax.random.PRNGKey(4)
    x = np.random.RandomState(1).randn(*SHAPE).astype(np.float32) * 30
    t = np.array([0.5, 0.5], np.float32)
    ref = JaxRD(sde=jsde, score_fn=jax_score(jsde)).update_fn(
        key, jnp.asarray(x), jnp.asarray(t))
    z = _t(jax.random.normal(key, SHAPE))
    out = ReverseDiffusionPredictor(sde=sde, score_fn=port_score(sde)) \
        .update_fn(lambda s: z, _t(x), _t(t))
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


def test_one_corrector_step_matches_jax():
    jsde, sde = _pair()
    key = jax.random.PRNGKey(5)
    x = np.random.RandomState(2).randn(*SHAPE).astype(np.float32) * 30
    t = np.array([0.5, 0.5], np.float32)
    ref = JaxLangevin(sde=jsde, score_fn=jax_score(jsde), snr=0.075,
                      n_steps=2).update_fn(key, jnp.asarray(x),
                                           jnp.asarray(t))
    draws = []
    k = key
    for _ in range(2):
        k, kn = jax.random.split(k)
        draws.append(_t(jax.random.normal(kn, SHAPE)))
    it = iter(draws)
    out = LangevinCorrector(sde=sde, score_fn=port_score(sde), snr=0.075,
                            n_steps=2).update_fn(lambda s: next(it), _t(x),
                                                 _t(t))
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("predictor,corrector", [
    ("reverse_diffusion", "langevin"), ("reverse_diffusion", "none"),
    ("none", "langevin")])
def test_whole_pc_run_matches_jax_fed_its_noise(predictor, corrector):
    N, key = 5, jax.random.PRNGKey(6)
    jsde, sde = _pair(N)
    ref, ref_nfe = jax_get_pc_sampler(
        jsde, SHAPE, predictor=predictor, corrector=corrector,
        snr=0.075)(jax_score(jsde), key)

    draws = iter(jax_pc_noise(key, SHAPE, N, predictor, corrector))
    out, nfe = get_pc_sampler(sde, SHAPE, predictor=predictor,
                              corrector=corrector, snr=0.075,
                              device="cpu")(
        port_score(sde), noise=lambda s: _t(next(draws)))
    assert nfe == int(ref_nfe)
    assert next(draws, None) is None   # every JAX draw was used, in order
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5,
                               atol=1e-6 * SIGMA_MAX)


def jax_pc_noise(key, shape, N, predictor, corrector, n_steps=1):
    """The draws the JAX PC sampler makes, in order
    (sde/sampling.py:283-290, Langevin split :210)."""
    key, k_init = jax.random.split(key)
    draws = [jax.random.normal(k_init, shape)]
    for _ in range(N):
        key, k_c, k_p = jax.random.split(key, 3)
        if corrector != "none":
            for _ in range(n_steps):
                k_c, kn = jax.random.split(k_c)
                draws.append(jax.random.normal(kn, shape))
        if predictor != "none":
            draws.append(jax.random.normal(k_p, shape))
    return draws


def test_default_noise_is_seeded():
    _, sde = _pair(3)
    sampler = get_pc_sampler(sde, SHAPE, device="cpu")
    a, _ = sampler(port_score(sde), seed=1)
    b, _ = sampler(port_score(sde), seed=1)
    c, _ = sampler(port_score(sde), seed=2)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_unported_sdes_and_methods_raise():
    # unknown predictor / corrector names raise; the ODE sampler dispatches
    # (held to JAX in test_torch_ode.py); the VP and subVP SDEs and the
    # Euler-Maruyama predictor build (held to JAX in test_torch_vp_sde.py)
    cfg = get_continuous_config("ve/ffhq_256_ncsnpp_continuous")
    ode = get_sampling_fn(cfg.replace(**{"sampling.method": "ode"}),
                          make_sde(cfg), SHAPE, device="cpu")
    assert ode.__qualname__.startswith("get_ode_sampler")
    for kw in ({"predictor": "leapfrog"}, {"corrector": "hmc"}):
        with pytest.raises(KeyError, match="unknown"):
            get_pc_sampler(make_sde(cfg), SHAPE, device="cpu", **kw)
    vp = get_continuous_config("vp/cifar10_ddpmpp_continuous")
    assert type(make_sde(vp)).__name__ == "VPSDE"
    assert callable(get_pc_sampler(make_sde(cfg), SHAPE,
                                   predictor="euler_maruyama", device="cpu"))
