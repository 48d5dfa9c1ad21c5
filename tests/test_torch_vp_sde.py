"""The port's VP and subVP SDEs, the DDPM schedule, the score functions,
the Euler-Maruyama and ancestral predictors, the annealed-Langevin
corrector and whole PC runs (sde/) against the JAX package's, with a
stand-in score and the JAX sampler's own noise injected.

Tolerances, as tests/test_torch_sde_sampling.py: the coefficients are a
few float32 operations (rtol 1e-6); a step or a whole chain compounds
rounding (rtol 1e-5). The discrete beta ladder is the port's linspace_f32
(jnp.linspace in float32) and its cumulative product torch's sequential
float32 cumprod; at N = 1000, 232 and 100 the betas lie within 1 ulp of
JAX's (measured 1 ulp at most) and alphas_cumprod within rel 1e-6
(measured 3.6e-7 at N = 1000, 4.8e-7 at 232: a product of up to 1000
float32 factors that XLA associates in another order).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from inverseproblemwithdiffusionmodel_tpu.sde import sampling as jsampling
from inverseproblemwithdiffusionmodel_tpu.sde import sde_lib as jsde_lib
from inverseproblemwithdiffusionmodel_tpu_torch.configs_continuous import (
    get_continuous_config, make_sde)
from inverseproblemwithdiffusionmodel_tpu_torch.sde import (
    AncestralSamplingPredictor, AnnealedLangevinDynamics,
    EulerMaruyamaPredictor, LangevinCorrector, VESDE, VPSDE,
    get_ddpm_params, get_pc_sampler, get_score_fn, subVPSDE,
    vanilla_pc_sampler)
from test_torch_sde_sampling import jax_pc_noise

torch.set_num_threads(1)

SHAPE = (2, 4, 4, 3)
MU = np.linspace(-1.0, 1.0, int(np.prod(SHAPE[1:]))).reshape(SHAPE[1:])
KINDS = ["vp", "subvp", "ve"]


def pair(kind, N=1000):
    """(JAX SDE, port SDE) of one kind."""
    if kind == "ve":
        return (jsde_lib.VESDE(N=N, sigma_min=0.01, sigma_max=50.0),
                VESDE(N=N, sigma_min=0.01, sigma_max=50.0))
    jcls, cls = ((jsde_lib.VPSDE, VPSDE) if kind == "vp"
                 else (jsde_lib.subVPSDE, subVPSDE))
    return (jcls(N=N, beta_min=0.1, beta_max=20.0),
            cls(N=N, beta_min=0.1, beta_max=20.0))


def _t(x):
    return torch.tensor(np.asarray(x, dtype=np.float32))


def _np(x):
    return np.asarray(x, dtype=np.float32)


def stand_in_net(xp):
    """A smooth raw 'network' (x, cond) -> output in either package: the
    score functions turn its output into a score."""
    mu = (torch.tensor(MU, dtype=torch.float32) if xp is torch
          else jnp.asarray(MU, jnp.float32))

    def net(x, cond):
        c = cond.reshape(-1, 1, 1, 1)
        return xp.tanh(x - mu) * (1.0 + 0.001 * c) + 0.1 * x
    return net


def jax_score(jsde):
    return jsampling.get_score_fn(jsde, stand_in_net(jnp))


def port_score(sde):
    net = stand_in_net(torch)
    return get_score_fn(sde, lambda x, c: net(x, c.float()))


def test_ddpm_params_match_jax():
    for args in [(), (0.1, 20.0, 1000), (0.05, 10.0, 500)]:
        ref, out = jsde_lib.get_ddpm_params(*args), get_ddpm_params(*args)
        assert set(out) == set(ref)
        for key, value in ref.items():
            if isinstance(value, (int, float)):
                assert out[key] == value, key
            else:
                assert out[key].dtype == torch.float32
                np.testing.assert_array_equal(out[key].numpy(),
                                              np.asarray(value), key)


@pytest.mark.parametrize("kind", ["vp", "subvp"])
@pytest.mark.parametrize("N", [1000, 232, 100])
def test_discrete_beta_ladder_matches_jax(kind, N):
    jsde, sde = pair(kind, N)
    np.testing.assert_allclose(sde.discrete_betas().numpy(),
                               np.asarray(jsde.discrete_betas), rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(sde.alphas().numpy(),
                               np.asarray(jsde.alphas), rtol=1e-6)
    ulps = np.abs(sde.discrete_betas().numpy() - np.asarray(
        jsde.discrete_betas)) / np.spacing(np.asarray(jsde.discrete_betas))
    assert ulps.max() <= 1
    np.testing.assert_allclose(sde.alphas_cumprod().numpy(),
                               np.asarray(jsde.alphas_cumprod), rtol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_sde_coefficients_match_jax(kind):
    jsde, sde = pair(kind)
    x = np.random.RandomState(0).randn(*SHAPE).astype(np.float32)
    t = np.array([0.999, 0.4321], np.float32)
    for name in ("sde", "marginal_prob"):
        ref = getattr(jsde, name)(jnp.asarray(x), jnp.asarray(t))
        out = getattr(sde, name)(_t(x), _t(t))
        for r, o in zip(ref, out):
            np.testing.assert_allclose(o.numpy(), _np(r), rtol=1e-6,
                                       atol=1e-7, err_msg=name)
    # discretize: VE's G = sqrt(sigma_i^2 - sigma_{i-1}^2) cancels, which
    # grows the ladder's float32 rounding about 50-fold (as in
    # tests/test_torch_sde_sampling.py, rtol 1e-4); VP's and subVP's
    # (the base Euler-Maruyama form) are a few operations
    ref = jsde.discretize(jnp.asarray(x), jnp.asarray(t))
    out = sde.discretize(_t(x), _t(t))
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), _np(r),
                                   rtol=1e-4 if kind == "ve" else 1e-6,
                                   atol=1e-6)
    z = np.random.RandomState(1).randn(*SHAPE).astype(np.float32) * 3
    np.testing.assert_allclose(sde.prior_logp(_t(z)).numpy(),
                               _np(jsde.prior_logp(jnp.asarray(z))),
                               rtol=1e-6)
    key = jax.random.PRNGKey(2)
    draw = _t(jax.random.normal(key, SHAPE))
    np.testing.assert_allclose(
        sde.prior_sampling(lambda s: draw, SHAPE).numpy(),
        _np(jsde.prior_sampling(key, SHAPE)), rtol=1e-6)


def test_subvp_std_has_no_square_root():
    # score_sde's definition: 1 - exp(2 lmc), which the JAX package keeps
    _, sde = pair("subvp")
    t = torch.tensor([0.3])
    _, vp_std = pair("vp")[1].marginal_prob(torch.zeros(1, 1), t)
    _, std = sde.marginal_prob(torch.zeros(1, 1), t)
    torch.testing.assert_close(std, vp_std ** 2)


@pytest.mark.parametrize("kind,continuous", [
    ("vp", True), ("vp", False), ("subvp", True), ("subvp", False),
    ("ve", True), ("ve", False)])
def test_score_fn_matches_jax(kind, continuous):
    jsde, sde = pair(kind, N=100)
    x = np.random.RandomState(3).randn(*SHAPE).astype(np.float32)
    t = np.array([0.87, 0.2], np.float32)
    seen = []

    def net(v, c):
        seen.append(c)
        return stand_in_net(torch)(v, c.float())

    ref = jsampling.get_score_fn(jsde, stand_in_net(jnp), continuous)(
        jnp.asarray(x), jnp.asarray(t))
    out = get_score_fn(sde, net, continuous)(_t(x), _t(t))
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=1e-5, atol=1e-6)
    if kind != "ve":       # labels t * 999, or t * (N - 1) for discrete VP
        scale = 999 if continuous or kind == "subvp" else 99
        torch.testing.assert_close(seen[0], _t(t) * scale)


def _step_pair(kind, jcls, cls, **kw):
    jsde, sde = pair(kind, N=50)
    return (jcls(sde=jsde, score_fn=jax_score(jsde), **kw),
            cls(sde=sde, score_fn=port_score(sde), **kw))


@pytest.mark.parametrize("kind,name", [
    ("vp", "em"), ("subvp", "em"), ("ve", "em"), ("vp", "ancestral"),
    ("ve", "ancestral")])
def test_one_predictor_step_matches_jax(kind, name):
    classes = {"em": (jsampling.EulerMaruyamaPredictor,
                      EulerMaruyamaPredictor),
               "ancestral": (jsampling.AncestralSamplingPredictor,
                             AncestralSamplingPredictor)}[name]
    jpred, pred = _step_pair(kind, *classes)
    key = jax.random.PRNGKey(4)
    x = np.random.RandomState(1).randn(*SHAPE).astype(np.float32)
    t = np.array([0.5, 0.02], np.float32)
    ref = jpred.update_fn(key, jnp.asarray(x), jnp.asarray(t))
    z = _t(jax.random.normal(key, SHAPE))
    out = pred.update_fn(lambda s: z, _t(x), _t(t))
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), _np(r), rtol=1e-5, atol=1e-6)


def test_ancestral_refuses_subvp_as_jax_does():
    jpred, pred = _step_pair("subvp", jsampling.AncestralSamplingPredictor,
                             AncestralSamplingPredictor)
    x, t = np.zeros(SHAPE, np.float32), np.array([0.5, 0.5], np.float32)
    with pytest.raises(NotImplementedError):
        jpred.update_fn(jax.random.PRNGKey(0), jnp.asarray(x),
                        jnp.asarray(t))
    with pytest.raises(NotImplementedError):
        pred.update_fn(lambda s: torch.zeros(s), _t(x), _t(t))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", ["ald", "langevin"])
def test_one_corrector_step_matches_jax(kind, name):
    classes = {"ald": (jsampling.AnnealedLangevinDynamics,
                       AnnealedLangevinDynamics),
               "langevin": (jsampling.LangevinCorrector,
                            LangevinCorrector)}[name]
    jcorr, corr = _step_pair(kind, *classes, snr=0.16, n_steps=2)
    key = jax.random.PRNGKey(5)
    x = np.random.RandomState(2).randn(*SHAPE).astype(np.float32)
    t = np.array([0.5, 0.3], np.float32)
    ref = jcorr.update_fn(key, jnp.asarray(x), jnp.asarray(t))
    draws, k = [], key
    for _ in range(2):
        k, kn = jax.random.split(k)
        draws.append(_t(jax.random.normal(kn, SHAPE)))
    it = iter(draws)
    out = corr.update_fn(lambda s: next(it), _t(x), _t(t))
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), _np(r), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("leaf", [
    "vp/cifar10_ncsnpp_continuous", "subvp/cifar10_ncsnpp_continuous",
    "vp/ddpm/cifar10", "vp/cifar10_ddpmpp"])
def test_whole_pc_run_of_a_leaf_matches_jax_fed_its_noise(leaf):
    # each leaf's own SDE, predictor and corrector (Euler-Maruyama for
    # the continuous VP / subVP leaves, ancestral or reverse diffusion for
    # the discrete ones), its continuous flag, N cut to 6
    from inverseproblemwithdiffusionmodel_tpu.configs_continuous import (
        get_continuous_config as jax_get_config, make_sde as jax_make_sde)
    N, key = 6, jax.random.PRNGKey(6)
    over = {"model.num_scales": N, "sampling.corrector": "ald"}
    jcfg = jax_get_config(leaf).replace(**over)
    cfg = get_continuous_config(leaf).replace(**over)
    jsde, sde = jax_make_sde(jcfg), make_sde(cfg)
    s = jcfg.sampling
    kw = dict(predictor=s.predictor, corrector=s.corrector, snr=s.snr,
              n_steps=2)
    continuous = cfg.training.continuous
    jscore = jsampling.get_score_fn(jsde, stand_in_net(jnp), continuous)
    ref, ref_nfe = jsampling.get_pc_sampler(jsde, SHAPE, **kw)(jscore, key)
    draws = iter(jax_pc_noise(key, SHAPE, N, s.predictor, s.corrector,
                              n_steps=2))
    net = stand_in_net(torch)
    out, nfe = vanilla_pc_sampler(
        get_score_fn(sde, lambda x, c: net(x, c.float()), continuous), sde,
        SHAPE, noise=lambda shape: _t(next(draws)), device="cpu", **kw)
    assert nfe == int(ref_nfe) == 3 * N
    assert next(draws, None) is None
    np.testing.assert_allclose(out.numpy(), _np(ref), rtol=1e-5, atol=1e-6)


def test_pc_sampler_takes_every_new_predictor_and_corrector():
    _, sde = pair("vp", N=50)
    for predictor in ("euler_maruyama", "ancestral_sampling"):
        for corrector in ("ald", "langevin", "none"):
            out, nfe = get_pc_sampler(sde, SHAPE, predictor=predictor,
                                      corrector=corrector, device="cpu")(
                port_score(sde), seed=0)
            assert out.dtype == torch.float32 and out.shape == SHAPE
            assert torch.isfinite(out).all() and nfe == 50 * 2
