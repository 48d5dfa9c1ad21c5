"""The port's probability-flow ODE sampler against the JAX package's: the
Dormand-Prince integrator (sde/odeint.py) against
jax.experimental.ode.odeint on analytic systems, get_ode_sampler on the
Gaussian score of tests/test_sde.py and on a tiny NCSN++ (FIR resamplers)
from the same x_init, the `ode` branch of get_sampling_fn, and
pc_sampling.main with --method ode and with an NCSN v1 leaf on the CPU.

JAX's evaluations are counted by a jax.debug.callback inside the test's
own function. The integrator and the samplers hold JAX's evaluation count
exactly, so both take the same steps. The integrator's results hold at rel
L2 1e-6 (the norms' float32 sums run in another order), the VE samplers at
1e-5 on the Gaussian (read 6.9e-7) and 1e-4 on NCSN++ (read 3.1e-5, its
forwards about 1e-6 apart). The VP samplers hold at 1e-3: near t = eps =
1e-3 the VP std, sqrt(1 - exp(2 lmc)), loses three digits to cancellation,
so one ulp of exp (XLA's against torch's) moves the score there by about
1e-3, and the drift there grows as 1 / std: a solve at the sampler's rtol
1e-5 moves by 1e-3 or more when its own score is perturbed by 1e-7 of
itself (the smoke's control, PERF.md). Read 1.3e-4 (Gaussian) and 1.8e-4
(NCSN++).
"""
import contextlib
import io

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.ode import odeint as jax_odeint

from inverseproblemwithdiffusionmodel_tpu.configs_continuous import (
    get_continuous_config as jax_get_config, make_sde as jax_make_sde)
from inverseproblemwithdiffusionmodel_tpu.models.ncsnpp import (
    NCSNpp as JaxNCSNpp)
from inverseproblemwithdiffusionmodel_tpu.sde import (
    VESDE as JaxVESDE, VPSDE as JaxVPSDE,
    get_ode_sampler as jax_get_ode_sampler,
    get_score_fn as jax_get_score_fn)
from inverseproblemwithdiffusionmodel_tpu_torch.configs_continuous import (
    get_continuous_config, make_sde)
from inverseproblemwithdiffusionmodel_tpu_torch.models import create_model
from inverseproblemwithdiffusionmodel_tpu_torch.scripts import pc_sampling
from inverseproblemwithdiffusionmodel_tpu_torch.sde import (
    VESDE, VPSDE, get_ode_sampler, get_sampling_fn, get_score_fn)
from inverseproblemwithdiffusionmodel_tpu_torch.sde.odeint import odeint
from inverseproblemwithdiffusionmodel_tpu_torch.utils.convert import (
    flax_to_torch_ncsnpp)

from test_torch_ncsnpp import TINY, perturb

torch.set_num_threads(1)

MU, S = 1.5, 0.5          # p_0 = N(MU, S^2), as tests/test_sde.py


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def counted(fn):
    """fn with a host-side counter of its evaluations inside JAX's solve."""
    count = [0]

    def bump():
        count[0] += 1

    def wrapped(*args):
        jax.debug.callback(bump)
        return fn(*args)

    return wrapped, count


# -- the integrator -----------------------------------------------------------

SYSTEMS = {
    # dy/dt = -0.7 y
    "decay": (lambda y, t: -0.7 * y, lambda y, t: -0.7 * y,
              [1.0, 0.5, -2.0], [0.0, 2.0]),
    # a rotation, observed at two times
    "rotation": (lambda y, t: jnp.stack([-y[1], y[0]]),
                 lambda y, t: torch.stack([-y[1], y[0]]),
                 [1.0, 0.0], [0.0, 3.0, 6.0]),
    # one fast mode (rate 200) beside a slow one: explicit steps are held
    # back by stability, and some are rejected
    "stiff": (lambda y, t: jnp.stack([-200.0 * y[0], -y[1]]),
              lambda y, t: torch.stack([-200.0 * y[0], -y[1]]),
              [1.0, 1.0], [0.0, 2.0]),
}


@pytest.mark.parametrize("tol", [1e-5, 1e-3])
@pytest.mark.parametrize("system", SYSTEMS)
def test_integrator_matches_jax_odeint(system, tol):
    fj, ft, y0, ts = SYSTEMS[system]
    y0 = np.asarray(y0, np.float32)
    f, count = counted(fj)
    ref = np.asarray(jax_odeint(f, jnp.asarray(y0),
                                jnp.asarray(ts, jnp.float32), rtol=tol,
                                atol=tol))
    stats = {}
    out = odeint(ft, torch.from_numpy(y0), torch.tensor(ts), rtol=tol,
                 atol=tol, stats=stats).numpy()
    assert out.shape == ref.shape == (len(ts),) + y0.shape
    assert stats["nfe"] == count[0] == 2 + 6 * stats["steps"]
    assert stats["accepted"] + stats["rejected"] == stats["steps"]
    if system == "stiff":
        assert stats["rejected"] > 0
    assert rel_l2(out, ref) <= 1e-6


def test_integrator_shares_one_step_over_the_batch():
    """The error norm covers the whole state: a batch of one slow and one
    fast system takes the fast one's steps for both, as JAX does."""
    y0 = torch.tensor([[1.0], [1.0]])
    rates = torch.tensor([[1.0], [50.0]])
    ts = torch.tensor([0.0, 1.0])
    both, alone = {}, {}
    odeint(lambda y, t: -rates * y, y0, ts, 1e-5, 1e-5, stats=both)
    odeint(lambda y, t: -y, y0[:1], ts, 1e-5, 1e-5, stats=alone)
    assert both["steps"] > alone["steps"]


# -- the sampler --------------------------------------------------------------

def gaussian_score_jax(sde):
    def score(x, t):
        a, std = sde.marginal_prob(jnp.ones_like(x), t)
        var = (a * S) ** 2 + std.reshape(-1, *([1] * (x.ndim - 1))) ** 2
        return (a * MU - x) / var
    return score


def gaussian_score_torch(sde):
    def score(x, t):
        a, std = sde.marginal_prob(torch.ones_like(x), t)
        var = (a * S) ** 2 + std.reshape(-1, *([1] * (x.ndim - 1))) ** 2
        return (a * MU - x) / var
    return score


@pytest.mark.parametrize("denoise", [False, True])
@pytest.mark.parametrize("kind", ["vp", "ve"])
def test_ode_sampler_on_a_gaussian_matches_jax(kind, denoise):
    shape = (16, 4, 4, 1)
    if kind == "vp":
        jsde, sde = JaxVPSDE(N=100), VPSDE(N=100)
    else:
        jsde, sde = JaxVESDE(N=50, sigma_max=5.0), VESDE(N=50, sigma_max=5.0)
    x_init = np.asarray(jsde.prior_sampling(jax.random.PRNGKey(1), shape))
    score, count = counted(gaussian_score_jax(jsde))
    ref, ref_n = jax_get_ode_sampler(jsde, shape, denoise=denoise)(
        score, jax.random.PRNGKey(2), x_init=jnp.asarray(x_init))
    stats = {}
    out, n = get_ode_sampler(sde, shape, denoise=denoise, device="cpu")(
        gaussian_score_torch(sde), x_init=torch.from_numpy(x_init),
        stats=stats)
    assert n == int(ref_n) == sde.N            # sde.N, not the evaluations
    assert stats["nfe"] + denoise == count[0]
    assert rel_l2(out.numpy(), ref) <= (1e-3 if kind == "vp" else 1e-5)
    # probability flow carries the prior to p_0 = N(MU, S^2)
    assert abs(float(out.mean()) - MU) < 0.3


LEAVES = {"vp/cifar10_ncsnpp_continuous": False,
          "ve/cifar10_ncsnpp_continuous": True}


@pytest.mark.parametrize("leaf", LEAVES)
def test_ode_sampler_on_a_tiny_ncsnpp_matches_jax(leaf):
    """nf 16, FIR resamplers, 8 px, 2 samples from the same x_init, at the
    sampler's rtol = atol = 1e-5; the VP leaf with denoise off, the VE
    leaf with it on."""
    denoise = LEAVES[leaf]
    small = dict(TINY, **{"data.image_size": 8, "model.ch_mult": (1, 2)})
    jcfg = jax_get_config(leaf).replace(**small)
    cfg = get_continuous_config(leaf).replace(**small)
    assert cfg.model.fir
    jmod = JaxNCSNpp(config=jcfg)
    x0, c0 = jnp.zeros((1, 8, 8, 3)), jnp.ones((1,))
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x0, c0)
    rs = np.random.RandomState(0)
    fourier = {"W": rs.randn(jcfg.model.nf).astype(np.float32)
               * jcfg.model.fourier_scale}
    params = perturb(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes["params"]), rs)
    if "fourier_proj" in params:
        params["fourier_proj"] = fourier
    jsde, sde = jax_make_sde(jcfg), make_sde(cfg)
    shape = (2, 8, 8, 3)
    x_init = np.asarray(jsde.prior_sampling(jax.random.PRNGKey(3), shape))

    model_fn, count = counted(
        lambda x, c: jmod.apply({"params": params}, x, c))
    sample = jax.jit(lambda x: jax_get_ode_sampler(
        jsde, shape, denoise=denoise)(jax_get_score_fn(jsde, model_fn),
                                      jax.random.PRNGKey(4), x_init=x))
    ref, ref_n = sample(jnp.asarray(x_init))
    ref = np.asarray(ref)

    model = create_model(cfg).eval()
    model.load_state_dict(flax_to_torch_ncsnpp(params, cfg), strict=True)
    stats = {}
    with torch.no_grad():
        out, n = get_ode_sampler(sde, shape, denoise=denoise, device="cpu")(
            get_score_fn(sde, model), x_init=torch.from_numpy(x_init),
            stats=stats)
    assert n == int(ref_n) == cfg.model.num_scales
    assert stats["nfe"] + denoise == count[0]
    assert rel_l2(out.numpy(), ref) <= (1e-3 if leaf.startswith("vp")
                                        else 1e-4)


# -- dispatch and the entry point ---------------------------------------------

def test_get_sampling_fn_dispatches_the_ode_sampler(monkeypatch):
    cfg = get_continuous_config("vp/cifar10_ncsnpp_continuous").replace(
        **{"sampling.method": "ode", "sampling.noise_removal": False})
    sde = VPSDE(N=10)
    calls = []
    from inverseproblemwithdiffusionmodel_tpu_torch.sde import sampling
    real = sampling.odeint

    def spy(*args, **kw):
        calls.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(sampling, "odeint", spy)
    fn = get_sampling_fn(cfg, sde, (4, 2, 2, 1), eps=1e-3, device="cpu")
    x, n = fn(gaussian_score_torch(sde), seed=0)
    assert n == 10 and x.shape == (4, 2, 2, 1) and torch.isfinite(x).all()
    assert calls and calls[0]["rtol"] == calls[0]["atol"] == 1e-5


def _main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        samples = pc_sampling.main(argv)
    return samples, out.getvalue()


def test_pc_sampling_main_runs_the_ode_and_ncsn_v1_on_the_cpu(tmp_path):
    tiny = ["--override", "data.image_size=16", "--override", "model.nf=16",
            "--override", "model.ch_mult=(1, 2)", "--override",
            "model.num_res_blocks=1", "--override",
            "model.attn_resolutions=(8,)", "--override",
            "model.num_scales=40"]
    samples, text = _main(["--config", "vp/cifar10_ncsnpp_continuous",
                           "--method", "ode", "--num_samples", "2",
                           "--device", "cpu", "--save_dir", str(tmp_path)]
                          + tiny)
    assert samples.shape == (2, 16, 16, 3) and np.isfinite(samples).all()
    assert "(nfe=40)" in text
    samples, text = _main([
        "--config", "ve/ncsn/cifar10", "--num_samples", "2", "--device",
        "cpu", "--save_dir", str(tmp_path), "--override",
        "data.image_size=16", "--override", "model.ngf=8", "--override",
        "sampling.n_steps_each=2"])
    assert samples.shape == (2, 16, 16, 3) and np.isfinite(samples).all()
    assert "(nfe=30)" in text            # 10 scales x (2 corrector + 1)
